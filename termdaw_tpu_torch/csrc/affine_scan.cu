// First-order affine recurrence for Hopper (sm_90a):
//
//     y[t, c] = a[c] * y[t-1, c] + b[t, c],   y[-1, c] = y0[c]
//
// for b [T, C] (row-major, lanes fastest), a [C], y0 [C], y [T, C], all
// float32. It replaces the XLA associative scan of the reference's
// one-pole filters: termdaw_tpu/ops/filters.py `affine_cumulative` /
// `tiled_cumulative` (filters.py:72-121), as `band_pass_timeline` runs it
// on four lanes (low/high x L/R, filters.py:251) and as the effects'
// followers run it through `first_order_scan_sharded` (filters.py:158-175),
// and the feedback lines of termdaw_tpu/ops/fx.py `feedback_line`
// (fx.py:96-126) on their [rows, D*C] layout. It is not a Pallas kernel
// there; PyTorch has no primitive for it.
//
// What bounds it on this card: bytes. Each frame and lane is read once
// and written once (8 bytes) for one FMA. At the band-pass shape (T =
// 375 * 1024 frames, C = 4) that is 12.3 MB, 3.7 us of the card's 3.35
// TB/s; the reverb's damping (C = 2) 6.1 MB, the compressor's smoothing
// (C = 1) 3.1 MB; the longest comb [216, 1785] 3.1 MB, the delay [67,
// 11,520] 6.2 MB. The first kernel (one CTA per lane, 512 threads each
// walking ~750 frames twice with loads 12 KB apart) ran 0.64 ms at the
// band-pass shape: 4 SMs busy, every step a dependent FMA waiting on an
// uncoalesced load.
//
// Design: the tiled scan of csrc/scan_tile.cuh. At the band-pass shape a
// tile is 1984 frames x 4 lanes (one contiguous 31 KB block, copied with
// float4 loads), 194 CTAs over the 132 SMs; each thread folds 31 frames
// of one lane from shared memory; tiles are combined reduce-then-scan
// (two kernels; the carry across tiles in float64), the second read from
// L2. The feedback lines put 32 consecutive lanes on consecutive threads:
// the delay's 67 rows are one tile (one kernel, 360 CTAs), the combs and
// allpasses tiles of 56 rows (4 to 28 of them, 2 kernels).
//
// Composition: (A1, B1) then (A2, B2) is (A2*A1, A2*B1 + B2), the order
// of filters.affine_cumulative.

#include "scan_tile.cuh"

namespace {

using scan_tile::Args;
using scan_tile::kFull;

struct AffineScanOp {
  static constexpr int kPlanes = 1;
  struct Map { float a, b; };      // y -> a*y + b
  struct Param { float a; };
  struct State { float y; };
  struct DMap { double a, b; };
  struct DState { double y; };

  static __device__ Map identity() { return {1.0f, 0.0f}; }
  // e, then l
  static __device__ Map compose(Map e, Map l) {
    return {l.a * e.a, l.a * e.b + l.b};
  }
  static __device__ Map shfl_up(Map m, int d) {
    return {__shfl_up_sync(kFull, m.a, d), __shfl_up_sync(kFull, m.b, d)};
  }
  static __device__ Param param(const Args& g, int c) {
    return {__ldg(g.p[0] + c)};
  }
  // m, then the frame's map (a, b[t])
  static __device__ Map step(Map m, Param p, const float* in) {
    return {p.a * m.a, p.a * m.b + in[0]};
  }
  static __device__ State init(const Args& g, int c) { return {g.s[0][c]}; }
  static __device__ State apply(Map m, State s) { return {m.a * s.y + m.b}; }
  static __device__ State advance(State s, Param p, const float* in) {
    return {p.a * s.y + in[0]};
  }
  static __device__ void put(State s, float* sm, int, int i) { sm[i] = s.y; }
  static __device__ void put_agg(Map m, float* agg, long long, long long i) {
    agg[i] = m.b;
  }

  // float64, across tiles
  static __device__ DMap didentity() { return {1.0, 0.0}; }
  static __device__ DMap dbase(Param p) { return {(double)p.a, 0.0}; }
  static __device__ DMap dcompose(DMap e, DMap l) {
    return {l.a * e.a, l.a * e.b + l.b};
  }
  static __device__ DMap dshfl_up(DMap m, int d) {
    return {__shfl_up_sync(kFull, m.a, d), __shfl_up_sync(kFull, m.b, d)};
  }
  static __device__ DMap dtile(DMap An, const float* agg, long long,
                               long long i) {
    return {An.a, (double)agg[i]};
  }
  static __device__ DState dinit(const Args& g, int c) {
    return {(double)g.s[0][c]};
  }
  static __device__ DState dapply(DMap m, DState s) {
    return {m.a * s.y + m.b};
  }
  static __device__ State narrow(DState s) { return {(float)s.y}; }
};

}  // namespace

// b [T, C], a [C], y0 [C], y [T, C]: contiguous float32 device memory;
// cl, k: the tiling (kernels.scan_plan); scratch: tiles * C floats
// when the plan has more than one tile along the timeline, else unused.
// Launches on `stream` and returns the first CUDA error (0 on success);
// does not synchronise.
extern "C" int affine_scan_launch(const float* b, const float* a,
                                  const float* y0, float* y, float* scratch,
                                  long long T, int C, int cl, int k,
                                  void* stream) {
  const Args args{{b, nullptr}, {a, nullptr}, {y0, nullptr}, {y, nullptr}};
  return scan_tile::launch<AffineScanOp>(args, T, C, cl, k, scratch, stream);
}
