// Max-decay recurrence (peak envelope follower) for Hopper (sm_90a):
//
//     y[t, c] = max(x[t, c], r[c] * y[t-1, c]),   y[-1, c] = y0[c]
//
// for x [T, C] (row-major, lanes fastest), r [C], y0 [C], y [T, C], all
// float32. It replaces the XLA associative scan of the reference's
// compressor follower: termdaw_tpu/ops/fx.py `max_decay_scan` /
// `max_decay_scan_sharded` (fx.py:57-89), which runs the (decay, value)
// monoid (a1*a2, max(b2, a2*b1)) with identity (1, -3.0e38) through
// filters.tiled_cumulative. It is not a Pallas kernel there; PyTorch has
// no primitive for it.
//
// What bounds it on this card: bytes. Each frame and lane is read once
// and written once (8 bytes) for a multiply and a max. At the c4
// compressor shape (T = 375 * 1024 frames, C = 1) that is 3.1 MB, 0.9 us
// of the card's 3.35 TB/s. The first kernel (one CTA per lane, 512
// threads each walking ~750 frames twice, loads 3 KB apart across a warp)
// ran 0.505 ms there: one SM of 132, every step a dependent multiply-max
// waiting on an uncoalesced load.
//
// Design: the tiled scan of csrc/scan_tile.cuh, as affine_scan.cu. At
// the compressor shape a tile is 1792 frames of the one lane (a
// contiguous 7 KB block, float4 loads), 215 CTAs in each of the two
// kernels; each thread folds a run of 7 frames from shared memory; tiles
// are combined reduce-then-scan, the carry across tiles in float64.
//
// A map {a, b} is y -> max(b, a*y); a frame is {r, x[t]}. Composition,
// e then l: {l.a*e.a, max(l.b, l.a*e.b)}, identity {1, -3.0e38}.
//
// Precision. Every run of a tile multiplies the same r the same number of
// times, so an f32 decay product r^K carries the same rounding error into
// every run, and the prefix of run j carries j times it: up to 255 x ~1e-7
// of the carried value inside a 1792-frame tile, above the 1e-5 of max |y|
// the card tests hold at r = 0.99992 (a 250 ms release at 48 kHz). So
// Map.a is a double inside the tile too, and across tiles the header's
// float64 carry builds A = r^S by repeated squaring; the values b, the
// fold and the replay stay f32, as in the reference.
//
// NaN: jnp.maximum and torch.maximum propagate NaN, CUDA's fmaxf does
// not, so the maxes here are their own. The identity is the reference's
// -3.0e38, not -inf (0 * -inf would be NaN).

#include "scan_tile.cuh"

namespace {

using scan_tile::Args;
using scan_tile::kFull;

constexpr float kIdentity = -3.0e38f;

// max(a, b) that returns NaN when either is NaN, as torch.maximum does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a > b || a != a) ? a : b;
}

struct MaxDecayScanOp {
  static constexpr int kPlanes = 1;
  struct Map { double a; float b; };  // y -> max(b, a*y)
  struct Param { float r; };
  struct State { float y; };
  struct DMap { double a, b; };
  struct DState { double y; };

  static __device__ Map identity() { return {1.0, kIdentity}; }
  // e, then l
  static __device__ Map compose(Map e, Map l) {
    return {l.a * e.a, nan_max(l.b, (float)(l.a * (double)e.b))};
  }
  static __device__ Map shfl_up(Map m, int d) {
    return {__shfl_up_sync(kFull, m.a, d), __shfl_up_sync(kFull, m.b, d)};
  }
  static __device__ Param param(const Args& g, int c) {
    return {__ldg(g.p[0] + c)};
  }
  // m, then the frame's map (r, x[t])
  static __device__ Map step(Map m, Param p, const float* in) {
    return {(double)p.r * m.a, nan_max(in[0], p.r * m.b)};
  }
  static __device__ State init(const Args& g, int c) { return {g.s[0][c]}; }
  static __device__ State apply(Map m, State s) {
    return {nan_max(m.b, (float)(m.a * (double)s.y))};
  }
  static __device__ State advance(State s, Param p, const float* in) {
    return {nan_max(in[0], p.r * s.y)};
  }
  static __device__ void put(State s, float* sm, int, int i) { sm[i] = s.y; }
  static __device__ void put_agg(Map m, float* agg, long long, long long i) {
    agg[i] = m.b;
  }

  // float64, across tiles
  static __device__ DMap didentity() { return {1.0, (double)kIdentity}; }
  // the pole r; carry_in takes only .a of its powers
  static __device__ DMap dbase(Param p) {
    return {(double)p.r, (double)kIdentity};
  }
  static __device__ DMap dcompose(DMap e, DMap l) {
    return {l.a * e.a, nan_max(l.b, l.a * e.b)};
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
    return {nan_max(m.b, m.a * s.y)};
  }
  static __device__ State narrow(DState s) { return {(float)s.y}; }
};

}  // namespace

// x [T, C], r [C], y0 [C], y [T, C]: contiguous float32 device memory;
// cl, k: the tiling (kernels.scan_plan); scratch: tiles * C floats when
// the plan has more than one tile along the timeline, else unused.
// Launches on `stream` and returns the first CUDA error (0 on success);
// does not synchronise.
extern "C" int max_decay_scan_launch(const float* x, const float* r,
                                     const float* y0, float* y,
                                     float* scratch, long long T, int C,
                                     int cl, int k, void* stream) {
  const Args args{{x, nullptr}, {r, nullptr}, {y0, nullptr}, {y, nullptr}};
  return scan_tile::launch<MaxDecayScanOp>(args, T, C, cl, k, scratch,
                                           stream);
}
