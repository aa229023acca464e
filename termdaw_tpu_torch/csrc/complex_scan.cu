// Complex first-order recurrence (one biquad pole) for Hopper (sm_90a):
//
//     u[t, c] = p[c] * u[t-1, c] + f[t, c],   u[-1, c] = s[c]
//
// in complex arithmetic, every complex value held as two float32 lanes
// (re, im): f_r, f_i [T, C] (row-major, lanes fastest), p_r, p_i, s_r,
// s_i [C], outputs u_r, u_i [T, C]. It replaces the XLA associative scan
// of the reference's biquads: termdaw_tpu/ops/filters.py
// `_first_order_complex` (filters.py:316-354), which composes complex
// affine maps u -> A*u + B with `_caffine_combine` (filters.py:295-313)
// through filters.tiled_cumulative; `biquad_apply` runs two of them per
// section (u through pole p1, then y through pole p2). It is not a Pallas
// kernel there; PyTorch has no primitive for it.
//
// What bounds it on this card: bytes. Each frame and lane reads f_r, f_i
// and writes u_r, u_i (16 bytes) for 8 flops. At the c4 eq3 stage (T =
// 375 * 1024 frames, C = 4) that is 24.6 MB, 7.3 us of the card's 3.35
// TB/s; c4 runs 40 such scans a render. The first kernel (one CTA per
// lane, 512 threads each walking ~750 frames twice, loads 12 KB apart
// across a warp) ran 1.32 ms there: 4 of 132 SMs, a chain of dependent
// complex multiply-adds waiting on uncoalesced loads.
//
// Design: the tiled scan of csrc/scan_tile.cuh with two planes in and
// two out. At the eq3 shape a tile is 1472 frames x 4 lanes (two
// contiguous 23 KB blocks, float4 loads), 261 CTAs; each thread folds 23
// frames of one lane from shared memory; tiles are combined
// reduce-then-scan (two kernels; the carry across tiles, A = p^1472 and
// the state, in float64), the second read from L2.
//
// Every composition is _caffine_combine's (earlier, later) product, the
// later map times the earlier one:
//   A = A2*A1, B = A2*B1 + B2,
// with (ar2*ar1 - ai2*ai1, ar2*ai1 + ai2*ar1) as the complex product, in
// the fold, the scans over runs, warps and tiles, and the replay.

#include "scan_tile.cuh"

namespace {

using scan_tile::Args;
using scan_tile::kFull;

struct ComplexScanOp {
  static constexpr int kPlanes = 2;
  struct Map { float ar, ai, br, bi; };  // u -> A*u + B
  struct Param { float pr, pi; };
  struct State { float ur, ui; };
  struct DMap { double ar, ai, br, bi; };
  struct DState { double ur, ui; };

  static __device__ Map identity() { return {1.0f, 0.0f, 0.0f, 0.0f}; }
  // e, then l
  static __device__ Map compose(Map e, Map l) {
    return {l.ar * e.ar - l.ai * e.ai, l.ar * e.ai + l.ai * e.ar,
            l.ar * e.br - l.ai * e.bi + l.br,
            l.ar * e.bi + l.ai * e.br + l.bi};
  }
  static __device__ Map shfl_up(Map m, int d) {
    return {__shfl_up_sync(kFull, m.ar, d), __shfl_up_sync(kFull, m.ai, d),
            __shfl_up_sync(kFull, m.br, d), __shfl_up_sync(kFull, m.bi, d)};
  }
  static __device__ Param param(const Args& g, int c) {
    return {__ldg(g.p[0] + c), __ldg(g.p[1] + c)};
  }
  // m, then the frame's map (p, f[t])
  static __device__ Map step(Map m, Param p, const float* in) {
    return {p.pr * m.ar - p.pi * m.ai, p.pr * m.ai + p.pi * m.ar,
            p.pr * m.br - p.pi * m.bi + in[0],
            p.pr * m.bi + p.pi * m.br + in[1]};
  }
  static __device__ State init(const Args& g, int c) {
    return {g.s[0][c], g.s[1][c]};
  }
  static __device__ State apply(Map m, State s) {
    return {m.ar * s.ur - m.ai * s.ui + m.br,
            m.ar * s.ui + m.ai * s.ur + m.bi};
  }
  static __device__ State advance(State s, Param p, const float* in) {
    return {p.pr * s.ur - p.pi * s.ui + in[0],
            p.pr * s.ui + p.pi * s.ur + in[1]};
  }
  static __device__ void put(State s, float* sm, int plane, int i) {
    sm[i] = s.ur;
    sm[plane + i] = s.ui;
  }
  static __device__ void put_agg(Map m, float* agg, long long plane,
                                 long long i) {
    agg[i] = m.br;
    agg[plane + i] = m.bi;
  }

  // float64, across tiles
  static __device__ DMap didentity() { return {1.0, 0.0, 0.0, 0.0}; }
  static __device__ DMap dbase(Param p) {
    return {(double)p.pr, (double)p.pi, 0.0, 0.0};
  }
  static __device__ DMap dcompose(DMap e, DMap l) {
    return {l.ar * e.ar - l.ai * e.ai, l.ar * e.ai + l.ai * e.ar,
            l.ar * e.br - l.ai * e.bi + l.br,
            l.ar * e.bi + l.ai * e.br + l.bi};
  }
  static __device__ DMap dshfl_up(DMap m, int d) {
    return {__shfl_up_sync(kFull, m.ar, d), __shfl_up_sync(kFull, m.ai, d),
            __shfl_up_sync(kFull, m.br, d), __shfl_up_sync(kFull, m.bi, d)};
  }
  static __device__ DMap dtile(DMap An, const float* agg, long long plane,
                               long long i) {
    return {An.ar, An.ai, (double)agg[i], (double)agg[plane + i]};
  }
  static __device__ DState dinit(const Args& g, int c) {
    return {(double)g.s[0][c], (double)g.s[1][c]};
  }
  static __device__ DState dapply(DMap m, DState s) {
    return {m.ar * s.ur - m.ai * s.ui + m.br,
            m.ar * s.ui + m.ai * s.ur + m.bi};
  }
  static __device__ State narrow(DState s) {
    return {(float)s.ur, (float)s.ui};
  }
};

}  // namespace

// f_r, f_i [T, C], p_r, p_i, s_r, s_i [C], u_r, u_i [T, C]: contiguous
// float32 device memory; cl, k: the tiling (kernels.scan_plan); scratch:
// 2 * tiles * C floats when the plan has more than one tile along the
// timeline, else unused. Launches on `stream` and returns the first CUDA
// error (0 on success); does not synchronise.
extern "C" int complex_scan_launch(const float* f_r, const float* f_i,
                                   const float* p_r, const float* p_i,
                                   const float* s_r, const float* s_i,
                                   float* u_r, float* u_i, float* scratch,
                                   long long T, int C, int cl, int k,
                                   void* stream) {
  const Args args{{f_r, f_i}, {p_r, p_i}, {s_r, s_i}, {u_r, u_i}};
  return scan_tile::launch<ComplexScanOp>(args, T, C, cl, k, scratch,
                                          stream);
}
