// The eq3's Linkwitz-Riley crossover tree for Hopper (sm_90a): four
// biquad stages over [T, 4] lanes (L_lp, R_lp, L_hp, R_hp) and the band
// sum, from the window's stereo input x [T, 2] to its output y [T, 2].
// It stands for the reference's eq3 (termdaw_tpu/ops/fx.py) as it runs
// termdaw_tpu/ops/filters.py:357-534 `biquad_apply` four times, each a
// feed-forward part and two first-order complex recurrences
// `_first_order_complex` (filters.py:316-354) through the section's
// poles:
//
//   f[n] = b0*x[n] + b1*x[n-1] + b2*x[n-2]
//   u[n] = p1*u[n-1] + f[n],   y[n] = p2*y[n-1] + u[n]
//
// stage 0 on [x, x] and stage 1 on its output with the low crossover's
// lowpass / highpass pair, stages 2 and 3 on [upper, upper] (lanes 2-3
// of stage 1) with the high crossover's; the band sum g_lo*low +
// g_mid*mid + g_hi*high of stage 1's lanes 0-1 and stage 3's lanes.
//
// What bounds it on this card: bytes, and then the latency of its
// passes. Composed from torch ops and the complex scan
// (csrc/complex_scan.cu), one eq3 window moved ~750 MB at c8's window
// (T = 384,000): the [x, x] and [upper, upper] copies, two shifted copies
// of each stage's input for its taps, the five-op feed-forward, a zero
// imaginary plane, the strided band slices and two scans of two planes in
// and two out a stage, in ~190 launches. Here a stage reads its input
// lanes in place and writes [T, 4] once; the last writes y [T, 2]: ~70
// MB a window with reduce-then-scan's second reads (mostly from the 50
// MB L2), in at most 8 launches. Each pass is then short enough that its
// tiles' serial steps and carry-in, not its bytes, set its time (PERF.md).
//
// Design: each stage is the tiled reduce-then-scan of csrc/scan_tile.cuh
// over [T, 4] with its own load and store (Eq3Stage::kOwnIO):
//   * the load reads each lane's input where it lies (lane c of stage 0
//     reads channel c % 2 of x; stage 2 reads lane 2 + c % 2 of stage 1),
//     and computes the taps f in shared memory, the two frames before
//     the window from the stage's state;
//   * both recurrences are one scan over the state (u, y): a frame maps
//     it by the lower-triangular complex matrix [[p1, 0], [p1, p2]] plus
//     (f, f), so a map is u -> a*u + e, y -> c*u + d*y + g. Inside a
//     tile in f32, the carry across tiles (A = the frame map's power by
//     repeated squaring, and the state) in float64, as the other scans;
//   * the store writes the stage's real y, the new state (x[T-1],
//     x[T-2], y[T-1], y[T-2]) from the CTAs that hold those frames and,
//     on the last stage, the band sum in place of the stage's lanes.
// The taps, the seed u[-1] = y[-1] - p2*y[-2] and the band sum round
// each multiply and add on their own, in the order of the torch ops of
// the plain version (ops/fx.eq3_plain); the poles are computed once at
// graph build by the same torch arithmetic (ops/filters.biquad_poles).

#include "scan_tile.cuh"

namespace {

using scan_tile::kFull;
using scan_tile::kThreads;
using scan_tile::TilePos;

constexpr int kLanes = 4;

struct Eq3Args {
  const float* x;      // the stage's input, xs floats a frame
  const float* coef;   // [7, 4]: b0, b1, b2, p1r, p1i, p2r, p2i
  const float* state;  // [4, 4]: x[-1], x[-2], y[-1], y[-2]
  float* y;            // [T, 4], or the band sum [T, 2] on the last stage
  float* state_out;    // [4, 4]
  const float* low;    // the last stage's low band: lanes 0-1 of [T, 4]
  const float* gain_db[3];  // the last stage's low, mid and high gains
  long long T;
  int xs, xo, cmask;  // lane c reads x[t * xs + xo + (c & cmask)]
  int last;           // the band-sum stage
};

__device__ __forceinline__ float input(const Eq3Args& g, long long t,
                                       int c) {
  return t >= 0 ? __ldg(g.x + t * g.xs + g.xo + (c & g.cmask))
                : g.state[(-1 - t) * kLanes + c];
}

struct Eq3Stage {
  static constexpr int kPlanes = 1;
  static constexpr bool kOwnIO = true;
  using Args = Eq3Args;
  // u -> a*u + e, y -> c*u + d*y + g, complex as (re, im)
  struct Map { float ar, ai, cr, ci, dr, di, er, ei, gr, gi; };
  struct Param { float b0, b1, b2, p1r, p1i, p2r, p2i; };
  struct State { float ur, ui, yr, yi; };
  struct DMap { double ar, ai, cr, ci, dr, di, er, ei, gr, gi; };
  struct DState { double ur, ui, yr, yi; };

  // e, then l (the same for Map and DMap)
  template <class M>
  static __device__ M comp(M e, M l) {
    return {l.ar * e.ar - l.ai * e.ai,
            l.ar * e.ai + l.ai * e.ar,
            l.cr * e.ar - l.ci * e.ai + (l.dr * e.cr - l.di * e.ci),
            l.cr * e.ai + l.ci * e.ar + (l.dr * e.ci + l.di * e.cr),
            l.dr * e.dr - l.di * e.di,
            l.dr * e.di + l.di * e.dr,
            l.ar * e.er - l.ai * e.ei + l.er,
            l.ar * e.ei + l.ai * e.er + l.ei,
            l.cr * e.er - l.ci * e.ei + (l.dr * e.gr - l.di * e.gi) + l.gr,
            l.cr * e.ei + l.ci * e.er + (l.dr * e.gi + l.di * e.gr) + l.gi};
  }
  template <class M>
  static __device__ M shfl(M m, int d) {
    return {__shfl_up_sync(kFull, m.ar, d), __shfl_up_sync(kFull, m.ai, d),
            __shfl_up_sync(kFull, m.cr, d), __shfl_up_sync(kFull, m.ci, d),
            __shfl_up_sync(kFull, m.dr, d), __shfl_up_sync(kFull, m.di, d),
            __shfl_up_sync(kFull, m.er, d), __shfl_up_sync(kFull, m.ei, d),
            __shfl_up_sync(kFull, m.gr, d), __shfl_up_sync(kFull, m.gi, d)};
  }
  template <class M, class S>
  static __device__ S app(M m, S s) {
    return {m.ar * s.ur - m.ai * s.ui + m.er,
            m.ar * s.ui + m.ai * s.ur + m.ei,
            m.cr * s.ur - m.ci * s.ui + (m.dr * s.yr - m.di * s.yi) + m.gr,
            m.cr * s.ui + m.ci * s.ur + (m.dr * s.yi + m.di * s.yr) + m.gi};
  }

  static __device__ Map identity() { return {1, 0, 0, 0, 1, 0, 0, 0, 0, 0}; }
  static __device__ Map compose(Map e, Map l) { return comp(e, l); }
  static __device__ Map shfl_up(Map m, int d) { return shfl(m, d); }
  static __device__ Param param(const Args& g, int c) {
    return {__ldg(g.coef + 0 * kLanes + c), __ldg(g.coef + 1 * kLanes + c),
            __ldg(g.coef + 2 * kLanes + c), __ldg(g.coef + 3 * kLanes + c),
            __ldg(g.coef + 4 * kLanes + c), __ldg(g.coef + 5 * kLanes + c),
            __ldg(g.coef + 6 * kLanes + c)};
  }
  // m, then the frame's map ([[p1, 0], [p1, p2]], (f, f))
  static __device__ Map step(Map m, Param p, const float* in) {
    const float ar = p.p1r * m.ar - p.p1i * m.ai;
    const float ai = p.p1r * m.ai + p.p1i * m.ar;
    const float er = p.p1r * m.er - p.p1i * m.ei + in[0];
    const float ei = p.p1r * m.ei + p.p1i * m.er;
    return {ar, ai,
            ar + (p.p2r * m.cr - p.p2i * m.ci),
            ai + (p.p2r * m.ci + p.p2i * m.cr),
            p.p2r * m.dr - p.p2i * m.di,
            p.p2r * m.di + p.p2i * m.dr,
            er, ei,
            er + (p.p2r * m.gr - p.p2i * m.gi),
            ei + (p.p2r * m.gi + p.p2i * m.gr)};
  }
  // (u, y)[-1] from the state: y = (y[-1], 0), u = y[-1] - p2*y[-2]
  static __device__ State init(const Args& g, int c) {
    const float y1 = g.state[2 * kLanes + c];
    const float y2 = g.state[3 * kLanes + c];
    const float p2r = __ldg(g.coef + 5 * kLanes + c);
    const float p2i = __ldg(g.coef + 6 * kLanes + c);
    return {__fsub_rn(y1, __fmul_rn(p2r, y2)), __fmul_rn(-p2i, y2), y1, 0.0f};
  }
  static __device__ State apply(Map m, State s) { return app(m, s); }
  static __device__ State advance(State s, Param p, const float* in) {
    const float ur = p.p1r * s.ur - p.p1i * s.ui + in[0];
    const float ui = p.p1r * s.ui + p.p1i * s.ur;
    return {ur, ui, p.p2r * s.yr - p.p2i * s.yi + ur,
            p.p2r * s.yi + p.p2i * s.yr + ui};
  }
  static __device__ void put(State s, float* sm, int, int i) { sm[i] = s.yr; }
  static __device__ void put_agg(Map m, float* agg, long long plane,
                                 long long i) {
    agg[i] = m.er;
    agg[plane + i] = m.ei;
    agg[2 * plane + i] = m.gr;
    agg[3 * plane + i] = m.gi;
  }

  // float64, across tiles
  static __device__ DMap didentity() {
    return {1, 0, 0, 0, 1, 0, 0, 0, 0, 0};
  }
  static __device__ DMap dbase(Param p) {
    return {p.p1r, p.p1i, p.p1r, p.p1i, p.p2r, p.p2i, 0, 0, 0, 0};
  }
  static __device__ DMap dcompose(DMap e, DMap l) { return comp(e, l); }
  static __device__ DMap dshfl_up(DMap m, int d) {
    return shfl(m, d);
  }
  static __device__ DMap dtile(DMap An, const float* agg, long long plane,
                               long long i) {
    An.er = agg[i];
    An.ei = agg[plane + i];
    An.gr = agg[2 * plane + i];
    An.gi = agg[3 * plane + i];
    return An;
  }
  static __device__ DState dinit(const Args& g, int c) {
    const State s = init(g, c);
    return {s.ur, s.ui, s.yr, s.yi};
  }
  static __device__ DState dapply(DMap m, DState s) { return app(m, s); }
  static __device__ State narrow(DState s) {
    return {(float)s.ur, (float)s.ui, (float)s.yr, (float)s.yi};
  }

  // the taps f of the tile's frames into sm, frame r, lane l at r*4 + l:
  // the input lanes a frame at a time (a float4, or the float2 of two
  // channels twice), then each thread's run in place, the two frames
  // before it read first
  static __device__ void load(const Args& g, float* sm, int,
                              const TilePos<kLanes>& at, int) {
    const float* src = g.x + g.xo;
    const bool quad = g.cmask == 3;
    // rows of 2 or 4 floats: aligned vectors unless x starts mid-vector
    const bool vec = reinterpret_cast<size_t>(src) % (quad ? 16 : 8) == 0;
#pragma unroll 4
    for (int r = threadIdx.x; r < at.rows; r += kThreads) {
      const float* row = src + (at.r0 + r) * g.xs;
      float4 v;
      if (vec && quad) {
        v = __ldg(reinterpret_cast<const float4*>(row));
      } else if (vec) {
        const float2 u = __ldg(reinterpret_cast<const float2*>(row));
        v = make_float4(u.x, u.y, u.x, u.y);
      } else {
        v.x = __ldg(row);
        v.y = __ldg(row + 1);
        v.z = quad ? __ldg(row + 2) : v.x;
        v.w = quad ? __ldg(row + 3) : v.y;
      }
      reinterpret_cast<float4*>(sm)[r] = v;
    }
    __syncthreads();
    const int l = at.l;
    const int first = (at.base - l) / kLanes;  // the run's first frame
    float x1 = first >= 1 ? sm[at.base - kLanes] : input(g, at.r0 + first - 1, l);
    float x2 = first >= 2 ? sm[at.base - 2 * kLanes]
                          : input(g, at.r0 + first - 2, l);
    __syncthreads();
    const float b0 = __ldg(g.coef + l), b1 = __ldg(g.coef + kLanes + l),
                b2 = __ldg(g.coef + 2 * kLanes + l);
    for (int k = 0; k < at.n; ++k) {
      const int i = at.base + k * kLanes;
      const float x0 = sm[i];
      sm[i] = __fadd_rn(__fadd_rn(__fmul_rn(b0, x0), __fmul_rn(b1, x1)),
                        __fmul_rn(b2, x2));
      x2 = x1;
      x1 = x0;
    }
  }

  // the tile's y (or band sum) and, where it holds them, the state
  static __device__ void store(const Args& g, const float* sm, int,
                               const TilePos<kLanes>& at, int) {
    const float4* rows = reinterpret_cast<const float4*>(sm);
    if (g.last) {
      float gain[3];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        gain[b] = powf(10.0f, __fdiv_rn(*g.gain_db[b], 20.0f));
      // mid: lanes 0-1, high: lanes 2-3 of this stage; low: of stage 1
#pragma unroll 4
      for (int r = threadIdx.x; r < at.rows; r += kThreads) {
        const long long t = at.r0 + r;
        const float4 v = rows[r];
        const float2 lo = *reinterpret_cast<const float2*>(g.low + t * kLanes);
        float2 o;
        o.x = __fadd_rn(__fadd_rn(__fmul_rn(lo.x, gain[0]),
                                  __fmul_rn(v.x, gain[1])),
                        __fmul_rn(v.z, gain[2]));
        o.y = __fadd_rn(__fadd_rn(__fmul_rn(lo.y, gain[0]),
                                  __fmul_rn(v.y, gain[1])),
                        __fmul_rn(v.w, gain[2]));
        reinterpret_cast<float2*>(g.y)[t] = o;
      }
    } else {
#pragma unroll 4
      for (int r = threadIdx.x; r < at.rows; r += kThreads)
        reinterpret_cast<float4*>(g.y)[at.r0 + r] = rows[r];
    }
    // x[T-j] and y[T-j] into rows j-1 and 2+j-1; where T-2 < 0 (T = 1)
    // the window leaves x[-1] and y[-1] one frame back
    if (threadIdx.x < 2 * kLanes) {
      const int j = 1 + threadIdx.x / kLanes, l = threadIdx.x % kLanes;
      const long long t = g.T - j;
      if (t >= at.r0 && t < at.r0 + at.rows) {
        g.state_out[(j - 1) * kLanes + l] = input(g, t, l);
        g.state_out[(j + 1) * kLanes + l] = sm[(t - at.r0) * kLanes + l];
      } else if (t < 0 && blockIdx.x == 0) {
        g.state_out[(j - 1) * kLanes + l] = g.state[l];
        g.state_out[(j + 1) * kLanes + l] = g.state[2 * kLanes + l];
      }
    }
  }
};

cudaError_t stage(const Eq3Args& a, int k, float* scratch,
                  cudaStream_t st) {
  using scan_tile::tile_reduce;
  using scan_tile::tile_scan;
  const long long S = (long long)(kThreads / kLanes) * k;
  const long long tiles = (a.T + S - 1) / S;
  const size_t smem = (size_t)kThreads * k * sizeof(float);
  if (smem + sizeof(scan_tile::WarpTotals<Eq3Stage, kLanes>) >
          scan_tile::kSharedBytes ||
      tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1);
  if (tiles == 1) {
    tile_scan<Eq3Stage, kLanes><<<grid, kThreads, smem, st>>>(
        a, a.T, kLanes, k, S, false, nullptr, 0);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const long long plane = tiles * kLanes;
  tile_reduce<Eq3Stage, kLanes><<<grid, kThreads, smem, st>>>(
      a, a.T, kLanes, k, S, false, scratch, plane);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan<Eq3Stage, kLanes><<<grid, kThreads, smem, st>>>(
      a, a.T, kLanes, k, S, false, scratch, plane);
  return cudaGetLastError();
}

}  // namespace

// x [T, 2]: the window's input; coef_lo, coef_hi [7, 4]: the low and high
// crossovers' (b0, b1, b2, p1r, p1i, p2r, p2i) per lane; st0..st3 [4, 4]:
// the stages' states; g_lo, g_mid, g_hi: the gains in dB (one float
// each); t01 [T, 4]: stage 0's output, then stage 2's; t1 [T, 4]: stage
// 1's; y [T, 2]: the band sum; state_out [4, 4, 4]: the stages' new
// states; k: frames a run (kernels.scan_plan(T, 4, "eq3")); scratch: 4 *
// tiles * 4 floats when a stage has more than one tile, else unused. All
// float32 device memory, contiguous. Launches the four stages on
// `stream` in order and returns the first CUDA error (0 on success);
// does not synchronise.
extern "C" int eq3_launch(const float* x, const float* coef_lo,
                          const float* coef_hi, const float* st0,
                          const float* st1, const float* st2,
                          const float* st3, const float* g_lo,
                          const float* g_mid, const float* g_hi, float* t01,
                          float* t1, float* y, float* state_out,
                          float* scratch, long long T, int k, void* stream) {
  if (T <= 0) return 0;
  if (k < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* states[4] = {st0, st1, st2, st3};
  // input, its row stride, lane offset and lane mask; coefficients; output
  const Eq3Args base{nullptr, nullptr, nullptr, nullptr, nullptr,
                     t1, {g_lo, g_mid, g_hi}, T, 0, 0, 0, 0};
  const struct {
    const float* in;
    int xs, xo, cmask;
    const float* coef;
    float* out;
  } plan[4] = {{x, 2, 0, 1, coef_lo, t01},
               {t01, 4, 0, 3, coef_lo, t1},
               {t1, 4, 2, 1, coef_hi, t01},
               {t01, 4, 0, 3, coef_hi, y}};
  for (int s = 0; s < 4; ++s) {
    Eq3Args a = base;
    a.x = plan[s].in;
    a.xs = plan[s].xs;
    a.xo = plan[s].xo;
    a.cmask = plan[s].cmask;
    a.coef = plan[s].coef;
    a.state = states[s];
    a.y = plan[s].out;
    a.state_out = state_out + s * 4 * kLanes;
    a.last = s == 3;
    const cudaError_t err = stage(a, k, scratch, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
