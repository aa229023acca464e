// Tiled first-order scans for Hopper (sm_90a): what csrc/affine_scan.cu
// and csrc/complex_scan.cu share.
//
// A scan runs a recurrence state[t, c] = f(state[t-1, c], x[t, c]) along
// the timeline of every lane c of row-major [T, C] planes, from a given
// state before frame 0. Each frame is an element of a monoid of maps
// (`Op::Map`: the affine or complex-affine map that frame applies), and
// the scan composes them in order, earlier first.
//
// Tiling. A tile is S frames x CL lanes, CL the power of two >= C (at
// most 32; wider rows are cut into tiles of 32 lanes). Its kThreads
// threads each own a run of K consecutive frames of one lane: thread i
// has lane i % CL and run i / CL, so S = (kThreads / CL) * K. The grid is
// (tiles along the timeline, tiles across the lanes); kernels.scan_plan
// chooses CL and K from [T, C] and passes them in.
//
// Inside a tile:
//   1. the tile is copied into shared memory as it lies in the plane,
//      with coalesced loads: with C <= 32 its S rows are one contiguous
//      block of S*C floats, copied as float4 on neighbouring threads when
//      the planes are 16-byte aligned; wider rows are copied as one
//      128-byte segment per frame. K is odd below 32 lanes, so the
//      threads of a warp, which read 32 (run, lane) slots K*CL floats
//      apart, hit 32 different banks;
//   2. each thread folds its run into one map (K dependent steps);
//   3. the runs' maps are scanned: a warp-shuffle scan over the runs of
//      each lane inside a warp (strides CL, 2*CL, ... 16), then the
//      warps' totals in shared memory (kWarps of them);
//   4. `tile_reduce` writes the tile's total map; `tile_scan` applies its
//      run's exclusive prefix to the tile's carry-in state, replays the
//      run frame by frame into shared memory and stores the tile with
//      coalesced writes.
//
// Across tiles: reduce-then-scan, two kernels from one host launcher (one
// ctypes call). `tile_reduce` writes every tile's B (the part of its
// total map that depends on the data) to scratch. Each `tile_scan` CTA
// then builds its own carry-in: the maps (a^S, B) of the tiles before it,
// grouped over its runs and composed with the same block scan, in
// float64, applied to the initial state (O(tiles / runs) loads a thread,
// at most 5 at the shapes of the render path). `tile_scan` reads the
// input a second time, from the 50 MB L2 at those shapes (at most 25
// MB). A single-pass decoupled look-back would save that second read,
// but it makes CTAs spin on flags of other CTAs; reduce-then-scan has no
// waits between CTAs, no atomics, and runs bit-identically from run to
// run. When the whole timeline is one tile (the delay line's few rows)
// only `tile_scan` runs, from the given initial state.
//
// Precision. Every full tile composes the same power a^S of the lane's
// pole, so an f32 tile map would carry the same rounding error into
// every tile, and those errors compound over a long timeline with a slow
// pole. The carry therefore builds A = a^S itself, in float64 by
// repeated squaring of the f32 pole, and composes the tiles' B and the
// state in float64. Inside a tile everything is f32 (at most 256 composed
// runs). No fast-math (kernels.NVCC_FLAGS); nvcc contracts multiply-adds
// into FMAs, which round once.
//
// The scratch planes (each tile's B, per lane) are allocated by the
// caller (kernels.py); the kernels allocate nothing.

#pragma once

#include <cuda_runtime.h>

namespace scan_tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a CTA may use without an opt-in
constexpr size_t kSharedBytes = 48 * 1024;

// Pointers of one scan: up to two input planes x [T, C], per-lane
// parameters p [C], the state before frame 0 s [C], output planes y
// [T, C]. The affine scan uses index 0 only.
struct Args {
  const float* x[2];
  const float* p[2];
  const float* s[2];
  float* y[2];
};

// Where this CTA's tile lies, and this thread's run in it. In shared
// memory the tile keeps its layout in the plane: frame r, lane l at
// r * W + l, W = C when C <= CL (the tile is one contiguous block of the
// plane), else W = CL (a CL-lane segment of each frame).
template <int CL>
struct TilePos {
  long long r0;  // first frame of the tile
  int rows;      // frames in the tile (S, or fewer in the last tile)
  int c0;        // first lane of the tile
  int w;         // floats per frame in shared memory
  int l;         // this thread's lane in the tile
  int c;         // its lane in [0, C), clamped for reading parameters
  bool live;     // c0 + l < C
  int base;      // shared-memory index of its run's first frame
  int n;         // frames of its run in the tile (0..K; 0 unless live)

  __device__ TilePos(long long T, int C, int K, long long S) {
    r0 = (long long)blockIdx.x * S;
    rows = (int)(T - r0 < S ? T - r0 : S);
    c0 = blockIdx.y * CL;
    w = C <= CL ? C : CL;
    l = threadIdx.x % CL;
    const int j = threadIdx.x / CL;
    live = c0 + l < C;
    c = live ? c0 + l : C - 1;
    base = j * K * w + l;
    const int left = rows - j * K;
    n = !live || left < 0 ? 0 : (left < K ? left : K);
  }
};

// Copy the tile of planes g[0..NP) into sm (`plane` floats apart), with
// coalesced loads: float4 on neighbouring threads when `vec` (C <= CL and
// 16-byte aligned planes), else one float a thread, a CL-lane segment of
// each frame when C > CL.
template <int CL, int NP>
__device__ __forceinline__ void load_tile(const float* const* g, float* sm,
                                          int plane, const TilePos<CL>& at,
                                          int C, bool vec) {
  const int n = at.rows * at.w;
  int done = 0;
  if (vec) {
    for (int q = threadIdx.x; q < (n >> 2); q += kThreads) {
#pragma unroll
      for (int a = 0; a < NP; ++a)
        reinterpret_cast<float4*>(sm + a * plane)[q] =
            __ldg(reinterpret_cast<const float4*>(g[a] + at.r0 * C) + q);
    }
    done = n & ~3;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) {
    const int r = i / CL;  // used when C > CL
    const int l = i % CL;
    if (C <= CL || at.c0 + l < C) {
      const long long off =
          C <= CL ? at.r0 * C + i : (at.r0 + r) * C + at.c0 + l;
#pragma unroll
      for (int a = 0; a < NP; ++a) sm[a * plane + i] = __ldg(g[a] + off);
    }
  }
}

// The mirror of load_tile: sm -> the planes g[0..NP).
template <int CL, int NP>
__device__ __forceinline__ void store_tile(float* const* g, const float* sm,
                                           int plane, const TilePos<CL>& at,
                                           int C, bool vec) {
  const int n = at.rows * at.w;
  int done = 0;
  if (vec) {
    for (int q = threadIdx.x; q < (n >> 2); q += kThreads) {
#pragma unroll
      for (int a = 0; a < NP; ++a)
        (reinterpret_cast<float4*>(g[a] + at.r0 * C))[q] =
            reinterpret_cast<const float4*>(sm + a * plane)[q];
    }
    done = n & ~3;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) {
    const int r = i / CL;
    const int l = i % CL;
    if (C <= CL || at.c0 + l < C) {
      const long long off =
          C <= CL ? at.r0 * C + i : (at.r0 + r) * C + at.c0 + l;
#pragma unroll
      for (int a = 0; a < NP; ++a) g[a][off] = sm[a * plane + i];
    }
  }
}

// Fold this thread's run into one map.
template <class Op, int CL>
__device__ __forceinline__ typename Op::Map fold_run(
    const float* sm, int plane, const TilePos<CL>& at,
    const typename Op::Param& pa) {
  typename Op::Map m = Op::identity();
#pragma unroll 4
  for (int k = 0; k < at.n; ++k) {
    float in[Op::kPlanes];
#pragma unroll
    for (int a = 0; a < Op::kPlanes; ++a)
      in[a] = sm[a * plane + at.base + k * at.w];
    m = Op::step(m, pa, in);
  }
  return m;
}

// The float64 maps of Op under the names block_scan uses.
template <class Op>
struct Wide {
  using Map = typename Op::DMap;
  static __device__ Map identity() { return Op::didentity(); }
  static __device__ Map compose(Map e, Map l) { return Op::dcompose(e, l); }
  static __device__ Map shfl_up(Map m, int d) { return Op::dshfl_up(m, d); }
};

// Scan of the runs' maps (one per thread: lane threadIdx.x % CL, run
// threadIdx.x / CL) over the CTA: a shuffle scan over the runs of each
// lane in a warp, then the warps' totals, kept in `wagg`. Returns this
// run's exclusive prefix, the maps of the earlier runs of its lane; sets
// `total` to the map of all runs of its lane.
template <class M, int CL>
__device__ __forceinline__ typename M::Map block_scan(
    typename M::Map run, typename M::Map* wagg, typename M::Map& total) {
  using Map = typename M::Map;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = threadIdx.x % CL;
  Map incl = run;
#pragma unroll
  for (int d = CL; d < 32; d <<= 1) {
    const Map q = M::shfl_up(incl, d);
    if (lane >= d) incl = M::compose(q, incl);
  }
  Map within = M::shfl_up(incl, CL);
  if (lane < CL) within = M::identity();
  if (lane >= 32 - CL) wagg[warp * CL + l] = incl;
  __syncthreads();
  Map pre = M::identity();
  total = M::identity();
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) pre = total;
    total = M::compose(total, wagg[w * CL + l]);
  }
  __syncthreads();  // wagg may be reused
  return M::compose(pre, within);
}

// Shared memory for the per-warp totals of block_scan, f32 or float64.
template <class Op, int CL>
union WarpTotals {
  typename Op::Map f[kWarps * CL];
  typename Op::DMap d[kWarps * CL];
};

// Each tile's total map: its B part into the agg planes [tiles, C].
template <class Op, int CL>
__global__ void __launch_bounds__(kThreads)
tile_reduce(Args args, long long T, int C, int K, long long S, bool vec,
            float* __restrict__ agg, long long agg_plane) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ WarpTotals<Op, CL> wt;
  const int plane = kThreads * K;
  const TilePos<CL> at(T, C, K, S);
  const typename Op::Param pa = Op::param(args, at.c);
  load_tile<CL, Op::kPlanes>(args.x, sm, plane, at, C, vec);
  __syncthreads();
  typename Op::Map total;
  block_scan<Op, CL>(fold_run<Op, CL>(sm, plane, at, pa), wt.f, total);
  if (threadIdx.x < CL && at.live)
    Op::put_agg(total, agg, agg_plane, (long long)blockIdx.x * C + at.c);
}

// The state entering this CTA's tile in lane at.c: the initial state,
// then the maps (a^S, B) of the tiles before it, composed in float64.
// Tile maps are grouped contiguously over the runs of the lane and
// scanned with block_scan. A = a^S by repeated squaring of the f32 pole.
template <class Op, int CL>
__device__ __forceinline__ typename Op::State carry_in(
    const Args& args, const TilePos<CL>& at, int C, long long S,
    const float* __restrict__ agg, long long agg_plane,
    typename Op::DMap* wagg) {
  using DMap = typename Op::DMap;
  const long long tile = blockIdx.x;
  DMap sq = Op::dbase(Op::param(args, at.c));
  DMap An = Op::didentity();
  for (long long e = S; e; e >>= 1) {
    if (e & 1) An = Op::dcompose(An, sq);
    sq = Op::dcompose(sq, sq);
  }
  const int runs = kThreads / CL;
  const long long per = (tile + runs - 1) / runs;
  const long long j = threadIdx.x / CL;
  const long long lo = j * per < tile ? j * per : tile;
  const long long hi = lo + per < tile ? lo + per : tile;
  DMap m = Op::didentity();
#pragma unroll 4
  for (long long u = lo; u < hi; ++u)
    m = Op::dcompose(m, Op::dtile(An, agg, agg_plane, u * C + at.c));
  DMap total;
  block_scan<Wide<Op>, CL>(m, wagg, total);
  return Op::narrow(Op::dapply(total, Op::dinit(args, at.c)));
}

// The scan of each tile from its carry-in state (the initial state when
// agg is null: one tile), written to y.
template <class Op, int CL>
__global__ void __launch_bounds__(kThreads)
tile_scan(Args args, long long T, int C, int K, long long S, bool vec,
          const float* __restrict__ agg, long long agg_plane) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ WarpTotals<Op, CL> wt;
  const int plane = kThreads * K;
  const TilePos<CL> at(T, C, K, S);
  const typename Op::Param pa = Op::param(args, at.c);
  load_tile<CL, Op::kPlanes>(args.x, sm, plane, at, C, vec);
  typename Op::State s =
      agg ? carry_in<Op, CL>(args, at, C, S, agg, agg_plane, wt.d)
          : Op::init(args, at.c);
  __syncthreads();
  typename Op::Map total;
  const typename Op::Map excl =
      block_scan<Op, CL>(fold_run<Op, CL>(sm, plane, at, pa), wt.f, total);
  s = Op::apply(excl, s);
#pragma unroll 4
  for (int k = 0; k < at.n; ++k) {
    const int i = at.base + k * at.w;
    float in[Op::kPlanes];
#pragma unroll
    for (int a = 0; a < Op::kPlanes; ++a) in[a] = sm[a * plane + i];
    s = Op::advance(s, pa, in);
    Op::put(s, sm, plane, i);
  }
  __syncthreads();
  store_tile<CL, Op::kPlanes>(args.y, sm, plane, at, C, vec);
}

// Dynamic shared memory of a tile: K frames a run, kThreads runs.
template <class Op>
constexpr size_t tile_bytes(int K) {
  return (size_t)kThreads * K * sizeof(float) * Op::kPlanes;
}

template <class Op, int CL>
cudaError_t launch_cl(const Args& args, long long T, int C, int K,
                      float* scratch, cudaStream_t stream) {
  const long long S = (long long)(kThreads / CL) * K;
  const long long tiles = (T + S - 1) / S;
  const int lane_tiles = (C + CL - 1) / CL;
  const size_t smem = tile_bytes<Op>(K);
  if (smem + sizeof(WarpTotals<Op, CL>) > kSharedBytes ||
      tiles > 0x7fffffffLL || lane_tiles > 65535)
    return cudaErrorInvalidValue;
  bool vec = C <= CL;
  for (int a = 0; a < Op::kPlanes; ++a)
    vec = vec && reinterpret_cast<size_t>(args.x[a]) % 16 == 0 &&
          reinterpret_cast<size_t>(args.y[a]) % 16 == 0;
  const dim3 grid((unsigned)tiles, (unsigned)lane_tiles);
  if (tiles == 1) {
    tile_scan<Op, CL><<<grid, kThreads, smem, stream>>>(args, T, C, K, S, vec,
                                                         nullptr, 0);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const long long plane = tiles * C;
  tile_reduce<Op, CL><<<grid, kThreads, smem, stream>>>(args, T, C, K, S, vec,
                                                         scratch, plane);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan<Op, CL><<<grid, kThreads, smem, stream>>>(args, T, C, K, S, vec,
                                                       scratch, plane);
  return cudaGetLastError();
}

// The launcher behind each kernel's extern "C" entry: checks the plan
// (cl a power of two in [1, 32], at least min(C, 32); k >= 1; the tile
// within shared memory) and runs one tile_scan, or tile_reduce then
// tile_scan.
// `scratch` holds Op::kPlanes * tiles * C floats when there is more than
// one tile. Returns the first launch error (0 on success); does not
// synchronise.
template <class Op>
int launch(const Args& args, long long T, int C, int cl, int k,
           float* scratch, void* stream) {
  if (T <= 0 || C <= 0) return 0;
  if (k < 1 || cl < (C < 32 ? C : 32)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cl) {
    case 1: err = launch_cl<Op, 1>(args, T, C, k, scratch, st); break;
    case 2: err = launch_cl<Op, 2>(args, T, C, k, scratch, st); break;
    case 4: err = launch_cl<Op, 4>(args, T, C, k, scratch, st); break;
    case 8: err = launch_cl<Op, 8>(args, T, C, k, scratch, st); break;
    case 16: err = launch_cl<Op, 16>(args, T, C, k, scratch, st); break;
    case 32: err = launch_cl<Op, 32>(args, T, C, k, scratch, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace scan_tile
