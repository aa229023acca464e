// The exact sequential biquad lane for Hopper (sm_90a): a direct-form-1
// biquad over x [T, C] (row-major, channels fastest), frame by frame,
//
//     y[t] = (((b0*x[t] + b1*x[t-1]) + b2*x[t-2]) - a1*y[t-1]) - a2*y[t-2]
//
// per channel c with coefficients b0..a2 [C] and the state [4, C] =
// (x[-1], x[-2], y[-1], y[-2]); it returns y [T, C] and the state after
// the last frame, (x[T-1], x[T-2], y[T-1], y[T-2]). It replaces the
// reference's `lax.scan` lane, termdaw_tpu/ops/filters.py:384
// `biquad_apply_sequential` (selected by TERMDAW_EXACT_BIQUAD=1), which is
// not a Pallas kernel there; PyTorch has no primitive for it.
//
// The lane exists for its order: each multiply and each add rounded on
// its own, in the order above, with no reassociation. So the recurrence
// stays serial on purpose, and every step uses __fmul_rn / __fadd_rn /
// __fsub_rn: nvcc contracts a plain `a*b + c` into an FMA, which would
// round once instead of twice and break the bit-exactness with the plain
// version (ops/filters.biquad_seq_plain).
//
// What bounds it on this card: latency, not bytes. A frame's dependent
// chain is the multiply a1*y[t-1] and two subtracts (a2*y[t-2] and the
// feed-forward sum f[t] = (b0*x[t] + b1*x[t-1]) + b2*x[t-2] are off the
// chain): 3 dependent FP32 operations of 4 cycles each, about 12 cycles a
// frame, 6 ns at the H100 SXM's 1.98 GHz boost clock. The bytes (8 a
// frame and channel) are far below that.
//
// Design: one CTA per 32 channels (CL channels, the power of two >= C up
// to 32, a template parameter so every shared-memory offset below is an
// immediate). Warp 0 walks: lane c walks channel c0 + c, reading f from
// and writing y to shared memory only, kBatch frames of f loaded at once
// ahead of the chain, so the walker never waits on global memory and
// issues 6 instructions a frame. Warps 1-3 stage: while the walker walks
// tile k from one buffer, they copy tile k+1's x (with its 2-frame halo)
// into shared memory with coalesced asynchronous copies (cp.async; a tile
// is kTileFloats / CL frames of the CTA's channels, one contiguous run of
// device memory when C <= 32), compute its f into the other buffer, and
// write tile k-1's y back; one __syncthreads a tile hands the buffers
// over. f is rounded in the reference's order, so splitting the step
// between the warps changes no bit.
//
// Earlier versions, where the walker computed the whole step from x
// (about 20 instructions a frame), were issue-bound, far above the bound,
// whether the stagers used plain loads or cp.async; moving f to
// the stagers is what brought the walker near its chain. kBatch and the
// stager count were chosen with termdaw_tpu_torch/tools/scan_tiling.py,
// which times other values of both (PERF.md).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // warp 0 walks, warps 1-3 stage
constexpr int kStagers = kThreads - 32;
constexpr int kTileFloats = 2048;  // floats of one staged tile (8 KB)
constexpr int kBatch = 32;         // frames a walker loads at once

// a named barrier over the stager warps only (the walker does not wait)
__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kStagers));
}

template <int CL>
__global__ void __launch_bounds__(kThreads) biquad_seq_kernel(
    const float* __restrict__ x, const float* __restrict__ b0,
    const float* __restrict__ b1, const float* __restrict__ b2,
    const float* __restrict__ a1, const float* __restrict__ a2,
    const float* __restrict__ s_in, float* __restrict__ y,
    float* __restrict__ s_out, long long T, int C) {
  constexpr int F = kTileFloats / CL;  // frames a tile
  __shared__ float xs[(F + 2) * CL];   // a tile's x behind its 2-frame halo
  __shared__ float fs[2][kTileFloats];  // feed-forward sums
  __shared__ float ys[2][kTileFloats];
  __shared__ float cb[3][CL];           // b0, b1, b2
  const int c0 = blockIdx.x * CL;
  const int cw = C - c0 < CL ? C - c0 : CL;  // this CTA's channels
  const long long tiles = (T + F - 1) / F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stager = threadIdx.x - 32;
  auto frames = [&](long long k) {
    return static_cast<int>(T - k * F < F ? T - k * F : F);
  };

  if (threadIdx.x < CL) {
    const bool on = threadIdx.x < cw;
    const int c = c0 + threadIdx.x;
    cb[0][threadIdx.x] = on ? b0[c] : 0.f;
    cb[1][threadIdx.x] = on ? b1[c] : 0.f;
    cb[2][threadIdx.x] = on ? b2[c] : 0.f;
  }
  __syncthreads();

  // stagers: tile k's f into fs[k & 1]
  auto prepare = [&](long long k) {
    const long long t0 = k * F;
    const int nf = frames(k);
    for (int e = stager; e < (nf + 2) * CL; e += kStagers) {
      const int ch = e % CL;
      const long long t = t0 + e / CL - 2;
      if (ch >= cw) continue;
      if (t >= 0)
        __pipeline_memcpy_async(xs + e, x + t * C + c0 + ch, sizeof(float));
      else  // x[-1], x[-2] from the state
        xs[e] = s_in[(t == -1 ? 0 : C) + c0 + ch];
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    stagers_sync();
    float* fd = fs[k & 1];
    for (int e = stager; e < nf * CL; e += kStagers) {
      const int ch = e % CL;
      const float* xe = xs + e + 2 * CL;
      fd[e] = __fadd_rn(__fadd_rn(__fmul_rn(cb[0][ch], xe[0]),
                                  __fmul_rn(cb[1][ch], xe[-CL])),
                        __fmul_rn(cb[2][ch], xe[-2 * CL]));
    }
  };
  auto store = [&](long long k) {
    const long long t0 = k * F;
    const float* src = ys[k & 1];
    for (int e = stager; e < frames(k) * CL; e += kStagers) {
      const int ch = e % CL;
      if (ch < cw) y[(t0 + e / CL) * C + c0 + ch] = src[e];
    }
  };

  const bool walks = warp == 0 && lane < cw;
  const int c = c0 + lane;
  float A1 = 0.f, A2 = 0.f, y1 = 0.f, y2 = 0.f;
  if (walks) {
    A1 = a1[c];
    A2 = a2[c];
    y1 = s_in[2 * C + c];
    y2 = s_in[3 * C + c];
  }
  if (warp > 0) prepare(0);
  __syncthreads();
  for (long long k = 0; k < tiles; ++k) {
    if (warp == 0) {
      if (walks) {
        const float* ft = fs[k & 1] + lane;
        float* yt = ys[k & 1] + lane;
        const int nf = frames(k);
        int f = 0;
        for (; f + kBatch <= nf; f += kBatch) {
          float v[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) v[j] = ft[(f + j) * CL];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const float acc = __fsub_rn(__fsub_rn(v[j], __fmul_rn(A1, y1)),
                                        __fmul_rn(A2, y2));
            y2 = y1;
            y1 = acc;
            v[j] = acc;
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) yt[(f + j) * CL] = v[j];
        }
        for (; f < nf; ++f) {
          const float acc = __fsub_rn(__fsub_rn(ft[f * CL], __fmul_rn(A1, y1)),
                                      __fmul_rn(A2, y2));
          y2 = y1;
          y1 = acc;
          yt[f * CL] = acc;
        }
      }
    } else {
      if (k + 1 < tiles) prepare(k + 1);
      if (k > 0) store(k - 1);
    }
    __syncthreads();
  }
  if (warp > 0 && tiles > 0) store(tiles - 1);
  if (walks) {
    s_out[c] = x[(T - 1) * C + c];
    s_out[C + c] = T > 1 ? x[(T - 2) * C + c] : s_in[c];
    s_out[2 * C + c] = y1;
    s_out[3 * C + c] = y2;
  }
}

template <int CL>
void launch(int grid, cudaStream_t stream, const float* x, const float* b0,
            const float* b1, const float* b2, const float* a1,
            const float* a2, const float* state, float* y, float* new_state,
            long long T, int C) {
  biquad_seq_kernel<CL><<<grid, kThreads, 0, stream>>>(
      x, b0, b1, b2, a1, a2, state, y, new_state, T, C);
}

}  // namespace

extern "C" int biquad_seq_launch(const float* x, const float* b0,
                                 const float* b1, const float* b2,
                                 const float* a1, const float* a2,
                                 const float* state, float* y,
                                 float* new_state, long long T, int C,
                                 void* stream) {
  if (T <= 0 || C <= 0) return 0;
  int cl = 1;
  while (cl < C && cl < 32) cl <<= 1;
  const int grid = (C + cl - 1) / cl;
  auto s = static_cast<cudaStream_t>(stream);
  switch (cl) {
    case 1: launch<1>(grid, s, x, b0, b1, b2, a1, a2, state, y, new_state, T, C); break;
    case 2: launch<2>(grid, s, x, b0, b1, b2, a1, a2, state, y, new_state, T, C); break;
    case 4: launch<4>(grid, s, x, b0, b1, b2, a1, a2, state, y, new_state, T, C); break;
    case 8: launch<8>(grid, s, x, b0, b1, b2, a1, a2, state, y, new_state, T, C); break;
    case 16: launch<16>(grid, s, x, b0, b1, b2, a1, a2, state, y, new_state, T, C); break;
    default: launch<32>(grid, s, x, b0, b1, b2, a1, a2, state, y, new_state, T, C); break;
  }
  return static_cast<int>(cudaGetLastError());
}
