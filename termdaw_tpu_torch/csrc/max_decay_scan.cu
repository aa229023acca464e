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
// What bounds it on this card: at the c4 compressor shape (T = 375 * 1024
// frames, C = 1) it reads 1.5 MB and writes 1.5 MB, about a microsecond of
// the card's 3.35 TB/s, and does 2 flops a frame. The recurrence is
// sequential per lane, so the work is a chain of dependent multiply-maxes.
//
// Design (simple and right first), the three phases of affine_scan.cu:
// one CTA per lane, kThreads threads, thread j owns the contiguous chunk
// [j*n, (j+1)*n) of the timeline.
//   1. It folds its chunk into one monoid element (A, B) sequentially:
//      y_out = max(B, A * y_in).
//   2. The CTA scans the kThreads elements in shared memory (log-step,
//      composing (A1*A2, max(B2, A2*B1)), earlier first), which gives each
//      thread the element of everything before its chunk; applied to y0
//      that is its chunk's y[-1].
//   3. It runs the recurrence over its chunk again and writes y.
// The compressor runs on one lane, so one CTA (one SM) does the work.
// Later work: more CTAs per lane with a decoupled look-back.
//
// The decay products A = r^n are folded and scanned in double. Every
// chunk multiplies the same r the same number of times, so an f32 fold
// would give every chunk the same rounding error, and composing hundreds
// of chunks adds those errors up: with r = 0.99992 (a 250 ms release at
// 48 kHz) and a long decay that was 4e-4 of max |y| over 100,000 frames
// on the card. In double the products are exact to far below f32; the
// values B and the replay stay f32, as in the reference.
//
// NaN: jnp.maximum and torch.maximum propagate NaN, CUDA's fmaxf does
// not, so the kernel uses its own NaN-propagating max. The identity is
// the reference's -3.0e38, not -inf (0 * -inf would be NaN).
// Built without fast-math (kernels.NVCC_FLAGS): IEEE float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr float kIdentity = -3.0e38f;

// max(a, b) that returns NaN when either is NaN, as torch.maximum does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
max_decay_scan_kernel(const float* __restrict__ x, const float* __restrict__ r,
                      const float* __restrict__ y0, float* __restrict__ y,
                      long long T, int C) {
  __shared__ double s_a[kThreads];
  __shared__ float s_b[kThreads];

  const int c = blockIdx.x;
  const int j = threadIdx.x;
  const long long n = (T + kThreads - 1) / kThreads;
  const long long t_lo = (long long)j * n < T ? (long long)j * n : T;
  const long long t_hi = t_lo + n < T ? t_lo + n : T;
  const float rc = r[c];

  // 1. this chunk's element: y_out = max(B, A * y_in)
  double A = 1.0;
  float B = kIdentity;
  for (long long t = t_lo; t < t_hi; ++t) {
    A = A * (double)rc;
    B = nan_max(x[t * C + c], rc * B);
  }

  // 2. inclusive scan of the chunk elements over the CTA (earlier first)
  s_a[j] = A;
  s_b[j] = B;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    double pa = 1.0;
    float pb = kIdentity;
    if (j >= d) {
      pa = s_a[j - d];
      pb = s_b[j - d];
    }
    __syncthreads();
    if (j >= d) {
      B = nan_max(B, (float)(A * (double)pb));
      A = pa * A;
      s_a[j] = A;
      s_b[j] = B;
    }
    __syncthreads();
  }

  // the value entering this chunk: chunks 0..j-1 applied to y0
  float yc = y0[c];
  if (j > 0) yc = nan_max(s_b[j - 1], (float)(s_a[j - 1] * (double)yc));

  // 3. the recurrence over the chunk
  for (long long t = t_lo; t < t_hi; ++t) {
    yc = nan_max(x[t * C + c], rc * yc);
    y[t * C + c] = yc;
  }
}

}  // namespace

// x [T, C], r [C], y0 [C], y [T, C]: contiguous float32 device memory.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// does not synchronise.
extern "C" int max_decay_scan_launch(const float* x, const float* r,
                                     const float* y0, float* y, long long T,
                                     int C, void* stream) {
  if (T <= 0 || C <= 0) return 0;
  max_decay_scan_kernel<<<C, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, r, y0, y, T,
                                                               C);
  return static_cast<int>(cudaGetLastError());
}
