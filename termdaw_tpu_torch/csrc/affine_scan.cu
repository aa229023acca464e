// First-order affine recurrence for Hopper (sm_90a):
//
//     y[t, c] = a[c] * y[t-1, c] + b[t, c],   y[-1, c] = y0[c]
//
// for b [T, C] (row-major, lanes fastest), a [C], y0 [C], y [T, C], all
// float32. It replaces the XLA associative scan of the reference's
// one-pole filters: termdaw_tpu/ops/filters.py `affine_cumulative` /
// `tiled_cumulative` (filters.py:72-121), as `band_pass_timeline` runs it
// on four lanes (low/high x L/R, filters.py:251) and as the effects'
// followers run it through `first_order_scan_sharded` (filters.py:158-175).
// It is not a Pallas kernel there; PyTorch has no primitive for it.
//
// What bounds it on this card: at the c3 band-pass shape (T = 375 * 1024
// frames, C = 4) it reads 6 MB and writes 6 MB, a few microseconds of
// the card's 3.35 TB/s, and does 2 flops a frame and lane. The recurrence
// is sequential per lane, so the work is a chain of dependent FMAs.
//
// Design (simple and right first): one CTA per lane, kThreads threads.
// Thread j owns the contiguous chunk [j*n, (j+1)*n) of the timeline.
//   1. It folds its chunk into one affine map (A, B) sequentially.
//   2. The CTA scans the kThreads maps in shared memory (log-step,
//      composing (A2*A1, A2*B1 + B2)), which gives each thread the map of
//      everything before its chunk; applied to y0 that is its chunk's y[-1].
//   3. It runs the recurrence over its chunk again and writes y.
// Each frame is read twice. Only C CTAs run, and a warp's loads fall on
// 32 different chunks (not coalesced); the 6 MB stays in the 50 MB L2.
// Later work: more CTAs per lane with a decoupled look-back, staged
// coalesced loads through shared memory.
//
// Built without fast-math (kernels.NVCC_FLAGS): IEEE float32, subnormals
// kept. nvcc contracts each multiply-add into an FMA, which rounds once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
affine_scan_kernel(const float* __restrict__ b, const float* __restrict__ a,
                   const float* __restrict__ y0, float* __restrict__ y,
                   long long T, int C) {
  __shared__ float s_a[kThreads];
  __shared__ float s_b[kThreads];

  const int c = blockIdx.x;
  const int j = threadIdx.x;
  const long long n = (T + kThreads - 1) / kThreads;
  const long long t_lo = (long long)j * n < T ? (long long)j * n : T;
  const long long t_hi = t_lo + n < T ? t_lo + n : T;
  const float ac = a[c];

  // 1. this chunk's map: y_out = A * y_in + B
  float A = 1.0f;
  float B = 0.0f;
  for (long long t = t_lo; t < t_hi; ++t) {
    A = ac * A;
    B = ac * B + b[t * C + c];
  }

  // 2. inclusive scan of the chunk maps over the CTA (earlier first)
  s_a[j] = A;
  s_b[j] = B;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    float pa = 1.0f;
    float pb = 0.0f;
    if (j >= d) {
      pa = s_a[j - d];
      pb = s_b[j - d];
    }
    __syncthreads();
    if (j >= d) {
      B = A * pb + B;
      A = A * pa;
      s_a[j] = A;
      s_b[j] = B;
    }
    __syncthreads();
  }

  // the state entering this chunk: the maps of chunks 0..j-1 applied to y0
  float yc = y0[c];
  if (j > 0) yc = s_a[j - 1] * yc + s_b[j - 1];

  // 3. the recurrence over the chunk
  for (long long t = t_lo; t < t_hi; ++t) {
    yc = ac * yc + b[t * C + c];
    y[t * C + c] = yc;
  }
}

}  // namespace

// b [T, C], a [C], y0 [C], y [T, C]: contiguous float32 device memory.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// does not synchronise.
extern "C" int affine_scan_launch(const float* b, const float* a,
                                  const float* y0, float* y, long long T,
                                  int C, void* stream) {
  if (T <= 0 || C <= 0) return 0;
  affine_scan_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b, a, y0, y, T, C);
  return static_cast<int>(cudaGetLastError());
}
