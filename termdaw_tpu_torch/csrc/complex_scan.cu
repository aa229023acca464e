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
// What bounds it on this card: at the c4 eq3 shape (T = 375 * 1024
// frames, C = 4 channels) it reads 12 MB and writes 12 MB, a few
// microseconds of the card's 3.35 TB/s, and does 8 flops a frame and
// lane. The recurrence is sequential per lane, so the work is a chain of
// dependent complex multiply-adds.
//
// Design (simple and right first), the three phases of affine_scan.cu:
// one CTA per lane, kThreads threads, thread j owns the contiguous chunk
// [j*n, (j+1)*n) of the timeline.
//   1. It folds its chunk into one complex affine map (A, B) sequentially.
//   2. The CTA scans the kThreads maps in shared memory (log-step), which
//      gives each thread the map of everything before its chunk; applied
//      to s that is its chunk's u[-1].
//   3. It runs the recurrence over its chunk again and writes u.
// Every composition is _caffine_combine's (earlier, later) product:
//   A = A2*A1, B = A2*B1 + B2,
// with (ar2*ar1 - ai2*ai1, ar2*ai1 + ai2*ar1) as the complex product.
// Later work: more CTAs per lane with a decoupled look-back; the eq3's
// four stages and two cascades in one launch.
//
// Built without fast-math (kernels.NVCC_FLAGS): IEEE float32. nvcc
// contracts multiply-adds into FMAs, which round once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
complex_scan_kernel(const float* __restrict__ f_r,
                    const float* __restrict__ f_i,
                    const float* __restrict__ p_r,
                    const float* __restrict__ p_i,
                    const float* __restrict__ s_r,
                    const float* __restrict__ s_i, float* __restrict__ u_r,
                    float* __restrict__ u_i, long long T, int C) {
  __shared__ float s_ar[kThreads];
  __shared__ float s_ai[kThreads];
  __shared__ float s_br[kThreads];
  __shared__ float s_bi[kThreads];

  const int c = blockIdx.x;
  const int j = threadIdx.x;
  const long long n = (T + kThreads - 1) / kThreads;
  const long long t_lo = (long long)j * n < T ? (long long)j * n : T;
  const long long t_hi = t_lo + n < T ? t_lo + n : T;
  const float pr = p_r[c];
  const float pi = p_i[c];

  // 1. this chunk's map: u_out = A * u_in + B (complex)
  float ar = 1.0f, ai = 0.0f, br = 0.0f, bi = 0.0f;
  for (long long t = t_lo; t < t_hi; ++t) {
    const float xr = f_r[t * C + c];
    const float xi = f_i[t * C + c];
    const float nar = pr * ar - pi * ai;
    const float nai = pr * ai + pi * ar;
    const float nbr = pr * br - pi * bi + xr;
    const float nbi = pr * bi + pi * br + xi;
    ar = nar;
    ai = nai;
    br = nbr;
    bi = nbi;
  }

  // 2. inclusive scan of the chunk maps over the CTA (earlier first)
  s_ar[j] = ar;
  s_ai[j] = ai;
  s_br[j] = br;
  s_bi[j] = bi;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    float qar = 1.0f, qai = 0.0f, qbr = 0.0f, qbi = 0.0f;
    if (j >= d) {
      qar = s_ar[j - d];
      qai = s_ai[j - d];
      qbr = s_br[j - d];
      qbi = s_bi[j - d];
    }
    __syncthreads();
    if (j >= d) {
      // (earlier q, later mine): A = A*Aq, B = A*Bq + B
      const float nar = ar * qar - ai * qai;
      const float nai = ar * qai + ai * qar;
      const float nbr = ar * qbr - ai * qbi + br;
      const float nbi = ar * qbi + ai * qbr + bi;
      ar = nar;
      ai = nai;
      br = nbr;
      bi = nbi;
      s_ar[j] = ar;
      s_ai[j] = ai;
      s_br[j] = br;
      s_bi[j] = bi;
    }
    __syncthreads();
  }

  // the value entering this chunk: the maps of chunks 0..j-1 applied to s
  float ur = s_r[c];
  float ui = s_i[c];
  if (j > 0) {
    const float qar = s_ar[j - 1], qai = s_ai[j - 1];
    const float qbr = s_br[j - 1], qbi = s_bi[j - 1];
    const float nur = qar * ur - qai * ui + qbr;
    const float nui = qar * ui + qai * ur + qbi;
    ur = nur;
    ui = nui;
  }

  // 3. the recurrence over the chunk
  for (long long t = t_lo; t < t_hi; ++t) {
    const float nur = pr * ur - pi * ui + f_r[t * C + c];
    const float nui = pr * ui + pi * ur + f_i[t * C + c];
    ur = nur;
    ui = nui;
    u_r[t * C + c] = ur;
    u_i[t * C + c] = ui;
  }
}

}  // namespace

// f_r, f_i [T, C], p_r, p_i, s_r, s_i [C], u_r, u_i [T, C]: contiguous
// float32 device memory. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int complex_scan_launch(const float* f_r, const float* f_i,
                                   const float* p_r, const float* p_i,
                                   const float* s_r, const float* s_i,
                                   float* u_r, float* u_i, long long T, int C,
                                   void* stream) {
  if (T <= 0 || C <= 0) return 0;
  complex_scan_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f_r, f_i, p_r, p_i, s_r, s_i, u_r, u_i, T, C);
  return static_cast<int>(cudaGetLastError());
}
