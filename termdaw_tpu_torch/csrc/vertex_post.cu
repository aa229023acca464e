// The vertex epilogue of the window program for Hopper (sm_90a): the end
// of every vertex's arm, in the reference's order ext -> angle -> gain
// (extensions.rs:262-263),
//
//     v = blend ? x + wet * (y - x) : y       an effect's wet blend
//     v = pan_on ? v * pan[c] : v              the constant-power pan
//     out[t, c] = gain_on ? v * gain : v       the gain
//
// over y, x, out [T, 2] (row-major, channel fastest). y is the arm's
// output, x its summed input (read only when it blends); wet, gain and the
// two pan factors are f32 values in device memory, resolved once when the
// graph is built (graph/compile.py: mix.pan_amps over every vertex's
// angle in one call); the three flags are decided on the host then, from
// the same f32 values and thresholds as mix.apply_angle and
// mix.apply_gain (mix.post_flags). A flag that is off skips its step, as
// those functions' torch.where selects its input.
//
// It replaces no Pallas kernel: the reference's epilogue
// (termdaw_tpu/ops/mix.py:54 `post` and the wet blend at
// termdaw_tpu/graph/compile.py:1762-1778) is jnp that XLA fuses. In
// PyTorch the same epilogue is 17 eager launches a vertex a window, 3 more
// for an effect: 13 of them recompute on one or two floats the pan and
// the skip tests, which are fixed at build, and 7 are passes over the
// whole [T, 2] window, most through the non-vectorised broadcast path,
// with both sides of each `where` computed. A 64-track mix session runs
// 356 vertices a window, so the epilogue was half of its window program's
// device nodes.
//
// What bounds it on this card: bytes. At a 384,000-frame window it reads
// y (and x when it blends) and writes out once: 9.2 MB for a blending
// vertex (2.75 us at 3.35 TB/s) and 6.1 MB otherwise (1.8 us). The f32
// work is 1 to 5 operations an element.
//
// Design: one pass, with each thread taking a 16-byte float4 of y (and of
// x) and storing one float4: two stereo frames, so the pan factors fall
// on lanes (L, R, L, R). A T that is odd leaves one frame, which the
// thread after the last float4 takes alone. Where y, x or out is not
// 16-byte aligned (a view into another tensor) every thread takes one
// float instead. The flags are kernel arguments, uniform across the grid,
// so no warp diverges on them. Each operation is rounded on its own, in
// the order above (__fsub_rn / __fmul_rn / __fadd_rn: nvcc would
// otherwise contract the blend's multiply and add into an FMA), so the
// output is the torch composition's, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Post {
  float wet, pan_l, pan_r, gain;
  int blend, pan_on, gain_on;
};

__device__ __forceinline__ float post1(float y, float x, float pan,
                                       const Post& p) {
  float v = y;
  if (p.blend) v = __fadd_rn(x, __fmul_rn(p.wet, __fsub_rn(y, x)));
  if (p.pan_on) v = __fmul_rn(v, pan);
  if (p.gain_on) v = __fmul_rn(v, p.gain);
  return v;
}

// kVec: one float4 a thread (every pointer 16-byte aligned), else one
// float. n = 2T floats.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
vertex_post_kernel(const float* __restrict__ y, const float* __restrict__ x,
                   const float* __restrict__ pan,
                   const float* __restrict__ wet,
                   const float* __restrict__ gain, int blend, int pan_on,
                   int gain_on, long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  Post p;
  p.blend = blend;
  p.pan_on = pan_on;
  p.gain_on = gain_on;
  p.wet = blend ? __ldg(wet) : 0.0f;
  p.pan_l = pan_on ? __ldg(pan) : 1.0f;
  p.pan_r = pan_on ? __ldg(pan + 1) : 1.0f;
  p.gain = gain_on ? __ldg(gain) : 1.0f;
  if (kVec) {
    const long long n4 = n >> 2;
    if (i < n4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(y) + i);
      const float4 b =
          blend ? __ldg(reinterpret_cast<const float4*>(x) + i) : a;
      float4 r;
      r.x = post1(a.x, b.x, p.pan_l, p);
      r.y = post1(a.y, b.y, p.pan_r, p);
      r.z = post1(a.z, b.z, p.pan_l, p);
      r.w = post1(a.w, b.w, p.pan_r, p);
      reinterpret_cast<float4*>(out)[i] = r;
    } else if (i == n4) {
      // an odd T's last frame: 0 or 2 floats
      for (long long e = n4 << 2; e < n; ++e) {
        out[e] = post1(y[e], blend ? x[e] : 0.0f, (e & 1) ? p.pan_r
                                                          : p.pan_l, p);
      }
    }
  } else if (i < n) {
    out[i] = post1(y[i], blend ? x[i] : 0.0f, (i & 1) ? p.pan_r : p.pan_l,
                   p);
  }
}

}  // namespace

// y, x, out: [T, 2] f32, contiguous (x may be null where it does not
// blend); pan: 2 f32, wet and gain: one f32 each, in device memory (each
// read only where its step runs). Launches on `stream` and returns
// cudaGetLastError(); nothing to do for T == 0.
extern "C" int vertex_post_launch(const float* y, const float* x,
                                  const float* pan, const float* wet,
                                  const float* gain, int blend, int pan_on,
                                  int gain_on, long long T, float* out,
                                  void* stream) {
  if (T <= 0) return 0;
  if (y == nullptr || out == nullptr || pan == nullptr || wet == nullptr ||
      gain == nullptr || (blend && x == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = 2 * T;
  uintptr_t addr = reinterpret_cast<uintptr_t>(y) |
                   reinterpret_cast<uintptr_t>(out);
  if (blend) addr |= reinterpret_cast<uintptr_t>(x);
  const bool vec = addr % 16 == 0;
  const long long items = vec ? (n >> 2) + ((n & 3) ? 1 : 0) : n;
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    vertex_post_kernel<true><<<(int)blocks, kThreads, 0, s>>>(
        y, x, pan, wet, gain, blend, pan_on, gain_on, n, out);
  } else {
    vertex_post_kernel<false><<<(int)blocks, kThreads, 0, s>>>(
        y, x, pan, wet, gain, blend, pan_on, gain_on, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
