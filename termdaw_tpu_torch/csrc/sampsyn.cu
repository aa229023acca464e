// SampSyn's arm of the window program for Hopper (sm_90a): the
// time-varying wavetable synth over a window of nb blocks of bl frames,
//
//     out[k*bl + i, 0] = out[k*bl + i, 1]
//         = sum_{p < P, slot p of block k alive at frame k*bl + i}
//           wave(p, i) * vel * env(p, i) * amp
//
// with the note fields, the ADSR envelope, the table clock, the uint32
// fixed-point phase, the snapshot search and blend, and the sum over
// slots of ops/synthv.sampsyn_plain. It replaces no Pallas kernel: the
// reference's SampSyn arm (termdaw_tpu/ops/synthv.py `sampsyn`) is plain
// jnp that XLA fuses. In PyTorch the same arm is about 150 eager ops a
// window over [nb, bl, P] tensors (int64 phase arithmetic, two element
// gathers of the snapshot times, a searchsorted, a row gather of 16-byte
// rows from a [K*W, 4] table that PyTorch's vectorized gather runs far
// below bandwidth, the envelope's selects, the sum over slots), which
// write and read back about 2.7 GB of intermediates a c4 window.
//
// What bounds it on this card: bytes. It reads the window's frames
// (int64), the in-block clock ib [bl], the bake's [nb, P] slot table and
// per-note columns, and the wavetable, and writes [nb*bl, 2] f32: about
// 6 MB a c4 window (nb 375, bl 1024, P 8), under 2 us at 3.35 TB/s. The
// arithmetic, about 28 f32 operations a slot-frame, is of the same order
// at the f32 peak.
//
// Design: the [nb, bl, P] intermediates never exist. A CTA of kThreads
// threads takes up to kTileFrames frames of one audio block, kFrames a
// thread (frames i, i + kThreads, ...), and keeps their sums in
// registers. It stages its block's slots kSlots at a time in shared
// memory: each slot's note fields (on, off and removal frames, velocity,
// the block's envelope clocks, the release clock), its phase increment
// as uint32 fixed point, and the envelope's value at release time (the
// release starts from it); an empty slot (-1) is marked and skipped. The
// wavetable, of any size, is read through the read-only cache: staging
// c4's 2 x 2048 snapshots (16 KB) in shared memory first did not pay at
// this CTA shape (24.5 us a c4 window against 22.8 on an H100). The
// snapshot search is a walk over the K times, which K = 1 skips with the
// blend.
//
// Arithmetic: the phase is native uint32, n * c_fix mod 2^32 with c_fix
// the low 32 bits of trunc(cyc * 2^32), the value the plain version's
// int64 & 0xFFFFFFFF path gives. Every f32 operation is rounded on its
// own in the plain version's order (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn: nvcc would otherwise contract a multiply and an add into an
// FMA); the envelope is csrc/note_env.cuh's, which csrc/synth.cu shares;
// clamps keep NaN as torch.clamp does. Only the sum over slots differs,
// summed here in slot order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "note_env.cuh"

// The envelope's and the table's constants, computed on the host as the
// plain version's f32 operands (kernels.SampSynParams mirrors it).
struct SampSynParams {
  // the attack, decay and sustain segments: base + (clock / div) * slope
  float att_base, att_slope, att_div;
  float dec_base, dec_slope, dec_div;
  float sus_base, sus_slope, sus_div;
  float a32, d32, ad, ads_end;  // attack, decay; the segments' f32 edges
  float sustain_vel;
  float release_vel, release_div;
  float amp;     // f32(1 / max_vel), or 0
  float wscale;  // W / 2^32
  int att_on, dec_on, sus_on;  // 0: a zero-length segment (fraction 0)
  int release_on;              // 0: no release time (fraction 1)
};

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 4;  // frames a thread
constexpr int kTileFrames = kThreads * kFrames;
constexpr int kSlots = 64;  // slots staged at once
constexpr int kSentinel = -(1 << 30);  // graph/bake.py SENTINEL: no note-off

// One slot of the CTA's block.
struct Slot {
  int on, off, dead;
  uint32_t c_fix;  // the phase increment a frame, uint32 fixed point
  float vel, ads0, rel0, rel_t;
  float rel_v;  // the ADS envelope at rel_t, where the release starts
  int live;     // 0: an empty slot
};

// The mono sum of a window's SampSyn slots, written as stereo pairs. CTA
// b takes audio block b / tiles, frames (b % tiles) * kTileFrames on.
__global__ void __launch_bounds__(kThreads)
sampsyn_kernel(const long long* __restrict__ frames,
               const float* __restrict__ ib, const int* __restrict__ idx,
               const int* __restrict__ on_f, const int* __restrict__ off_f,
               const int* __restrict__ dead_f, const float* __restrict__ vels,
               const float* __restrict__ cyc, const float* __restrict__ rel_t,
               const float* __restrict__ env_ads0,
               const float* __restrict__ env_rel0,
               const float* __restrict__ times,
               const float* __restrict__ waves, int bl, int P, int N, int K,
               int W, const SampSynParams c, float* __restrict__ out) {
  __shared__ Slot s_slot[kSlots];
  const int tiles = (bl + kTileFrames - 1) / kTileFrames;
  const long long blk = blockIdx.x / tiles;
  const int i0 = (int)(blockIdx.x % tiles) * kTileFrames + threadIdx.x;
  long long f[kFrames];
  float ibv[kFrames], acc[kFrames];
#pragma unroll
  for (int r = 0; r < kFrames; ++r) {
    const int i = i0 + r * kThreads;
    f[r] = i < bl ? __ldg(frames + blk * bl + i) : 0;
    ibv[r] = i < bl ? __ldg(ib + i) : 0.0f;
    acc[r] = 0.0f;
  }
  for (int p0 = 0; p0 < P; p0 += kSlots) {
    const int n = min(kSlots, P - p0);
    __syncthreads();  // the last chunk read
    if (threadIdx.x < n) {
      const int q = __ldg(idx + blk * P + p0 + threadIdx.x);
      Slot s{};
      s.live = q >= 0;
      if (s.live) {
        s.on = __ldg(on_f + q);
        s.off = __ldg(off_f + q);
        s.dead = __ldg(dead_f + q);
        s.vel = __ldg(vels + q);
        const float cs = __fmul_rn(__ldg(cyc + q), 4294967296.0f);
        s.c_fix = (uint32_t)(unsigned long long)(long long)cs;
        s.ads0 = __ldg(env_ads0 + blk * N + q);
        s.rel0 = __ldg(env_rel0 + blk * N + q);
        s.rel_t = __ldg(rel_t + q);
        s.rel_v = note_ads(c, s.rel_t);
      }
      s_slot[threadIdx.x] = s;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const Slot s = s_slot[j];
      if (!s.live) continue;
#pragma unroll
      for (int r = 0; r < kFrames; ++r) {
        const long long fr = f[r];
        if (i0 + r * kThreads >= bl || fr < s.on || fr >= s.dead) continue;
        // the envelope and the table clock: ~time since note-on
        const float ads_t = __fadd_rn(s.ads0, ibv[r]);
        const float rel_el = __fadd_rn(s.rel0, ibv[r]);
        float env, tau;
        if (s.off == kSentinel || fr < s.off) {  // held at this frame
          env = note_ads(c, ads_t);
          tau = ads_t;
        } else {
          env = note_release(c, rel_el, s.rel_v);
          tau = __fadd_rn(rel_el, s.rel_t);
        }
        // the snapshots around tau: searchsorted(right) - 1 in [0, K-2]
        int k = 0;
        float blend = 0.0f;
        if (K > 1) {
          int above = 0;
          while (above < K && !(__ldg(times + above) > tau)) ++above;
          k = min(max(above - 1, 0), K - 2);
          const float tk = __ldg(times + k);
          float span = __fsub_rn(__ldg(times + k + 1), tk);
          span = span < 1e-9f ? 1e-9f : span;
          blend = __fdiv_rn(__fsub_rn(tau, tk), span);
          blend = blend < 0.0f ? 0.0f : (blend > 1.0f ? 1.0f : blend);
        }
        // the fixed-point phase and its two table points
        const uint32_t phase_fix = ((uint32_t)fr - (uint32_t)s.on) * s.c_fix;
        const float phase = __fmul_rn(__uint2float_rn(phase_fix), c.wscale);
        const float pf = floorf(phase);
        const float frac = __fsub_rn(phase, pf);
        const int p = min(max((int)pf, 0), W - 1);
        const int pn = p + 1 == W ? 0 : p + 1;
        const float* w = waves + k * W;
        const float keep = __fsub_rn(1.0f, frac);
        float wave = __fadd_rn(__fmul_rn(__ldg(w + p), keep),
                               __fmul_rn(__ldg(w + pn), frac));
        if (K > 1) {
          const float* w1 = w + W;
          const float wave1 = __fadd_rn(__fmul_rn(__ldg(w1 + p), keep),
                                        __fmul_rn(__ldg(w1 + pn), frac));
          wave = __fadd_rn(__fmul_rn(wave, __fsub_rn(1.0f, blend)),
                           __fmul_rn(wave1, blend));
        }
        const float v =
            __fmul_rn(__fmul_rn(__fmul_rn(wave, s.vel), env), c.amp);
        acc[r] = __fadd_rn(acc[r], v);
      }
    }
  }
  float2* o = reinterpret_cast<float2*>(out) + blk * bl;
#pragma unroll
  for (int r = 0; r < kFrames; ++r) {
    const int i = i0 + r * kThreads;
    if (i < bl) o[i] = make_float2(acc[r], acc[r]);
  }
}

}  // namespace

// frames [nb*bl] int64, ib [bl], idx [nb, P] int32, on_f/off_f/dead_f [N]
// int32, vels/cyc/rel_t [N], env_ads0/env_rel0 [nb, N], times [K],
// waves [K, W], out [nb*bl, 2], all contiguous device memory (f32 where
// not said); params in host memory, read before this returns. Launches
// on `stream` and returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int sampsyn_launch(const long long* frames, const float* ib,
                              const int* idx, const int* on_f,
                              const int* off_f, const int* dead_f,
                              const float* vels, const float* cyc,
                              const float* rel_t, const float* env_ads0,
                              const float* env_rel0, const float* times,
                              const float* waves, int nb, int bl, int P,
                              int N, int K, int W,
                              const SampSynParams* params, float* out,
                              void* stream) {
  if (nb <= 0 || bl <= 0) return 0;
  if (P < 0 || N < 1 || K < 1 || W < 1 || params == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (bl + kTileFrames - 1) / kTileFrames;
  if (nb * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  sampsyn_kernel<<<(int)(nb * tiles), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      frames, ib, idx, on_f, off_f, dead_f, vels, cyc, rel_t, env_ads0,
      env_rel0, times, waves, bl, P, N, K, W, *params, out);
  return static_cast<int>(cudaGetLastError());
}
