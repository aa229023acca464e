// The Synth's arm of the window program for Hopper (sm_90a): the
// three-oscillator synth over a window of nb blocks of bl frames,
//
//     out[k*bl + i, 0] = out[k*bl + i, 1]
//         = sum_{p < P, slot p of block k alive at frame k*bl + i}
//           amp * sum_{oscillator o on} osc_o(t * hz) * vel * env_o * vol_o
//
// with the note fields, the three ADSR envelopes, the square and top-flat
// sines, the triangle and the sum over slots of ops/synthv.synth_plain
// (t the window's time2d, the reference's global_frame / sr). It replaces
// no Pallas kernel: the reference's Synth arm (termdaw_tpu/ops/synthv.py
// `synth`) is plain jnp that XLA fuses. In PyTorch the same arm is about
// 280 eager ops a window over [nb, bl, P] tensors (the note fields'
// gathers and masks, two Cody-Waite reductions and sines, three
// envelopes' selects, the oscillators' products, the sum over slots),
// which write and read back about 17 GB of intermediates at an
// instrument session's window (nb 375, bl 1024, P 32: 49 MB a tensor).
//
// What bounds it on this card: f32 operations and the sine. It reads the
// window's frames (int64), time2d [nb, bl], the in-block clock ib [bl]
// and the bake's slot table and note columns, and writes [nb*bl, 2] f32:
// about 8 MB at that window, 2.4 us at 3.35 TB/s. The plain version's
// 59 f32 operations a slot-frame with all three oscillators on
// (ops/synthv.SYNTH_FLOPS and SYNTH_OSC_FLOPS, a sine counted as one)
// come to 11 us at 67 TFLOP/s, and a sinf is some twenty instructions.
//
// Design: as csrc/sampsyn.cu, the [nb, bl, P] intermediates never exist.
// A CTA of kThreads threads takes up to kTileFrames frames of one audio
// block, kFrames a thread (frames i, i + kThreads, ...), and keeps their
// sums in registers. It stages its block's slots kSlots at a time in
// shared memory: each slot's on, off and removal frames, velocity,
// pitch, the block's envelope clocks, the release clock and each
// envelope's value at it (the release starts from it); an empty slot
// (-1) is marked and skipped. What the arm's constants show is used to
// do less: an oscillator whose volume is <= 0 is left out, as the plain
// version leaves it out; the square and the top-flat take the same sine
// of t * hz * 2pi, computed once; an oscillator whose envelope constants
// equal an earlier one's takes its value (an instrument session's three
// oscillators share one ADSR, so it is computed once). All of these are
// uniform across the grid, so no warp diverges on them.
//
// Arithmetic: every f32 operation is rounded on its own in the plain
// version's order (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: nvcc
// would otherwise contract a multiply and an add into an FMA); the
// envelope is csrc/note_env.cuh's, which csrc/sampsyn.cu shares. The
// sine is ops/osc.sin_f32's: k = rintf(x / 2pi) (round half to even, as
// torch.round), the three-term Cody-Waite residue, and sinf of it, or
// sinf(x) itself where |x| >= 4e5. sinf, not __sinf: no fast-math
// intrinsic, since the arguments reach 1e5 rad, where __sinf's own
// reduction is wrong. Each slot's value is then the plain version's on
// this card; only the sum over slots differs, summed here in slot order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "note_env.cuh"

// One oscillator's ADSR, as the plain version's f32 operands (see
// note_env.cuh; kernels.SynthEnv mirrors it).
struct SynthEnv {
  float att_base, att_slope, att_div;
  float dec_base, dec_slope, dec_div;
  float sus_base, sus_slope, sus_div;
  float a32, d32, ad, ads_end;
  float sustain_vel;
  float release_vel, release_div;
  int att_on, dec_on, sus_on, release_on;
};

// The arm's constants, computed on the host (kernels.SynthParams mirrors
// it). Oscillator 0 is the square, 1 the top-flat, 2 the triangle.
struct SynthParams {
  SynthEnv env[3];
  int on[3];      // 1: volume > 0
  int env_of[3];  // the first oscillator on whose envelope equals this one's
  float vol[3];
  // the shapes' f32 constants: z, 1/z, (1-z)/2, 2/(1+z); the square reads
  // z and 1/z, the top-flat z, (1-z)/2 and 2/(1+z), the triangle none
  float z[3], inv_z[3], half_1mz[3], two_1pz[3];
  float amp;  // f32(1 / sum(vol * max_vel)), or 0
  // ops/osc.sin_f32's: f32(1/2pi), 2pi = hi + mid + lo, the reduction's
  // bound, and f32(2pi)
  float inv_2pi, pi2_hi, pi2_mid, pi2_lo, reduce_max, two_pi;
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
  float vel, hz, ads0, rel0, rel_t;
  float rel_v[3];  // each envelope at rel_t, where its release starts
  int live;        // 0: an empty slot
};

// ops/osc.sin_f32: sin of x reduced by 2pi in three terms, or of x itself
// past the reduction's exact range.
__device__ __forceinline__ float sin_f32(const SynthParams& c, float x) {
  const float k = rintf(__fmul_rn(x, c.inv_2pi));
  float r = __fsub_rn(x, __fmul_rn(k, c.pi2_hi));
  r = __fsub_rn(r, __fmul_rn(k, c.pi2_mid));
  r = __fsub_rn(r, __fmul_rn(k, c.pi2_lo));
  return sinf(fabsf(x) < c.reduce_max ? r : x);
}

// torch.clamp's bounds, which keep NaN (fminf and fmaxf drop it).
__device__ __forceinline__ float at_least(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float at_most(float v, float hi) {
  return v > hi ? hi : v;
}

// One oscillator's envelope at a frame: held, or released from its value
// at the release clock.
__device__ __forceinline__ float envelope(const SynthEnv& e, bool held,
                                          float ads_t, float rel_el,
                                          float rel_v) {
  return held ? note_ads(e, ads_t) : note_release(e, rel_el, rel_v);
}

// osc * vel * env * vol, in the plain version's order.
__device__ __forceinline__ float voice(float osc, float vel, float env,
                                       float vol) {
  return __fmul_rn(__fmul_rn(__fmul_rn(osc, vel), env), vol);
}

// The mono sum of a window's Synth slots, written as stereo pairs. CTA b
// takes audio block b / tiles, frames (b % tiles) * kTileFrames on.
__global__ void __launch_bounds__(kThreads)
synth_kernel(const long long* __restrict__ frames,
             const float* __restrict__ time2d, const float* __restrict__ ib,
             const int* __restrict__ idx, const int* __restrict__ on_f,
             const int* __restrict__ off_f, const int* __restrict__ dead_f,
             const float* __restrict__ vels, const float* __restrict__ hz,
             const float* __restrict__ rel_t,
             const float* __restrict__ env_ads0,
             const float* __restrict__ env_rel0, int bl, int P, int N,
             const SynthParams c, float* __restrict__ out) {
  __shared__ Slot s_slot[kSlots];
  const int tiles = (bl + kTileFrames - 1) / kTileFrames;
  const long long blk = blockIdx.x / tiles;
  const int i0 = (int)(blockIdx.x % tiles) * kTileFrames + threadIdx.x;
  long long f[kFrames];
  float tv[kFrames], ibv[kFrames], acc[kFrames];
#pragma unroll
  for (int r = 0; r < kFrames; ++r) {
    const int i = i0 + r * kThreads;
    f[r] = i < bl ? __ldg(frames + blk * bl + i) : 0;
    tv[r] = i < bl ? __ldg(time2d + blk * bl + i) : 0.0f;
    ibv[r] = i < bl ? __ldg(ib + i) : 0.0f;
    acc[r] = 0.0f;
  }
  const bool sine = c.on[0] || c.on[1];
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
        s.hz = __ldg(hz + q);
        s.ads0 = __ldg(env_ads0 + blk * N + q);
        s.rel0 = __ldg(env_rel0 + blk * N + q);
        s.rel_t = __ldg(rel_t + q);
#pragma unroll
        for (int o = 0; o < 3; ++o)
          if (c.on[o] && c.env_of[o] == o)
            s.rel_v[o] = note_ads(c.env[o], s.rel_t);
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
        const float ads_t = __fadd_rn(s.ads0, ibv[r]);
        const float rel_el = __fadd_rn(s.rel0, ibv[r]);
        const bool held = s.off == kSentinel || fr < s.off;
        const float th = __fmul_rn(tv[r], s.hz);
        const float sn = sine ? sin_f32(c, __fmul_rn(th, c.two_pi)) : 0.0f;
        float e0 = 0.0f, e1 = 0.0f, sum = 0.0f;
        if (c.on[0]) {
          e0 = envelope(c.env[0], held, ads_t, rel_el, s.rel_v[0]);
          const float sq =
              __fmul_rn(at_most(at_least(sn, -c.z[0]), c.z[0]), c.inv_z[0]);
          sum = __fadd_rn(sum, voice(sq, s.vel, e0, c.vol[0]));
        }
        if (c.on[1]) {
          e1 = c.env_of[1] == 0
                   ? e0
                   : envelope(c.env[1], held, ads_t, rel_el, s.rel_v[1]);
          const float tf = __fmul_rn(
              __fadd_rn(at_most(sn, c.z[1]), c.half_1mz[1]), c.two_1pz[1]);
          sum = __fadd_rn(sum, voice(tf, s.vel, e1, c.vol[1]));
        }
        if (c.on[2]) {
          const float e2 =
              c.env_of[2] == 0   ? e0
              : c.env_of[2] == 1 ? e1
                                 : envelope(c.env[2], held, ads_t, rel_el,
                                            s.rel_v[2]);
          const float tri = __fsub_rn(
              __fmul_rn(4.0f, fabsf(__fsub_rn(th, floorf(__fadd_rn(
                                                      th, 0.5f))))),
              1.0f);
          sum = __fadd_rn(sum, voice(tri, s.vel, e2, c.vol[2]));
        }
        acc[r] = __fadd_rn(acc[r], __fmul_rn(sum, c.amp));
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

// frames [nb*bl] int64, time2d [nb, bl], ib [bl], idx [nb, P] int32,
// on_f/off_f/dead_f [N] int32, vels/hz/rel_t [N], env_ads0/env_rel0
// [nb, N], out [nb*bl, 2], all contiguous device memory (f32 where not
// said); params in host memory, read before this returns. Launches on
// `stream` and returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int synth_launch(const long long* frames, const float* time2d,
                            const float* ib, const int* idx, const int* on_f,
                            const int* off_f, const int* dead_f,
                            const float* vels, const float* hz,
                            const float* rel_t, const float* env_ads0,
                            const float* env_rel0, int nb, int bl, int P,
                            int N, const SynthParams* params, float* out,
                            void* stream) {
  if (nb <= 0 || bl <= 0) return 0;
  if (P < 0 || N < 1 || params == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (bl + kTileFrames - 1) / kTileFrames;
  if (nb * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  synth_kernel<<<(int)(nb * tiles), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      frames, time2d, ib, idx, on_f, off_f, dead_f, vels, hz, rel_t,
      env_ads0, env_rel0, bl, P, N, *params, out);
  return static_cast<int>(cudaGetLastError());
}
