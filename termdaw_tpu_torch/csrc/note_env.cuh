// The note arms' ADSR envelope on the device, shared by csrc/sampsyn.cu
// and csrc/synth.cu: ops/adsr.apply_ads and apply_r in the plain
// version's f32 order. Every operation is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: nvcc would otherwise
// contract a multiply and an add into an FMA); the segment clocks are
// sequential subtractions, a segment's fraction a division by its f32
// duration, and the release's clamp keeps NaN as torch.clamp does.
//
// `Env` is any struct with the envelope's constants as fields, computed
// on the host as the plain version's f32 operands: the attack, decay and
// sustain segments (base + (clock / div) * slope; `*_on` 0 where the
// segment has no length, its fraction then 0), their f32 edges a32, ad
// and ads_end and the decay's d32, the sustain and release velocities,
// the release's f32 duration (`release_on` 0 where it has none: the
// fraction is then 1).

#pragma once

// ops/adsr.apply_ads: the ADS segment of t, -1000 past the sustain window,
// and any value <= -1 read as the sustain velocity.
template <class Env>
__device__ __forceinline__ float note_ads(const Env& c, float t) {
  float v;
  if (t <= c.a32) {
    const float fr = c.att_on ? __fdiv_rn(t, c.att_div) : 0.0f;
    v = __fadd_rn(c.att_base, __fmul_rn(fr, c.att_slope));
  } else if (t <= c.ad) {
    const float fr =
        c.dec_on ? __fdiv_rn(__fsub_rn(t, c.a32), c.dec_div) : 0.0f;
    v = __fadd_rn(c.dec_base, __fmul_rn(fr, c.dec_slope));
  } else if (t <= c.ads_end) {
    const float fr =
        c.sus_on ? __fdiv_rn(__fsub_rn(__fsub_rn(t, c.a32), c.d32), c.sus_div)
                 : 0.0f;
    v = __fadd_rn(c.sus_base, __fmul_rn(fr, c.sus_slope));
  } else {
    v = -1000.0f;
  }
  return v <= -1.0f ? c.sustain_vel : v;
}

// ops/adsr.apply_r: from `from` towards the release velocity, the
// fraction t / release_sec clamped to 1 (NaN kept).
template <class Env>
__device__ __forceinline__ float note_release(const Env& c, float t,
                                              float from) {
  float fr = 1.0f;
  if (c.release_on) {
    fr = __fdiv_rn(t, c.release_div);
    fr = fr > 1.0f ? 1.0f : fr;
  }
  return __fadd_rn(from, __fmul_rn(fr, __fsub_rn(c.release_vel, from)));
}
