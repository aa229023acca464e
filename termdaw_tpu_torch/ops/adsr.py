"""ADSR envelope evaluation (piecewise-linear), on tensors and on the host.

Port of termdaw_tpu/ops/adsr.py: the 9-field configuration (adsr.rs:1-38),
its 6/9-float constructors (adsr.rs:15-30, 94-114), the four tensor
evaluators (adsr.rs:41-114)

* apply_ads   — attack/decay/sustain, holding sustain forever (adsr.rs:62-69)
* apply_r     — release from a captured value (adsr.rs:71-73)
* apply_adsr  — fixed timeline including release (adsr.rs:75-86)
* apply_r_rt  — release from the ADS value at release time (adsr.rs:89-92)

and `np_apply_ads`, which graph/bake.py uses for the release capture of
Adsr vertices. The evaluators take a float32 tensor `t` and keep the
reference's float32 arithmetic: segment edges are f32 sums, the segment
clocks sequential f32 subtractions, and a segment fraction a division by
f32(duration) (not a multiply by its reciprocal). Constant operands are
computed in numpy float32 and enter the tensor ops as floats that f32
represents exactly. Documented deviation kept: a zero-length segment
evaluates to its start velocity instead of the reference's 0/0 = NaN
(adsr.rs:47-48).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdsrConf(NamedTuple):
    """Reference adsr.rs:1-12. Plain floats — static per compiled graph."""

    std_vel: float = 0.0
    attack_sec: float = 0.0
    attack_vel: float = 0.0
    decay_sec: float = 0.0
    decay_vel: float = 0.0
    sustain_sec: float = 0.0
    sustain_vel: float = 0.0
    release_sec: float = 0.0
    release_vel: float = 0.0

    def max_vel(self) -> float:
        # reference adsr.rs:32-38
        return max(
            self.std_vel, self.attack_vel, self.decay_vel,
            self.sustain_vel, self.release_vel,
        )


def hit_conf(
    attack_sec: float, decay_sec: float, decay_vel: float,
    sustain_sec: float, sustain_vel: float, release_sec: float,
) -> AdsrConf:
    """6-float shorthand (reference adsr.rs:15-30)."""
    return AdsrConf(
        std_vel=0.0,
        attack_sec=attack_sec, attack_vel=1.0,
        decay_sec=decay_sec, decay_vel=decay_vel,
        sustain_sec=sustain_sec, sustain_vel=sustain_vel,
        release_sec=release_sec, release_vel=0.0,
    )


def build_adsr_conf(arr: list[float]) -> AdsrConf | None:
    """Accept length 0 / 6 / 9 float arrays (reference adsr.rs:94-114)."""
    if len(arr) == 0:
        return AdsrConf()
    if len(arr) == 6:
        return hit_conf(*[float(x) for x in arr])
    if len(arr) == 9:
        return AdsrConf(*[float(x) for x in arr])
    return None


def _f32(v) -> float:
    """v rounded to float32, as a Python float (exact in a float32 op)."""
    return float(np.float32(v))


def _lerp_const(a, b, t: torch.Tensor) -> torch.Tensor:
    """a + t * (b - a) for float32 constants a, b: (b - a) is an f32
    subtraction, as in the reference's jnp.float32 operands."""
    return _f32(a) + t * float(np.float32(b) - np.float32(a))


def _safe_div(num: torch.Tensor, den: float) -> torch.Tensor:
    """num / f32(den), with a zero-length segment evaluating to 0."""
    if den <= 0.0:
        return torch.zeros_like(num)
    return num / _f32(den)


def _seg_bounds(conf: AdsrConf):
    """Segment boundaries summed in f32 like the reference (adsr.rs:46-56):
    a float64 sum rounded at the comparison can land 1 ulp away and flip
    the segment of a frame whose clock hits the edge exactly."""
    a32 = np.float32(conf.attack_sec)
    d32 = np.float32(conf.decay_sec)
    s32 = np.float32(conf.sustain_sec)
    ad = np.float32(a32 + d32)
    ads_end = np.float32(ad + s32)
    return a32, ad, ads_end


def _ads_internal(conf: AdsrConf, t: torch.Tensor) -> torch.Tensor:
    """The reference's apply_ads_internal (adsr.rs:46-60): piecewise ADS
    with -1000.0 past the sustain window (callers read any value <= -1.0
    as their hold/release trigger)."""
    a32, ad, ads_end = _seg_bounds(conf)
    d32 = np.float32(conf.decay_sec)
    v_attack = _lerp_const(conf.std_vel, conf.attack_vel,
                           _safe_div(t, conf.attack_sec))
    v_decay = _lerp_const(conf.attack_vel, conf.decay_vel,
                          _safe_div(t - float(a32), conf.decay_sec))
    v_sustain = _lerp_const(
        conf.decay_vel, conf.sustain_vel,
        # sequential f32 subtractions (adsr.rs:52-56)
        _safe_div(t - float(a32) - float(d32), conf.sustain_sec),
    )
    v_hold = torch.full_like(t, -1000.0)
    return torch.where(
        t <= float(a32), v_attack,
        torch.where(t <= float(ad), v_decay,
                    torch.where(t <= float(ads_end), v_sustain, v_hold)),
    )


def apply_ads(conf: AdsrConf, t: torch.Tensor) -> torch.Tensor:
    """ADS value at time t. Any internal value <= -1.0 snaps to
    sustain_vel (adsr.rs:62-69): the hold past the sustain window and
    exotic mid-segment values reached with velocities <= -1.0."""
    v = _ads_internal(conf, t)
    return torch.where(v <= -1.0, _f32(conf.sustain_vel), v)


def _release_frac(conf: AdsrConf, rel_t: torch.Tensor) -> torch.Tensor:
    """min(rel_t / release_sec, 1); a zero release is at release_vel at
    once (the reference's t/0 = inf -> min(1) = 1)."""
    if conf.release_sec <= 0.0:
        return torch.ones_like(rel_t)
    return torch.clamp(_safe_div(rel_t, conf.release_sec), max=1.0)


def apply_r(conf: AdsrConf, t: torch.Tensor, old_val) -> torch.Tensor:
    """Release from old_val towards release_vel over release_sec."""
    frac = _release_frac(conf, t)
    return old_val + frac * (_f32(conf.release_vel) - old_val)


def apply_adsr(conf: AdsrConf, t: torch.Tensor) -> torch.Tensor:
    """Full fixed-timeline envelope incl. release (adsr.rs:75-86); the
    release branch triggers on the internal value being <= -1.0."""
    v = _ads_internal(conf, t)
    a32 = np.float32(conf.attack_sec)
    d32 = np.float32(conf.decay_sec)
    s32 = np.float32(conf.sustain_sec)
    # sequential f32 subtractions (adsr.rs:79-84)
    frac = _release_frac(conf, t - float(a32) - float(d32) - float(s32))
    v_rel = _lerp_const(conf.sustain_vel, conf.release_vel, frac)
    return torch.where(v <= -1.0, v_rel, v)


def apply_r_rt(conf: AdsrConf, t: torch.Tensor,
               rt: torch.Tensor) -> torch.Tensor:
    """Release from the ADS value sampled at release time rt (adsr.rs:89-92)."""
    return apply_r(conf, t, apply_ads(conf, rt))


# -- numpy evaluator (host side: the bake's release capture) ----------------

def np_apply_ads(conf: AdsrConf, t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, np.float32)
    a, d, s = conf.attack_sec, conf.decay_sec, conf.sustain_sec

    def seg(t0, dur, v0, v1, tt):
        if dur <= 0:
            return np.float32(v0)
        return np.float32(v0) + (tt - t0) / np.float32(dur) * np.float32(v1 - v0)

    flat = t.reshape(-1)
    res = np.empty_like(flat)
    for i, tt in enumerate(flat):
        if tt <= a:
            v = seg(0, a, conf.std_vel, conf.attack_vel, tt)
        elif tt <= a + d:
            v = seg(a, d, conf.attack_vel, conf.decay_vel, tt)
        elif tt <= a + d + s:
            v = seg(a + d, s, conf.decay_vel, conf.sustain_vel, tt)
        else:
            v = np.float32(-1000.0)
        # the reference's apply_ads clamp (adsr.rs:62-69): any internal
        # value <= -1.0 (incl. the -1000 past-window sentinel) snaps to
        # sustain_vel
        res[i] = conf.sustain_vel if v <= -1.0 else v
    return res.reshape(t.shape)
