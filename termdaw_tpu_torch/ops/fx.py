"""Native effect plugins: the first-party effect suite behind `load_lv2`.

Port of termdaw_tpu/ops/fx.py. The registry data is carried over
unchanged: the defaults, the static params, the URI hints
(fx.py:556-567) and the parameter aliases (fx.py:570-583). Every effect is
timeline-parallel, as in the reference:

* reverb: one-pole input damping, 16 parallel feedback combs (mono lines,
  L/R interleaved tunings) and 4 series allpasses; each line's
  y[t] = g*y[t-D] + x'[t] splits into D first-order recurrences over the
  residue classes mod D, one ops/scan.affine_scan over [rows, D*C];
* chorus, flanger: LFO-modulated fractional-delay reads (gathers);
* compressor: peak follower ops/scan.max_decay_scan, attack smoothing
  ops/scan.affine_scan, soft-knee gain computer elementwise;
* tape: tanh saturation and a one-pole low-pass (affine_scan);
* delay: one feedback comb (the residue-class scan);
* bitcrush: elementwise;
* eq3: Linkwitz-Riley 4th-order tree crossovers from biquads
  (ops/filters.biquad_apply, ops/scan.complex_affine_scan).

`params` hold the traced params as 0-d float32 tensors on the device, so
expressions such as exp(-1/(release*0.001*sr)) run in float32 in the
reference's order. Static params (delay-line lengths, eq crossovers) are
host floats bound at graph build; biquad coefficients are host doubles
cast to float32 once.

States are dicts of device tensors (delay tails, scan carries; tuples of
them for the reverb's lines), so windows chain exactly.

Every `process` takes an optional `mesh` (parallel/mesh.py; the
reference's `axis_name`): x is then this rank's slice of the window and
the returned state is the global stream's, equal on every rank. The scans
seed from ops/filters.exclusive_total (`max_decay_scan_sharded`,
fx.py:71-89; `first_order_scan`; `feedback_line` per residue class,
fx.py:128-149), the delayed reads take their halo from
ops/filters.prev_frames, the LFOs start at this rank's global frame
(`_local_phase`, fx.py:287-306) and the eq3's biquads run sharded
(ops/filters.biquad_apply). Bitcrush is elementwise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import Mesh
from .filters import (
    biquad_apply, biquad_coefs, biquad_init_state, exclusive_total,
    first_order_scan, lanes, prev_frames,
)
from .scan import (
    MAX_DECAY_IDENTITY, _affine, _max_decay, affine_scan, max_decay_scan,
    max_decay_summary,
)

F32 = torch.float32


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-d f32 tensor on like's device. Dividing by it is a true
    f32 division on every device (CUDA divides by a Python scalar as a
    multiplication by its f32 reciprocal)."""
    return torch.full((), float(v), dtype=F32, device=like.device)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def max_decay_scan_sharded(x: torch.Tensor, r: torch.Tensor,
                           y0: torch.Tensor, mesh: Mesh | None):
    """y = max(x, r*y_prev) over x [T, C] with y[-1] = y0 [C], r [C]:
    (y, the global stream's last y), fx.py:71-89. Under a mesh the seed
    entering this rank's rows is the earlier ranks' fold applied to y0."""
    if mesh is None:
        y = max_decay_scan(x, r, y0)
        return y, y[-1]
    (a_pre, b_pre), (a_tot, b_tot) = exclusive_total(
        _max_decay, (1.0, MAX_DECAY_IDENTITY), max_decay_summary(x, r), mesh)
    y0d = y0.double()
    y = max_decay_scan(x, r, torch.maximum(b_pre, a_pre * y0d).float())
    return y, torch.maximum(b_tot, a_tot * y0d).float()


def feedback_line(x: torch.Tensor, tail: torch.Tensor, g, D: int,
                  mesh: Mesh | None = None):
    """y[t] = x[t] + g * y[t-D] over a window, with y[-D:] given by `tail`.

    x [T, C], tail [D, C] -> (y [T, C], new_tail [D, C]). The D residue
    classes mod D are independent first-order recurrences: x padded to
    [rows, D*C] rows is one affine_scan with a = g on every lane and
    y[-1] = tail (fx.py:96-126).

    Under a mesh (fx.py:128-149) x is rank i's slice of the global window
    and its position q has the class (i*T + q) mod D, so x sits at the
    offset o = (i*T) mod D of the padded rows. The reference pads with
    identity maps (a = 1, b = 0); the kernel takes one `a` a lane, so here
    every cell has a = g and: the fold's B of each class is read at its
    last real row of a launch from y = 0 (the leading pad cells hold b = 0
    and leave B as it is), its A is g^(real rows) in float64, and in the
    seeded launch a class c < o starts from 0 with its seed in b of its pad
    cell, the others from their seed."""
    T, C = x.shape
    gl = lanes(g, D * C, x.device)
    if mesh is None:
        rows = -(-T // D)
        pad = rows * D - T
        xp = torch.cat([x, x.new_zeros(pad, C)]) if pad else x
        y = affine_scan(xp.reshape(rows, D * C).contiguous(), gl,
                        tail.reshape(D * C).contiguous())
        y = y.reshape(rows * D, C)[:T]
        new_tail = torch.cat([tail, y])[T:T + D]
        return y, new_tail

    o = (mesh.rank * T) % D
    rows = -(-(o + T) // D)
    after = x.new_zeros(rows * D - o - T, C)
    # each class's real cells (o <= cell < o + T): count and last row
    # (device arithmetic: no host copy, no sync)
    c = torch.arange(D, device=x.device)
    first = c + D * (c < o)
    last = (o + T - 1) - torch.remainder(o + T - 1 - c, D)
    n_real = torch.clamp((last - first) // D + 1, min=0)
    last_row = torch.clamp(last, min=0) // D

    y_id = affine_scan(
        torch.cat([x.new_zeros(o, C), x, after]).reshape(rows, D * C),
        gl, torch.zeros_like(gl)).reshape(rows, D, C)
    B = torch.where((n_real > 0)[:, None], y_id[last_row, c], 0.0)
    A = gl.double().reshape(D, C) ** n_real[:, None]
    (a_pre, b_pre), (a_tot, b_tot) = exclusive_total(
        _affine, (1.0, 0.0), (A, B), mesh)
    tail64 = tail.double()
    seed = (a_pre * tail64 + b_pre).float()  # [D, C] a class
    y = affine_scan(
        torch.cat([seed[:o], x, after]).reshape(rows, D * C),
        gl, torch.cat([seed.new_zeros(o, C), seed[o:]]).reshape(D * C),
    ).reshape(rows * D, C)[o:o + T]
    yfin = (a_tot * tail64 + b_tot).float()  # each class's last value
    new_tail = yfin[torch.remainder(mesh.size * T + c, D)]
    return y, new_tail


def delayed_read(x: torch.Tensor, tail: torch.Tensor,
                 delay: torch.Tensor) -> torch.Tensor:
    """Read x[t - delay[t]] with linear interpolation; `tail` is the last
    M input samples of the previous window. delay in samples, <= M."""
    M = tail.shape[0]
    xcat = torch.cat([tail, x])  # [M+T, C]
    t = torch.arange(x.shape[0], dtype=F32, device=x.device) + M
    pos = t - delay
    p0 = torch.floor(pos).to(torch.int32)
    frac = (pos - p0.to(F32))[:, None]
    p0 = torch.clamp(p0, 0, xcat.shape[0] - 2).long()
    return xcat[p0] * (1 - frac) + xcat[p0 + 1] * frac


def _lfo_sin(phase: torch.Tensor) -> torch.Tensor:
    """sin of an f32 LFO phase, taken in float64 and rounded to f32: the
    correctly rounded f32 sine on every device. torch's f32 sin differs
    by an ulp between the CPU and CUDA on many phases, and a delayed read
    amplifies a one-ulp step of its position by the signal's slope."""
    return torch.sin(phase.double()).float()


def _local_phase(ph0: torch.Tensor, rate: torch.Tensor, T: int, sr: int,
                 mesh: Mesh | None = None):
    """LFO phase of every frame (radians) and the next window's start
    phase, wrapped to [0, 2*pi) so an f32 clock never loses resolution
    (fx.py:287-306). Under a mesh rank i starts at ph0 + w*(i*T) and the
    next window at ph0 + w*(n*T), in the reference's f32 operations."""
    w = 2.0 * math.pi * rate / _const(sr, rate)  # rad per frame
    if mesh is None:
        base = ph0
        ph_next = ph0 + w * float(T)
    else:
        base = ph0 + w * (_const(mesh.rank, rate) * _const(T, rate))
        ph_next = ph0 + w * _const(mesh.size * T, rate)
    return base + w * torch.arange(T, dtype=F32, device=rate.device), \
        torch.remainder(ph_next, 2.0 * math.pi)


# ---------------------------------------------------------------------------
# reverb
# ---------------------------------------------------------------------------

# classic comb/allpass tunings (public Freeverb constants), at 44.1 kHz
_COMB_TUNING = [1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617]
_ALLPASS_TUNING = [556, 441, 341, 225]
_STEREO_SPREAD = 23


def _scaled(d: int, sr: int) -> int:
    return max(2, int(round(d * sr / 44100.0)))


@dataclass(frozen=True)
class EffectDef:
    kind: str
    defaults: dict
    init_state: Callable  # (sr, static, device) -> state dict
    # (x, state, params, sr, static, mesh=None) -> (y, state')
    process: Callable
    # parameter names bound at graph build (host floats: delay-line
    # lengths, biquad coefficients); changing one rebuilds the graph at
    # refresh. All other params are 0-d device tensors each window.
    static_params: tuple = ()


def static_values(eff: EffectDef, params: dict) -> dict:
    """The static (graph-build-time) parameter values for an effect."""
    return {k: float(params.get(k, eff.defaults[k]))
            for k in eff.static_params}


def bind_static(eff: EffectDef, sr: int, static: dict,
                device: torch.device) -> dict:
    """An effect's static values with the device constants derived from
    them (the eq3's biquad coefficients, key "coefs"), uploaded once for
    every window a graph renders: a captured window program may not
    upload."""
    out = dict(static)
    if eff.kind == "eq3":
        out["coefs"] = _eq3_coefs(sr, *_eq3_freqs(sr, static), device)
    return out


def _reverb_lines(sr: int) -> tuple[list[int], list[int]]:
    combs = []
    for d in _COMB_TUNING:
        combs.append(_scaled(d, sr))
        combs.append(_scaled(d + _STEREO_SPREAD, sr))
    allp = [_scaled(d, sr) for d in _ALLPASS_TUNING]
    return combs, allp


def _zeros(device, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=F32, device=device)


def _reverb_init(sr: int, static: dict, device) -> dict:
    combs, allp = _reverb_lines(sr)
    return {
        # combs are mono lines (L/R interleaved in `combs`): tails [d, 1]
        "comb_tails": tuple(_zeros(device, d, 1) for d in combs),
        "ap_x_tails": tuple(_zeros(device, d, 2) for d in allp),
        "ap_y_tails": tuple(_zeros(device, d, 2) for d in allp),
        "damp_y0": _zeros(device, 2),
    }


def _reverb_process(x, state, params, sr, static, mesh=None):
    combs, allp = _reverb_lines(sr)
    room = torch.clamp(params["room"], 0.0, 0.98)
    damp = torch.clamp(params["damp"], 0.0, 1.0)
    # input damping: one-pole lowpass, coefficient from damp
    a = damp * 0.8
    xin = x * 0.25
    b = (1.0 - a) * xin
    damped, new_damp_y0 = first_order_scan(b, a, state["damp_y0"], mesh)

    acc = torch.zeros_like(x)
    new_comb_tails = []
    for i, d in enumerate(combs):
        # per-comb feedback slightly varied for density
        g = room * (0.94 + 0.06 * (i % 3) / 2.0)
        # L combs feed L, R combs feed R: each comb is a mono line
        ch = i % 2
        y, tail = feedback_line(damped[:, ch:ch + 1], state["comb_tails"][i],
                                g, d, mesh)
        new_comb_tails.append(tail)
        acc[:, ch] += y[:, 0]

    out = acc
    new_ap_x = []
    new_ap_y = []
    for i, d in enumerate(allp):
        # allpass: y[t] = g*y[t-D] + x[t-D] - g*x[t]
        gap = 0.5
        T = out.shape[0]
        halo, x_tail = prev_frames(out, state["ap_x_tails"][i], mesh)
        xd = torch.cat([halo, out])[:T]  # x[t - D]
        u = xd - gap * out
        y, ytail = feedback_line(u, state["ap_y_tails"][i], gap, d, mesh)
        new_ap_x.append(x_tail)
        new_ap_y.append(ytail)
        out = y
    return out, {
        "comb_tails": tuple(new_comb_tails),
        "ap_x_tails": tuple(new_ap_x),
        "ap_y_tails": tuple(new_ap_y),
        "damp_y0": new_damp_y0,
    }


# ---------------------------------------------------------------------------
# chorus
# ---------------------------------------------------------------------------

_CHORUS_MAX_DELAY_MS = 40.0


def _chorus_init(sr: int, static: dict, device) -> dict:
    m = int(_CHORUS_MAX_DELAY_MS / 1000.0 * sr) + 4
    return {"tail": _zeros(device, m, 2), "phase": _zeros(device)}


def _chorus_process(x, state, params, sr, static, mesh=None):
    rate = torch.clamp(params["rate"], 0.01, 20.0)
    depth_ms = torch.clamp(params["depth"], 0.0, 15.0)
    base_ms = torch.clamp(params["base"], 1.0, 20.0)
    voices = 3
    T = x.shape[0]
    phase, ph_next = _local_phase(state["phase"], rate, T, sr, mesh)
    halo, new_tail = prev_frames(x, state["tail"], mesh)
    out = torch.zeros_like(x)
    for v in range(voices):
        ph = 2.0 * math.pi * (v / voices)
        lfo = _lfo_sin(phase + ph)
        delay = (base_ms + depth_ms * (0.5 + 0.5 * lfo)) * (sr / 1000.0)
        out = out + delayed_read(x, halo, delay)
    out = out / _const(voices, out)
    return out, {"tail": new_tail, "phase": ph_next}


# ---------------------------------------------------------------------------
# compressor
# ---------------------------------------------------------------------------

def _comp_init(sr: int, static: dict, device) -> dict:
    return {"env": _zeros(device), "smooth": _zeros(device)}


def _comp_process(x, state, params, sr, static, mesh=None):
    attack_ms = torch.clamp(params["attack"], min=0.01)
    release_ms = torch.clamp(params["release"], min=1.0)
    thresh_db = params["threshold"]
    ratio = torch.clamp(params["ratio"], min=1.0)
    knee = torch.clamp(params["knee"], min=0.0)
    makeup_db = params["makeup"]

    level = torch.amax(torch.abs(x), dim=1)  # [T]
    r = torch.exp(-1.0 / (release_ms * 0.001 * sr))
    env2, env_fin = max_decay_scan_sharded(
        level[:, None].contiguous(), r.reshape(1), state["env"].reshape(1),
        mesh)
    env = env2[:, 0]
    a = torch.exp(-1.0 / (attack_ms * 0.001 * sr))
    smooth2, smooth_fin = first_order_scan(
        ((1.0 - a) * env)[:, None], a, state["smooth"].reshape(1), mesh
    )
    smooth = smooth2[:, 0]

    lvl_db = 20.0 * torch.log10(torch.clamp(smooth, min=1e-9))
    over = lvl_db - thresh_db
    half_knee = knee * 0.5
    # soft knee gain reduction in dB
    gr_below = torch.zeros_like(over)
    gr_knee = (1.0 / ratio - 1.0) * (over + half_knee) ** 2 / (
        2.0 * torch.clamp(knee, min=1e-9))
    gr_above = (1.0 / ratio - 1.0) * over
    gr_db = torch.where(
        over <= -half_knee, gr_below,
        torch.where(over >= half_knee, gr_above, gr_knee),
    )
    gain = torch.pow(10.0, (gr_db + makeup_db) / _const(20.0, x))
    y = x * gain[:, None]
    return y, {"env": env_fin[0], "smooth": smooth_fin[0]}


# ---------------------------------------------------------------------------
# tape
# ---------------------------------------------------------------------------

def _tape_init(sr: int, static: dict, device) -> dict:
    return {"lp_y0": _zeros(device, 2)}


def _tape_process(x, state, params, sr, static, mesh=None):
    drive = torch.clamp(params["drive"], 0.1, 10.0)
    cutoff = torch.clamp(params["cutoff"], 500.0, 20000.0)
    sat = torch.tanh(x * drive) / torch.tanh(drive)
    g = 1.0 - torch.exp(-2.0 * math.pi * cutoff / _const(sr, x))
    y, y_fin = first_order_scan(g * sat, 1.0 - g, state["lp_y0"], mesh)
    return y, {"lp_y0": y_fin}


# ---------------------------------------------------------------------------
# delay (feedback echo)
# ---------------------------------------------------------------------------

_DELAY_MAX_SEC = 2.0


def _delay_samples(sr: int, static: dict) -> int:
    """Static comb length D from the bound `time` param (ms -> samples)."""
    t_ms = min(max(float(static["time"]), 1.0), _DELAY_MAX_SEC * 1000.0)
    return max(1, int(round(t_ms * sr / 1000.0)))


def _delay_init(sr: int, static: dict, device) -> dict:
    return {"tail": _zeros(device, _delay_samples(sr, static), 2)}


def _delay_process(x, state, params, sr, static, mesh=None):
    # exact feedback comb y[t] = x[t] + fb * y[t-D]; `time` is static, so
    # D is a host int (it quantizes to whole samples at bind)
    fb = torch.clamp(params["feedback"], 0.0, 0.95)
    y, tail = feedback_line(x, state["tail"], fb,
                            _delay_samples(sr, static), mesh)
    return y, {"tail": tail}


# ---------------------------------------------------------------------------
# 3-band EQ (Linkwitz-Riley 4th-order tree crossovers)
# ---------------------------------------------------------------------------

def _eq3_init(sr: int, static: dict, device) -> dict:
    # LP/HP pair at f_lo on the input, then LP/HP pair at f_hi on the
    # upper branch: 8 biquads as 4 stages of a 4-channel biquad
    return {f"st{i}": biquad_init_state(4, device) for i in range(4)}


def _eq3_coefs(sr: int, f_lo: float, f_hi: float, device):
    """Per-channel (b0, b1, b2, a1, a2) of the low and high crossover
    pairs, channel layout [L_lp, R_lp, L_hp, R_hp]: host doubles cast to
    float32 once, one upload for both pairs."""
    def pair(f):
        ca = biquad_coefs("lowpass", f, sr)
        cb = biquad_coefs("highpass", f, sr)
        return [[a, a, b, b] for a, b in zip(ca, cb)]

    both = torch.from_numpy(
        np.asarray([pair(f_lo), pair(f_hi)], np.float32)).to(device)
    return tuple(both[0]), tuple(both[1])


def _eq3_freqs(sr: int, static: dict) -> tuple[float, float]:
    """The crossovers, clamped away from Nyquist where the biquad
    degenerates."""
    f_lo = min(max(float(static["low_freq"]), 10.0), 0.2 * sr)
    f_hi = min(max(float(static["high_freq"]), 2.0 * f_lo), 0.35 * sr)
    return f_lo, f_hi


def _eq3_process(x, state, params, sr, static, mesh=None):
    """Crossover frequencies are static params bound at graph build (the
    biquad coefficients are host-computed, uploaded by bind_static or
    here); gains are traced."""
    twenty = _const(20.0, x)
    g_lo = torch.pow(10.0, params["low_gain"] / twenty)
    g_mid = torch.pow(10.0, params["mid_gain"] / twenty)
    g_hi = torch.pow(10.0, params["high_gain"] / twenty)
    if "coefs" in static:
        c_lo, c_hi = static["coefs"]
    else:
        c_lo, c_hi = _eq3_coefs(sr, *_eq3_freqs(sr, static), x.device)
    xx = torch.cat([x, x], dim=1)  # [T, 4]
    t0, s0 = biquad_apply(xx, c_lo, state["st0"], mesh)
    t1, s1 = biquad_apply(t0, c_lo, state["st1"], mesh)
    low, upper = t1[:, 0:2], t1[:, 2:4]
    uu = torch.cat([upper, upper], dim=1)
    t2, s2 = biquad_apply(uu, c_hi, state["st2"], mesh)
    t3, s3 = biquad_apply(t2, c_hi, state["st3"], mesh)
    mid, high = t3[:, 0:2], t3[:, 2:4]
    y = low * g_lo + mid * g_mid + high * g_hi
    return y, {"st0": s0, "st1": s1, "st2": s2, "st3": s3}


# ---------------------------------------------------------------------------
# flanger (short modulated delay mixed with dry, feedback-free)
# ---------------------------------------------------------------------------

_FLANGER_MAX_DELAY_MS = 12.0


def _flanger_init(sr: int, static: dict, device) -> dict:
    m = int(_FLANGER_MAX_DELAY_MS / 1000.0 * sr) + 4
    return {"tail": _zeros(device, m, 2), "phase": _zeros(device)}


def _flanger_process(x, state, params, sr, static, mesh=None):
    rate = torch.clamp(params["rate"], 0.02, 10.0)
    depth_ms = torch.clamp(params["depth"], 0.1, 5.0)
    base_ms = torch.clamp(params["base"], 0.5, 6.0)
    T = x.shape[0]
    phase, ph_next = _local_phase(state["phase"], rate, T, sr, mesh)
    halo, new_tail = prev_frames(x, state["tail"], mesh)
    lfo = _lfo_sin(phase)
    delay = (base_ms + depth_ms * (0.5 + 0.5 * lfo)) * (sr / 1000.0)
    wet = delayed_read(x, halo, delay)
    y = 0.5 * (x + wet)
    return y, {"tail": new_tail, "phase": ph_next}


# ---------------------------------------------------------------------------
# bitcrush
# ---------------------------------------------------------------------------

def _bitcrush_init(sr: int, static: dict, device) -> dict:
    return {}


def _bitcrush_process(x, state, params, sr, static, mesh=None):
    bits = torch.clamp(params["bits"], 1.0, 16.0)
    levels = torch.pow(2.0, bits - 1.0)
    y = torch.round(x * levels) / levels
    return y, state


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

EFFECTS: dict[str, EffectDef] = {
    "reverb": EffectDef(
        "reverb", {"room": 0.84, "damp": 0.5}, _reverb_init, _reverb_process
    ),
    "chorus": EffectDef(
        "chorus", {"rate": 0.8, "depth": 6.0, "base": 8.0},
        _chorus_init, _chorus_process,
    ),
    "compressor": EffectDef(
        "compressor",
        {"attack": 20.0, "release": 250.0, "threshold": -18.0, "ratio": 4.0,
         "knee": 6.0, "makeup": 0.0},
        _comp_init, _comp_process,
    ),
    "tape": EffectDef(
        "tape", {"drive": 1.5, "cutoff": 12000.0}, _tape_init, _tape_process
    ),
    "delay": EffectDef(
        "delay", {"time": 350.0, "feedback": 0.4}, _delay_init,
        _delay_process, static_params=("time",),
    ),
    "bitcrush": EffectDef(
        "bitcrush", {"bits": 8.0}, _bitcrush_init, _bitcrush_process
    ),
    "eq3": EffectDef(
        "eq3",
        {"low_freq": 250.0, "high_freq": 4000.0, "low_gain": 0.0,
         "mid_gain": 0.0, "high_gain": 0.0},
        _eq3_init, _eq3_process, static_params=("low_freq", "high_freq"),
    ),
    "flanger": EffectDef(
        "flanger", {"rate": 0.3, "depth": 2.0, "base": 1.5},
        _flanger_init, _flanger_process,
    ),
}

# case-insensitive URI fragment -> effect kind (covers the Calf URIs the
# shipped projects load, project.lua:18-21)
_URI_HINTS = [
    ("reverb", "reverb"),
    ("chorus", "chorus"),
    ("compressor", "compressor"),
    ("tape", "tape"),
    ("delay", "delay"),
    ("bitcrush", "bitcrush"),
    ("crusher", "bitcrush"),
    ("equalizer", "eq3"),
    ("eq3", "eq3"),
    ("flanger", "flanger"),
]

# parameter-name aliases so LV2-style display names (project.lua:23-26) work
_PARAM_ALIASES = {
    "attack": "attack", "release": "release", "knee": "knee",
    "ratio": "ratio", "threshold": "threshold", "makeup": "makeup",
    "makeup gain": "makeup",
    "room size": "room", "room": "room", "damp": "damp", "damping": "damp",
    "rate": "rate", "depth": "depth", "base": "base", "base delay": "base",
    "drive": "drive", "cutoff": "cutoff",
    "time": "time", "feedback": "feedback", "bits": "bits",
    "low_freq": "low_freq", "low freq": "low_freq",
    "high_freq": "high_freq", "high freq": "high_freq",
    "low_gain": "low_gain", "low gain": "low_gain",
    "mid_gain": "mid_gain", "mid gain": "mid_gain",
    "high_gain": "high_gain", "high gain": "high_gain",
}


def resolve_uri(uri: str) -> EffectDef | None:
    low = uri.lower()
    if low.startswith("native:"):
        return EFFECTS.get(low.split(":", 1)[1])
    for frag, kind in _URI_HINTS:
        if frag in low:
            return EFFECTS[kind]
    return None


def resolve_param(name: str) -> str | None:
    return _PARAM_ALIASES.get(name.strip().lower())
