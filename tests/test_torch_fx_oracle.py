"""The port's native effects against float64 sequential per-frame loops:
the counterpart of tests/test_fx_oracle.py, with its SR (8 kHz), T (4096
frames), input, window splits, cases and relative tolerances.

The effects are timeline-parallel scan formulations
(termdaw_tpu_torch/ops/fx.py); each loop below is the same math as a
naive per-frame float64 loop (comb and allpass feedback, one-pole
smoothers, a max-decay envelope follower, direct-form-1 biquads). Each
effect runs windowed, its state carried from one window to the next, over
each of the three splits, and must stay within the case's tolerance of
its loop relative to the loop's max |y|: the check that catches a
numerically broken scan even where it is consistent across window sizes.
The eq3 runs once more with TERMDAW_EXACT_BIQUAD=1, on the exact lane.

The loops are a copy of tests/test_fx_oracle.py:70-208, which cannot be
imported where only the port is installed (that module imports jax);
tests/test_torch_oraclecopies.py holds the copy to them bit for bit.
Every case runs on the CPU (the kernels' plain versions) and, marked
`cuda`, on a card, where it also asserts which hand-written kernels the
effect launched through the wrappers' counters: the reverb, delay and
tape csrc/affine_scan.cu, the compressor csrc/max_decay_scan.cu and
affine_scan.cu, the eq3 csrc/eq3.cu, the exact eq3
csrc/biquad_seq.cu, the others none. This file imports nothing of JAX:

    python -m pytest tests/test_torch_fx_oracle.py -m cuda -q
"""

import math

import numpy as np
import pytest
import torch

from termdaw_tpu_torch.graph.compile import _kernel_counts
from termdaw_tpu_torch.ops.filters import biquad_coefs
from termdaw_tpu_torch.ops.fx import EFFECTS, _delay_samples, _reverb_lines

SR = 8000
T_TOTAL = 4096

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(request.param)


def run_engine(kind: str, x: np.ndarray, params: dict, splits: list[int],
               device: torch.device):
    """Run the effect windowed with chained state; splits are window
    lengths summing to len(x)."""
    eff = EFFECTS[kind]
    static = {k: float(params.get(k, eff.defaults[k]))
              for k in eff.static_params}
    pvals = {k: torch.tensor(params.get(k, v), dtype=torch.float32,
                             device=device)
             for k, v in eff.defaults.items() if k not in eff.static_params}
    state = eff.init_state(SR, static, device)
    outs = []
    pos = 0
    for w in splits:
        xw = torch.from_numpy(np.ascontiguousarray(x[pos:pos + w]))
        y, state = eff.process(xw.to(device), state, pvals, SR, static)
        outs.append(y.cpu().numpy())
        pos += w
    assert pos == len(x)
    return np.concatenate(outs, axis=0)


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    scale = float(np.max(np.abs(want))) + 1e-9
    return float(np.max(np.abs(got - want))) / scale


@pytest.fixture
def x64(rng):
    x = rng.normal(size=(T_TOTAL, 2)).astype(np.float32) * 0.4
    # a transient so envelopes/feedback get exercised
    x[100:140] *= 6.0
    return x.astype(np.float64)


SPLITS = [[T_TOTAL], [1024] * 4, [700, 1396, 300, 1700]]


# -- float64 sequential references (tests/test_fx_oracle.py:70-208) ---------

def ref_reverb(x, room, damp, sr):
    combs, allp = _reverb_lines(sr)
    a = damp * 0.8
    xin = x * 0.25
    damped = np.zeros_like(x)
    y0 = np.zeros(2)
    for t in range(len(x)):
        y0 = a * y0 + (1.0 - a) * xin[t]
        damped[t] = y0
    acc = np.zeros_like(x)
    for i, d in enumerate(combs):
        g = room * (0.94 + 0.06 * (i % 3) / 2.0)
        y = np.zeros_like(x)
        for t in range(len(x)):
            prev = y[t - d] if t - d >= 0 else np.zeros(2)
            y[t] = damped[t] + g * prev
        ch = i % 2
        acc[:, ch] += y[:, ch]
    out = acc
    for d in allp:
        gap = 0.5
        y = np.zeros_like(x)
        for t in range(len(x)):
            xd = out[t - d] if t - d >= 0 else np.zeros(2)
            yd = y[t - d] if t - d >= 0 else np.zeros(2)
            y[t] = gap * yd + xd - gap * out[t]
        out = y
    return out


def ref_delay(x, fb, D):
    y = np.zeros_like(x)
    for t in range(len(x)):
        prev = y[t - D] if t - D >= 0 else np.zeros(2)
        y[t] = x[t] + fb * prev
    return y


def ref_compressor(x, attack, release, thresh, ratio, knee, makeup, sr):
    r = math.exp(-1.0 / (release * 0.001 * sr))
    a = math.exp(-1.0 / (attack * 0.001 * sr))
    env = 0.0
    smooth = 0.0
    y = np.zeros_like(x)
    for t in range(len(x)):
        level = float(np.max(np.abs(x[t])))
        env = max(level, r * env)
        smooth = a * smooth + (1.0 - a) * env
        lvl_db = 20.0 * math.log10(max(smooth, 1e-9))
        over = lvl_db - thresh
        hk = knee * 0.5
        if over <= -hk:
            gr = 0.0
        elif over >= hk:
            gr = (1.0 / ratio - 1.0) * over
        else:
            gr = (1.0 / ratio - 1.0) * (over + hk) ** 2 / (2.0 * max(knee, 1e-9))
        y[t] = x[t] * 10.0 ** ((gr + makeup) / 20.0)
    return y


def ref_tape(x, drive, cutoff, sr):
    sat = np.tanh(x * drive) / math.tanh(drive)
    g = 1.0 - math.exp(-2.0 * math.pi * cutoff / sr)
    y = np.zeros_like(x)
    y0 = np.zeros(2)
    for t in range(len(x)):
        y0 = (1.0 - g) * y0 + g * sat[t]
        y[t] = y0
    return y


def _ref_delayed_read(x, t, delay):
    pos = t - delay
    p0 = int(np.floor(pos))
    frac = pos - p0
    def at(i):
        return x[i] if 0 <= i < len(x) else np.zeros(2)
    return at(p0) * (1 - frac) + at(p0 + 1) * frac


def ref_chorus(x, rate, depth, base, sr):
    voices = 3
    out = np.zeros_like(x)
    for t in range(len(x)):
        ts = t / sr
        s = np.zeros(2)
        for v in range(voices):
            ph = 2.0 * math.pi * (v / voices)
            lfo = math.sin(2.0 * math.pi * rate * ts + ph)
            delay = (base + depth * (0.5 + 0.5 * lfo)) * (sr / 1000.0)
            s += _ref_delayed_read(x, t, delay)
        out[t] = s / voices
    return out


def ref_flanger(x, rate, depth, base, sr):
    out = np.zeros_like(x)
    for t in range(len(x)):
        ts = t / sr
        lfo = math.sin(2.0 * math.pi * rate * ts)
        delay = (base + depth * (0.5 + 0.5 * lfo)) * (sr / 1000.0)
        out[t] = 0.5 * (x[t] + _ref_delayed_read(x, t, delay))
    return out


def ref_bitcrush(x, bits):
    levels = 2.0 ** (bits - 1.0)
    return np.round(x * levels) / levels


def ref_eq3(x, low_freq, high_freq, g_lo_db, g_mid_db, g_hi_db, sr):
    def df1(x_, coefs):
        b0, b1, b2, a1, a2 = [float(c) for c in coefs]
        y = np.zeros_like(x_)
        x1 = x2 = y1 = y2 = np.zeros(x_.shape[1])
        for t in range(len(x_)):
            yt = b0 * x_[t] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            x2, x1 = x1, x_[t].copy()
            y2, y1 = y1, yt
            y[t] = yt
        return y

    f_lo = min(max(low_freq, 10.0), 0.2 * sr)
    f_hi = min(max(high_freq, 2.0 * f_lo), 0.35 * sr)
    lp_lo = biquad_coefs("lowpass", f_lo, sr)
    hp_lo = biquad_coefs("highpass", f_lo, sr)
    lp_hi = biquad_coefs("lowpass", f_hi, sr)
    hp_hi = biquad_coefs("highpass", f_hi, sr)
    low = df1(df1(x, lp_lo), lp_lo)
    upper = df1(df1(x, hp_lo), hp_lo)
    mid = df1(df1(upper, lp_hi), lp_hi)
    high = df1(df1(upper, hp_hi), hp_hi)
    return (low * 10 ** (g_lo_db / 20) + mid * 10 ** (g_mid_db / 20)
            + high * 10 ** (g_hi_db / 20))


# -- the tests ---------------------------------------------------------------

EQ3 = {"low_freq": 300.0, "high_freq": 3000.0, "low_gain": 4.0,
       "mid_gain": -3.0, "high_gain": 2.0}

CASES = [
    # (kind, params, f64 reference fn, rel tolerance)
    ("reverb", {"room": 0.9, "damp": 0.4},
     lambda x, p: ref_reverb(x, p["room"], p["damp"], SR), 3e-4),
    ("delay", {"time": 40.0, "feedback": 0.9},
     lambda x, p: ref_delay(x, p["feedback"],
                            _delay_samples(SR, {"time": p["time"]})), 2e-4),
    ("compressor",
     {"attack": 8.0, "release": 120.0, "threshold": -20.0, "ratio": 5.0,
      "knee": 4.0, "makeup": 2.0},
     lambda x, p: ref_compressor(x, p["attack"], p["release"],
                                 p["threshold"], p["ratio"], p["knee"],
                                 p["makeup"], SR), 3e-4),
    ("tape", {"drive": 3.0, "cutoff": 3000.0},
     lambda x, p: ref_tape(x, p["drive"], p["cutoff"], SR), 1e-4),
    ("chorus", {"rate": 1.3, "depth": 5.0, "base": 7.0},
     lambda x, p: ref_chorus(x, p["rate"], p["depth"], p["base"], SR), 2e-3),
    ("flanger", {"rate": 0.7, "depth": 3.0, "base": 2.0},
     lambda x, p: ref_flanger(x, p["rate"], p["depth"], p["base"], SR), 2e-3),
    ("bitcrush", {"bits": 6.0},
     lambda x, p: ref_bitcrush(x, p["bits"]), 1e-6),
    ("eq3", EQ3,
     lambda x, p: ref_eq3(x, p["low_freq"], p["high_freq"], p["low_gain"],
                          p["mid_gain"], p["high_gain"], SR), 2e-3),
]

# the kernels each effect launches on the card (graph.compile's counter
# names); the eq3 its own kernel, the exact eq3 biquad_seq
KERNELS = {
    "reverb": {"affine_scan"}, "delay": {"affine_scan"},
    "compressor": {"max_decay_scan", "affine_scan"},
    "tape": {"affine_scan"}, "chorus": set(), "flanger": set(),
    "bitcrush": set(), "eq3": {"eq3"},
}

SPLIT_IDS = ["whole", "4x1024", "ragged"]


def check(kind, params, ref, tol, x64, splits, device, kernels):
    want = ref(x64, params)
    before = _kernel_counts()
    got = run_engine(kind, x64.astype(np.float32), params, splits, device)
    grew = {k for k, v in _kernel_counts().items() if v > before[k]}
    assert grew == (kernels if device.type == "cuda" else set())
    e = rel_err(got.astype(np.float64), want)
    assert e < tol, (
        f"{kind} splits={splits[:2]}...: rel err {e:.2e} vs f64 "
        f"sequential (tol {tol})"
    )


@pytest.mark.parametrize("splits", SPLITS, ids=SPLIT_IDS)
@pytest.mark.parametrize("kind,params,ref,tol",
                         CASES, ids=[c[0] for c in CASES])
def test_effect_matches_float64_sequential(kind, params, ref, tol, splits,
                                           x64, device):
    check(kind, params, ref, tol, x64, splits, device, KERNELS[kind])


@pytest.mark.parametrize("splits", SPLITS, ids=SPLIT_IDS)
def test_exact_eq3_matches_float64_sequential(splits, x64, device,
                                              monkeypatch):
    """The eq3 on the exact sequential biquad lane (the flag is read at
    each call outside a built graph), at the eq3 case's tolerance."""
    monkeypatch.setenv("TERMDAW_EXACT_BIQUAD", "1")
    kind, params, ref, tol = CASES[-1]
    check(kind, params, ref, tol, x64, splits, device, {"biquad_seq"})
