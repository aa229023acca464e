"""termdaw's native effects, BandPass and the render's resampler in
float64: the same recurrences as the effects' float64 sequential forms
(tests/test_fx_oracle.py), computed with scipy.signal.lfilter for
one-pole and biquad sections and by whole delay periods for feedback
lines."""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import lfilter

COMB_TUNING = [1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617]
ALLPASS_TUNING = [556, 441, 341, 225]
STEREO_SPREAD = 23

DEFAULTS = {
    "reverb": {"room": 0.84, "damp": 0.5},
    "compressor": {"attack": 20.0, "release": 250.0, "threshold": -18.0,
                   "ratio": 4.0, "knee": 6.0, "makeup": 0.0},
    "delay": {"time": 350.0, "feedback": 0.4},
    "eq3": {"low_freq": 250.0, "high_freq": 4000.0, "low_gain": 0.0,
            "mid_gain": 0.0, "high_gain": 0.0},
}


def params(kind: str, given: dict) -> dict:
    """An effect's parameters: its defaults, then the project's values
    under their LV2-style display names ("low freq" is low_freq)."""
    out = dict(DEFAULTS[kind])
    out.update({k.strip().lower().replace(" ", "_"): float(v)
                for k, v in given.items()})
    return out


def one_pole(x: np.ndarray, a: float, b: float, y0=None) -> np.ndarray:
    """y[t] = a y[t-1] + b x[t] along axis 0, from y[-1] = y0 (0)."""
    zi = None if y0 is None else (a * np.asarray(y0, np.float64))[None, :]
    if zi is None:
        return lfilter([b], [1.0, -a], x, axis=0)
    return lfilter([b], [1.0, -a], x, axis=0, zi=zi)[0]


def feedback_line(u: np.ndarray, g: float, d: int) -> np.ndarray:
    """y[t] = u[t] + g y[t-d], from zeros, by whole periods of d."""
    y = np.array(u, np.float64, copy=True)
    for s in range(d, len(y), d):
        e = min(s + d, len(y))
        y[s:e] += g * y[s - d:e - d]
    return y


def _scaled(d: int, sr: int) -> int:
    return max(2, int(round(d * sr / 44100.0)))


def reverb(x, p, sr):
    room = min(max(p["room"], 0.0), 0.98)
    damp = min(max(p["damp"], 0.0), 1.0)
    a = damp * 0.8
    damped = one_pole(x * 0.25, a, 1.0 - a)
    combs = []
    for d in COMB_TUNING:
        combs += [_scaled(d, sr), _scaled(d + STEREO_SPREAD, sr)]
    acc = np.zeros_like(x)
    for i, d in enumerate(combs):
        g = room * (0.94 + 0.06 * (i % 3) / 2.0)
        ch = i % 2
        acc[:, ch] += feedback_line(damped[:, ch], g, d)
    out = acc
    for d in (_scaled(d, sr) for d in ALLPASS_TUNING):
        gap = 0.5
        xd = np.zeros_like(out)
        xd[d:] = out[:-d]
        out = feedback_line(xd - gap * out, gap, d)
    return out


def compressor(x, p, sr):
    attack = max(p["attack"], 0.01)
    release = max(p["release"], 1.0)
    ratio = max(p["ratio"], 1.0)
    knee = max(p["knee"], 0.0)
    level = np.max(np.abs(x), axis=1)
    r = math.exp(-1.0 / (release * 0.001 * sr))
    # env[t] = max(level[t], r env[t-1]) = max over s <= t of
    # level[s] r^(t-s), in the log domain as a running maximum
    t = np.arange(len(level), dtype=np.float64)
    with np.errstate(divide="ignore"):
        lg = np.log(level) - t * math.log(r)
    env = np.exp(np.maximum.accumulate(lg) + t * math.log(r))
    a = math.exp(-1.0 / (attack * 0.001 * sr))
    smooth = one_pole(env[:, None], a, 1.0 - a)[:, 0]
    over = 20.0 * np.log10(np.maximum(smooth, 1e-9)) - p["threshold"]
    hk = knee * 0.5
    gr = np.where(over <= -hk, 0.0, np.where(
        over >= hk, (1.0 / ratio - 1.0) * over,
        (1.0 / ratio - 1.0) * (over + hk) ** 2 / (2.0 * max(knee, 1e-9))))
    return x * (10.0 ** ((gr + p["makeup"]) / 20.0))[:, None]


def biquad_coefs(kind: str, fc: float, sr: int, q: float = 1 / math.sqrt(2)):
    """RBJ cookbook low/high-pass (b, a), a0 = 1."""
    w0 = 2.0 * math.pi * fc / sr
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    a0 = 1.0 + alpha
    if kind == "lowpass":
        b = [(1.0 - cw) / 2.0, 1.0 - cw, (1.0 - cw) / 2.0]
    else:
        b = [(1.0 + cw) / 2.0, -(1.0 + cw), (1.0 + cw) / 2.0]
    return [v / a0 for v in b], [1.0, -2.0 * cw / a0, (1.0 - alpha) / a0]


def eq3(x, p, sr):
    f_lo = min(max(p["low_freq"], 10.0), 0.2 * sr)
    f_hi = min(max(p["high_freq"], 2.0 * f_lo), 0.35 * sr)

    def twice(sig, kind, f):
        b, a = biquad_coefs(kind, f, sr)
        return lfilter(b, a, lfilter(b, a, sig, axis=0), axis=0)

    low = twice(x, "lowpass", f_lo)
    upper = twice(x, "highpass", f_lo)
    mid = twice(upper, "lowpass", f_hi)
    high = twice(upper, "highpass", f_hi)
    g = [10.0 ** (p[k] / 20.0) for k in ("low_gain", "mid_gain", "high_gain")]
    return low * g[0] + mid * g[1] + high * g[2]


def delay(x, p, sr):
    t_ms = min(max(p["time"], 1.0), 2000.0)
    d = max(1, int(round(t_ms * sr / 1000.0)))
    fb = min(max(p["feedback"], 0.0), 0.95)
    return feedback_line(x, fb, d)


EFFECTS = {"reverb": reverb, "compressor": compressor, "eq3": eq3,
           "delay": delay}


def bandpass(x, cut_low, cut_high, pass_mode, sr):
    """Two one-poles per channel from y[-1] = x[0] (re-primed at each
    pass, as set_time does); the cut is half the
    low one-pole plus half the input minus the high one-pole (passr from
    cutr, the documented fix); pass mode keeps input minus cut."""
    lco = min(max(cut_low, 0.0), 20000.0)
    hco = min(max(cut_high, 0.0), 20000.0)
    lg = 1.0 - math.exp(-2 * math.pi * lco / sr)
    hg = 1.0 - math.exp(-2 * math.pi * hco / sr)
    if lg == 0.0 and hg == 0.0:
        return x
    lo = one_pole(x, 1.0 - lg, lg, y0=x[0])
    hi = one_pole(x, 1.0 - hg, hg, y0=x[0])
    cut = ((1.0 if lg else 0.0) * lo + (1.0 if hg else 0.0) * (x - hi)) * 0.5
    return x - cut if pass_mode else cut


# ---- resampling (windowed sinc, termdaw's rubato recipe) -------------------

SINC_LEN = 256


def _filter(frac: float, cutoff: float) -> np.ndarray:
    n = SINC_LEN
    x = (np.arange(n, dtype=np.float64) - (n // 2 - 1)) - frac
    wpos = np.clip((x / n + 0.5) * (n - 1), 0, n - 1)
    w = (0.35875 - 0.48829 * np.cos(2 * np.pi * wpos / (n - 1))
         + 0.14128 * np.cos(4 * np.pi * wpos / (n - 1))
         - 0.01168 * np.cos(6 * np.pi * wpos / (n - 1)))
    h = cutoff * np.sinc(cutoff * x) * w
    return h / h.sum()


def resample(x: np.ndarray, from_sr: int, to_sr: int) -> np.ndarray:
    """Output n reads input position n*from/to through the 256-tap
    Blackman-Harris windowed sinc (cutoff 0.95, times the ratio when
    going down) for that position's fraction, unity gain at DC, centred,
    zero-padded at both ends. As a polyphase product: output q*L + p is
    the input window starting at q*M times phase p's filter, placed at
    floor(p*M/L) within a window of M - 1 + 256 frames."""
    if from_sr == to_sr:
        return np.asarray(x, np.float64)
    g = math.gcd(from_sr, to_sr)
    L, M = to_sr // g, from_sr // g
    cutoff = 0.95 * min(1.0, to_sr / from_sr)
    n, C = x.shape
    n_out = -(-n * L // M)
    rows = -(-n_out // L)
    K = M - 1 + SINC_LEN
    W = np.zeros((L, K))
    for p in range(L):
        base = (p * M) // L
        W[p, base:base + SINC_LEN] = _filter((p * M % L) / L, cutoff)
    half = SINC_LEN // 2 - 1
    xp = np.zeros(((rows - 1) * M + K + half, C))
    xp[half:half + n] = x
    out = np.empty((rows * L, C))
    for c in range(C):
        xc = np.ascontiguousarray(xp[:, c])
        win = np.lib.stride_tricks.as_strided(
            xc, shape=(rows, K), strides=(M * xc.itemsize, xc.itemsize))
        out[:, c] = (np.ascontiguousarray(win) @ W.T).reshape(-1)
    return out[:n_out]
