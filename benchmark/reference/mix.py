"""The plain reference of a mix session (projects/mix_session.py), in
plain PyTorch float64: SampleLoop stems, Sum buses with gains, fan-out,
the tape, eq3, compressor, chorus, flanger, reverb and delay effects, the
block-wise Normalize and the 24-bit scale, from termdaw's rules (the
repo's float64 oracle, tests/oracle.py, and the effects' definitions).
It imports nothing of the program, of JAX or of the JAX package, and no
compiled kernel; it reads only the project's raw files and spec, and
runs on whichever device it is handed (the check runs it on the card).

- SampleLoop: stem frame t mod L, t counted from 0 at every render.
- Sum: its inputs summed in connect order; a vertex's output is angle,
  then gain (each skipped within 0.001 of neutral, as termdaw does).
- Fan-out: an output read by several vertices is computed once and kept
  until its last reader has it.
- tape: tanh(drive x) / tanh(drive), then the one-pole y = (1 - g) y' +
  g s, g = 1 - exp(-2 pi cutoff / sr).
- chorus and flanger: the LFO phase is 2 pi rate t / sr from the start
  of the session (it runs on across renders), 3 voices a chorus at
  thirds of a period; the delay (base + depth (0.5 + 0.5 sin)) ms is read
  back by linear interpolation between the two frames around it, the
  frames before the session silent; flanger: (x + read) / 2.
- compressor, eq3, reverb, delay: benchmark/reference/effects.py's
  definitions, in float64 torch.
- An effect's output is x + wet (fx - x); one under a wet of 1e-4
  passes its input.
- Normalize: each block divided by the running maximum of the block
  peaks since the session's start (at least 1e-6).

Recurrences (the one-poles, the biquads, the feedback lines, which are
one-poles over the rows of the line's residue classes) are computed in
blocks of BLOCK frames: within a block, the product with the block's
impulse-response matrix; across blocks, the state entering each block by
a doubling scan over the block ends. The compressor's peak follower is a
running maximum in the log domain (torch.cummax).

Departures from termdaw's rules, each noted:
- Every coefficient an effect derives from a parameter (the one-poles'
  and combs' feedback, the compressor's decays, the biquads'
  coefficients, the eq3's band gains, a Sum's gain) is taken as
  termdaw's effects define it: in float32, from the float32 parameter,
  in the effect's own order of operations, with torch's float32
  operations on the reference's device (an exp one ulp off moves a
  decay over a second of audio by 3e-3). These are the filters the
  project asks for; the signal path, every product, sum and recurrence,
  is float64.
- Stems are read at the project rate; the reference does not resample
  an import (a stem at another rate raises).
- The three voices, the LFO and every read position are exact in
  float64; the program keeps the phase and the positions in float32
  (its frame clock restarts at each window), about 1/64 of a frame late
  in an 8 s window.
- A bounce at render R is the last of `passes_for(spec, R)` renders from
  a fresh start: three where every LFO turns a whole number of periods a
  render (then every render from the third on starts from the state the
  one before left, so three stand for any later one), else all R.
"""

from __future__ import annotations

import math
import wave
from pathlib import Path

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
BLOCK = 256

COMB_TUNING = [1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617]
ALLPASS_TUNING = [556, 441, 341, 225]
STEREO_SPREAD = 23
CHORUS_VOICES = 3

DEFAULTS = {
    "reverb": {"room": 0.84, "damp": 0.5},
    "compressor": {"attack": 20.0, "release": 250.0, "threshold": -18.0,
                   "ratio": 4.0, "knee": 6.0, "makeup": 0.0},
    "delay": {"time": 350.0, "feedback": 0.4},
    "eq3": {"low_freq": 250.0, "high_freq": 4000.0, "low_gain": 0.0,
            "mid_gain": 0.0, "high_gain": 0.0},
    "tape": {"drive": 1.5, "cutoff": 12000.0},
    "chorus": {"rate": 0.8, "depth": 6.0, "base": 8.0},
    "flanger": {"rate": 0.3, "depth": 2.0, "base": 1.5},
}


def params(kind: str, given: dict) -> dict:
    """An effect's parameters as float32 values: its defaults, then the
    project's (LV2-style display names: "low freq" is low_freq)."""
    out = dict(DEFAULTS[kind])
    out.update({k.strip().lower().replace(" ", "_"): v
                for k, v in given.items()})
    return {k: np.float32(v) for k, v in out.items()}


# ---- files -----------------------------------------------------------------

def read_wav(path) -> tuple[np.ndarray, int]:
    """([frames, channels] int64 counts, rate) of a PCM WAV."""
    with wave.open(str(path), "rb") as w:
        width, rate, ch = w.getsampwidth(), w.getframerate(), w.getnchannels()
        raw = w.readframes(w.getnframes())
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int64)
        v = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
    elif width == 1:
        v = np.frombuffer(raw, np.uint8).astype(np.int64) - 128
    else:
        v = np.frombuffer(raw, f"<i{width}").astype(np.int64)
    return v.reshape(-1, ch), rate


def load_stem(path, sr: int, device) -> torch.Tensor:
    """[frames, 2]: raw counts peak-normalised over both channels."""
    ints, rate = read_wav(path)
    if rate != sr:
        raise ValueError(f"{path}: {rate} Hz, the project runs at {sr}")
    x = torch.from_numpy(ints[:, :2].astype(np.float64)).to(device)
    m = x.abs().max()
    return x / m if m > 0 else x


# ---- recurrences -----------------------------------------------------------

def _responses(a: list[float], n: int) -> tuple[np.ndarray, np.ndarray]:
    """y[t] = u[t] - sum_k a[k] y[t-1-k]: the impulse response h [n] from
    rest, and the free responses [n, p] to y[-1-j] = 1."""
    p = len(a)
    h = np.zeros(n)
    free = np.zeros((n, p))
    for t in range(n):
        h[t] = (1.0 if t == 0 else 0.0) - sum(
            a[k] * h[t - 1 - k] for k in range(p) if t - 1 - k >= 0)
        for j in range(p):
            free[t, j] = -sum(
                a[k] * (free[t - 1 - k, j] if t - 1 - k >= 0 else
                        (1.0 if t - 1 - k == -1 - j else 0.0))
                for k in range(p))
    return h, free


def allpole(u: torch.Tensor, a: list[float]) -> torch.Tensor:
    """y[t] = u[t] - a[0] y[t-1] (- a[1] y[t-2]) along dim 0 of u [N, C]
    from rest, by blocks (see the module's doc)."""
    N, C = u.shape
    p, B = len(a), BLOCK
    K = -(-N // B)
    h, free = _responses([float(v) for v in a], B)
    idx = np.arange(B)
    lag = idx[:, None] - idx[None, :]
    H = torch.from_numpy(np.where(lag >= 0, h[np.clip(lag, 0, B - 1)], 0.0)
                         ).to(u.device)
    Phi = torch.from_numpy(free).to(u.device)           # [B, p]
    U = torch.zeros(K * B, C, dtype=F64, device=u.device)
    U[:N] = u
    # zero-state responses [K, B, C]: one product over every block
    Y = (H @ U.reshape(K, B, C).permute(1, 0, 2).reshape(B, K * C)
         ).reshape(B, K, C).permute(1, 0, 2)
    ends = [B - 1 - j for j in range(p)]               # y[end], y[end-1]
    A = Phi[ends]                                      # [p, p]
    S = Y[:, ends, :]                                  # [K, p, C]
    d = 1
    while d < K:                                       # S_k = E_k + A S_k-1
        S = torch.cat([S[:d], S[d:] + torch.matmul(A, S[:-d])])
        A = A @ A
        d *= 2
    prev = torch.cat([S.new_zeros(1, p, C), S[:-1]])   # state into block k
    Y = Y + torch.matmul(Phi, prev)
    return Y.reshape(K * B, C)[:N]


def one_pole(x: torch.Tensor, a, b) -> torch.Tensor:
    """y[t] = a y[t-1] + b x[t], from rest."""
    return allpole(float(b) * x, [-float(a)])


def biquad(x: torch.Tensor, c) -> torch.Tensor:
    """Direct form (b0, b1, b2, a1, a2), from rest."""
    b0, b1, b2, a1, a2 = (float(v) for v in c)
    u = b0 * x
    u[1:] += b1 * x[:-1]
    u[2:] += b2 * x[:-2]
    return allpole(u, [a1, a2])


def feedback_line(u: torch.Tensor, g, D: int) -> torch.Tensor:
    """y[t] = u[t] + g y[t-D], from rest: a one-pole over the rows of the
    D residue classes."""
    N, C = u.shape
    rows = -(-N // D)
    up = torch.zeros(rows * D, C, dtype=F64, device=u.device)
    up[:N] = u
    y = allpole(up.reshape(rows, D * C), [-float(g)])
    return y.reshape(rows * D, C)[:N]


# ---- effects ---------------------------------------------------------------

def _scaled(d: int, sr: int) -> int:
    return max(2, int(round(d * sr / 44100.0)))


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def tape(x, p, sr):
    drive = torch.clamp(p["drive"], 0.1, 10.0)
    cutoff = torch.clamp(p["cutoff"], 500.0, 20000.0)
    g = 1.0 - torch.exp(-2.0 * math.pi * cutoff / _f32(sr, x.device))
    sat = torch.tanh(x * float(drive)) / math.tanh(float(drive))
    return one_pole(sat, 1.0 - g, g)


def eq3(x, p, sr):
    f_lo = min(max(float(p["low_freq"]), 10.0), 0.2 * sr)
    f_hi = min(max(float(p["high_freq"]), 2.0 * f_lo), 0.35 * sr)

    def coefs(kind, fc):
        w0 = 2.0 * math.pi * fc / sr
        cw, sw = math.cos(w0), math.sin(w0)
        alpha = sw / (2.0 * (1 / math.sqrt(2)))
        a0 = 1.0 + alpha
        if kind == "lowpass":
            b = [(1.0 - cw) / 2.0, 1.0 - cw, (1.0 - cw) / 2.0]
        else:
            b = [(1.0 + cw) / 2.0, -(1.0 + cw), (1.0 + cw) / 2.0]
        return [np.float32(v / a0) for v in b + [-2.0 * cw, 1.0 - alpha]]

    def twice(sig, kind, fc):
        c = coefs(kind, fc)
        return biquad(biquad(sig, c), c)

    low = twice(x, "lowpass", f_lo)
    upper = twice(x, "highpass", f_lo)
    mid = twice(upper, "lowpass", f_hi)
    high = twice(upper, "highpass", f_hi)
    twenty = _f32(20.0, x.device)
    g = [float(torch.pow(10.0, p[k] / twenty))
         for k in ("low_gain", "mid_gain", "high_gain")]
    return low * g[0] + mid * g[1] + high * g[2]


def compressor(x, p, sr):
    attack = torch.clamp(p["attack"], min=0.01)
    release = torch.clamp(p["release"], min=1.0)
    ratio = float(torch.clamp(p["ratio"], min=1.0))
    knee = float(torch.clamp(p["knee"], min=0.0))
    level = x.abs().amax(dim=1)
    r = torch.exp(-1.0 / (release * 0.001 * sr))
    a = torch.exp(-1.0 / (attack * 0.001 * sr))
    # env[t] = max(level[t], r env[t-1]) = max over s <= t of
    # level[s] r^(t-s): a running maximum in the log domain
    lr = math.log(float(r))
    t = torch.arange(len(level), dtype=F64, device=x.device)
    cm = torch.cummax(torch.log(level) - t * lr, dim=0).values
    env = torch.exp(cm + t * lr)
    smooth = one_pole(env[:, None], a, 1.0 - a)[:, 0]
    over = 20.0 * torch.log10(torch.clamp(smooth, min=1e-9)) - float(
        p["threshold"])
    hk = knee * 0.5
    gr = torch.where(over <= -hk, torch.zeros_like(over), torch.where(
        over >= hk, (1.0 / ratio - 1.0) * over,
        (1.0 / ratio - 1.0) * (over + hk) ** 2 / (2.0 * max(knee, 1e-9))))
    return x * (10.0 ** ((gr + float(p["makeup"])) / 20.0))[:, None]


def reverb(x, p, sr):
    room = torch.clamp(p["room"], 0.0, 0.98)
    a = torch.clamp(p["damp"], 0.0, 1.0) * 0.8
    damped = one_pole(x * 0.25, a, 1.0 - a)
    combs = []
    for d in COMB_TUNING:
        combs += [_scaled(d, sr), _scaled(d + STEREO_SPREAD, sr)]
    acc = torch.zeros_like(x)
    for i, d in enumerate(combs):
        g = room * (0.94 + 0.06 * (i % 3) / 2.0)
        ch = i % 2
        acc[:, ch:ch + 1] += feedback_line(damped[:, ch:ch + 1], g, d)
    out = acc
    for d in (_scaled(d, sr) for d in ALLPASS_TUNING):
        xd = torch.zeros_like(out)
        xd[d:] = out[:-d]
        out = feedback_line(xd - 0.5 * out, 0.5, d)
    return out


def delay(x, p, sr):
    t_ms = min(max(float(p["time"]), 1.0), 2000.0)
    d = max(1, int(round(t_ms * sr / 1000.0)))
    return feedback_line(x, torch.clamp(p["feedback"], 0.0, 0.95), d)


def _read(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x [N, C] read at fractional frames pos [N] by linear
    interpolation; frames before 0 are silent."""
    p0 = torch.floor(pos)
    frac = (pos - p0)[:, None]
    i0 = p0.long()
    xp = torch.cat([x.new_zeros(2, x.shape[1]), x])

    def at(i):
        return xp[torch.clamp(i + 2, 0, xp.shape[0] - 1)]

    return at(i0) * (1.0 - frac) + at(i0 + 1) * frac


def _delayed(x, rate, depth, base, sr, offset):
    """x read (base + depth (0.5 + 0.5 sin(LFO + offset))) ms back."""
    t = torch.arange(len(x), dtype=F64, device=x.device)
    lfo = torch.sin(2.0 * math.pi * float(rate) * t / sr + offset)
    ms = float(base) + float(depth) * (0.5 + 0.5 * lfo)
    return _read(x, t - ms * (sr / 1000.0))


def chorus(x, p, sr):
    rate = torch.clamp(p["rate"], 0.01, 20.0)
    depth = torch.clamp(p["depth"], 0.0, 15.0)
    base = torch.clamp(p["base"], 1.0, 20.0)
    out = torch.zeros_like(x)
    for v in range(CHORUS_VOICES):
        out += _delayed(x, rate, depth, base, sr,
                        2.0 * math.pi * v / CHORUS_VOICES)
    return out / CHORUS_VOICES


def flanger(x, p, sr):
    rate = torch.clamp(p["rate"], 0.02, 10.0)
    depth = torch.clamp(p["depth"], 0.1, 5.0)
    base = torch.clamp(p["base"], 0.5, 6.0)
    return 0.5 * (x + _delayed(x, rate, depth, base, sr, 0.0))


EFFECTS = {"tape": tape, "eq3": eq3, "compressor": compressor,
           "chorus": chorus, "flanger": flanger, "reverb": reverb,
           "delay": delay}


# ---- the session -----------------------------------------------------------

def song_frames(spec: dict) -> int:
    """A render's frames: the song's blocks at the project rate."""
    bl = int(spec["bl"])
    return -(-int(round(int(spec["sr"]) * float(spec["length_s"]))) // bl) * bl


def lfo_periodic(spec: dict) -> bool:
    """Whether every LFO of the session turns a whole number of periods
    in one render."""
    F, sr = song_frames(spec), int(spec["sr"])
    for plug in spec["plugins"].values():
        if plug["kind"] in ("chorus", "flanger"):
            rate = params(plug["kind"], plug["params"])["rate"]
            turns = float(rate) * F / sr
            if abs(turns - round(turns)) > 1e-9:
                return False
    return True


def passes_for(spec: dict, renders: int) -> int:
    """The renders from a fresh start that stand for render number
    `renders` (see the module's doc)."""
    if renders <= 3 or not lfo_periodic(spec):
        return int(renders)
    return 3


def pan_gain(y: torch.Tensor, gain, angle) -> torch.Tensor:
    angle = min(max(float(angle), -90.0), 90.0)
    if abs(angle) >= 0.001:
        rad = angle * 0.5 * 0.01745329
        y = y * torch.tensor(
            [math.sqrt(0.5) * (math.cos(rad) + math.sin(rad)),
             math.sqrt(0.5) * (math.cos(rad) - math.sin(rad))],
            dtype=F64, device=y.device)
    gain = float(np.float32(gain))
    if abs(gain - 1.0) >= 0.001:
        y = y * gain
    return y


def bf16(y: torch.Tensor) -> torch.Tensor:
    """y rounded to bfloat16 (the control's lower precision)."""
    return y.to(torch.float32).to(torch.bfloat16).to(F64)


def render_passes(spec: dict, d, passes: int, device=None,
                  cast=None) -> torch.Tensor:
    """[passes * frames, 2] float64: the graph's output over `passes`
    back-to-back renders from a fresh start. `cast`, when given, rounds
    every vertex's output (the control's lower precision)."""
    device = torch.device(device or "cpu")
    d = Path(d)
    sr, bl = int(spec["sr"]), int(spec["bl"])
    F = song_frames(spec)
    N = passes * F
    cast = cast or (lambda y: y)
    verts = {v["name"]: v for v in spec["vertices"]}
    ins: dict = {n: [] for n in verts}
    readers: dict = {n: 0 for n in verts}
    for a, b in spec["edges"]:
        ins[b].append(a)
        readers[a] += 1
    kept: dict = {}   # outputs with readers still to come

    def run(name):
        if name in kept:
            y, left = kept[name]
            if left > 1:
                kept[name] = (y, left - 1)
            else:
                del kept[name]
            return y
        v = verts[name]
        k = v["kind"]
        if k == "sample_loop":
            s = load_stem(d / spec["samples"][v["sample"]], sr, device)
            i = torch.arange(N, device=device) % F % s.shape[0]
            y = s[i]
        else:
            y = torch.zeros(N, 2, dtype=F64, device=device)
            for a in ins[name]:
                y = y + run(a)
            if k == "fx":
                plug = spec["plugins"][v["plugin"]]
                wet = float(np.float32(v["wet"]))
                if wet >= float(np.float32(1e-4)):
                    p = {k: _f32(val, device) for k, val in params(
                        plug["kind"], plug["params"]).items()}
                    fx = EFFECTS[plug["kind"]](y, p, sr)
                    y = y + wet * (fx - y)
            elif k == "normalize":
                peaks = y.abs().reshape(-1, bl, 2).amax(dim=(1, 2))
                m = torch.cummax(torch.clamp(peaks, min=1e-6), dim=0).values
                y = y / m.repeat_interleave(bl)[:, None]
            elif k != "sum":
                raise ValueError(f"the mix reference has no kind {k!r}")
        y = cast(pan_gain(y, v.get("gain", 1.0), v.get("angle", 0.0)))
        if readers[name] > 1:
            kept[name] = (y, readers[name] - 1)
        return y

    return run(spec["output"])


def amplitude(bd: int) -> float:
    return float((1 << (bd - 1)) - 1) if bd < 32 else float(2 ** 31 - 1)


def bounce(spec: dict, d, renders: int, device=None,
           cast=None) -> np.ndarray:
    """Render number `renders` of a State that rendered back to back
    from a fresh start, scaled to the WAV's integer range (before the
    truncation), [frames, 2] on the host."""
    passes = passes_for(spec, renders)
    x = render_passes(spec, d, passes, device, cast)
    last = x[(passes - 1) * song_frames(spec):] * amplitude(int(spec["bd"]))
    return (cast(last) if cast else last).cpu().numpy()
