"""Event-driven vertices over a whole timeline: the song's frames, P
passes long. A repeat render starts from the state the last one left
(termdaw's partial reset at set_time, extensions.rs:196-204): sample
voices, wavetable voices and envelope clocks run on across passes, a
Synth's notes are cleared, and the floww cursor and the oscillators'
song time start again.

Clocks follow termdaw's float32 fold: a voice's envelope clock starts at
-f32(i/sr) at its trigger and adds f32(bl/sr) each block, each step
rounded to float32 (np.cumsum in float32 adds in order); the envelope
arithmetic is float32 too. Everything else is float64."""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32


def fdiv(i, sr):
    return (np.asarray(i, F32) / F32(sr)).astype(F32)


class Timeline:
    def __init__(self, sr: int, bl: int, blocks: int, passes: int) -> None:
        self.sr, self.bl, self.blocks, self.passes = sr, bl, blocks, passes
        self.F = blocks * bl            # frames a pass
        self.N = self.F * passes        # frames in all
        self.fd = fdiv(np.arange(bl), sr)   # f32(i/sr) within a block
        self.q = F32(fdiv(bl, sr))

    def in_pass(self, frames):
        return np.asarray(frames) % self.F

    def events(self, ev: np.ndarray):
        """(frames, notes, vels) of floww rows (t, note, vel) on the whole
        timeline: frame int(f32(t) * f32(sr)) in every pass, in floww
        order (by time, stable)."""
        ev = np.asarray(ev, np.float64).reshape(-1, 3)
        order = np.argsort(ev[:, 0].astype(F32), kind="stable")
        ev = ev[order]
        fr = (ev[:, 0].astype(F32) * F32(self.sr)).astype(np.int64)
        keep = fr < self.F
        fr, notes = fr[keep], ev[keep, 1].astype(F32)
        vels = ev[keep, 2].astype(F32)
        P = self.passes
        return (np.concatenate([fr + p * self.F for p in range(P)]),
                np.tile(notes, P), np.tile(vels, P))

    def clock(self, f0: int, f1: int) -> np.ndarray:
        """The f32 envelope clock of a voice triggered at frame f0, at
        frames f0..f1-1: block clock c_k = fold of f32(bl/sr) from
        -f32(i0/sr), then f32(c_k + f32(i/sr))."""
        bl = self.bl
        k0, i0 = divmod(int(f0), bl)
        k1 = (int(f1) - 1) // bl
        c0 = F32(-fdiv(i0, self.sr))
        steps = np.full(k1 - k0 + 1, self.q, F32)
        steps[0] = c0
        ck = np.cumsum(steps, dtype=F32)
        fr = np.arange(f0, f1)
        return (ck[fr // bl - k0] + self.fd[fr % bl]).astype(F32)

    def block_clock_at(self, f0: int, f: int) -> F32:
        """The block clock of a voice triggered at f0, in f's block."""
        bl = self.bl
        k0, i0 = divmod(int(f0), bl)
        c = F32(-fdiv(i0, self.sr))
        for _ in range(int(f) // bl - k0):
            c = F32(c + self.q)
        return c


# ---- ADSR (float32, termdaw adsr.rs) --------------------------------------

def conf9(arr) -> tuple:
    a = [float(x) for x in arr]
    if len(a) == 0:
        a = [0.0] * 9
    elif len(a) == 6:
        a = [0.0, a[0], 1.0, a[1], a[2], a[3], a[4], a[5], 0.0]
    return tuple(F32(x) for x in a)


def _lerp(a, b, t):
    return (F32(a) + t * F32(F32(b) - F32(a))).astype(F32)


def ads_internal(c, t):
    sv, a_s, av, d_s, dv, s_s, svel, r_s, rv = c
    t = np.asarray(t, F32)
    ad = F32(a_s + d_s)
    ads_ = F32(ad + s_s)
    with np.errstate(divide="ignore", invalid="ignore"):
        segs = [
            (a_s > 0) & (t <= a_s),
            t <= a_s,
            (d_s > 0) & (t <= ad),
            t <= ad,
            (s_s > 0) & (t <= ads_),
        ]
        vals = [
            _lerp(sv, av, (t / a_s).astype(F32)) if a_s > 0 else t * 0,
            np.full_like(t, sv),
            _lerp(av, dv, ((t - a_s) / d_s).astype(F32)) if d_s > 0
            else t * 0,
            np.full_like(t, av),
            _lerp(dv, svel, (((t - a_s) - d_s) / s_s).astype(F32))
            if s_s > 0 else t * 0,
        ]
    return np.select(segs, vals, F32(-1000.0)).astype(F32)


def ads(c, t):
    v = ads_internal(c, t)
    return np.where(v <= -1.0, c[6], v).astype(F32)


def rel(c, t, old):
    r_s, rv = c[7], c[8]
    t = np.asarray(t, F32)
    frac = (np.minimum((t / r_s).astype(F32), F32(1.0)) if r_s > 0
            else np.ones_like(t))
    return (F32(1) * old + frac * (F32(rv) - old)).astype(F32)


def adsr_full(c, t):
    sv, a_s, av, d_s, dv, s_s, svel, r_s, rv = c
    t = np.asarray(t, F32)
    v = ads_internal(c, t)
    if r_s > 0:
        frac = np.minimum(((((t - a_s) - d_s) - s_s) / r_s).astype(F32),
                          F32(1.0))
    else:
        frac = np.ones_like(t)
    return np.where(v > -1.0, v, _lerp(svel, rv, frac)).astype(F32)


def max_vel(c) -> float:
    return float(max(c[0], c[2], c[4], c[6], c[8]))


# ---- drum-mode triggers ---------------------------------------------------

def drum_hits(tl: Timeline, ev, note=None):
    """(frames, vels) that trigger a drum-mode vertex: at each frame the
    first event louder than 0.001 triggers, if its note matches; the other
    events of that frame are passed over."""
    fr, notes, vels = tl.events(ev)
    on = vels > 0.001
    fr, notes, vels = fr[on], notes[on], vels[on]
    first = np.ones(len(fr), bool)
    first[1:] = fr[1:] != fr[:-1]
    fr, notes, vels = fr[first], notes[first], vels[first]
    if note is not None:
        m = np.abs(notes - F32(note)) < 0.01
        fr, vels = fr[m], vels[m]
    return fr, vels.astype(np.float64)


def sample_multi(tl: Timeline, sample: np.ndarray, ev, note=None):
    out = np.zeros((tl.N, 2))
    L = len(sample)
    for f, v in zip(*drum_hits(tl, ev, note)):
        n = min(L, tl.N - f)
        out[f:f + n] += v * sample[:n]
    return out


def sample_lerp(tl: Timeline, sample: np.ndarray, ev, note, lerp_len: int):
    """Primary voice = the last hit, ghost = the one before (the first
    hit's ghost is the silent initial voice); for lerp_len frames after a
    hit the output fades from the ghost to the primary; positions past
    the sample's end hold its last frame."""
    fr, vels = drum_hits(tl, ev, note)
    L, N = len(sample), tl.N
    out = np.zeros((N, 2))
    ends = np.concatenate([fr[1:], [N]]).astype(np.int64)
    for j in range(len(fr)):
        lo, hi = int(fr[j]), int(ends[j])
        frames = np.arange(lo, hi)
        val = sample[np.clip(frames - lo, 0, L - 1)] * vels[j]
        k = frames - lo
        blend = k < lerp_len
        if j >= 1 and blend.any():
            t = ((lerp_len - 1 - k[blend]) / lerp_len)[:, None]
            gval = sample[np.clip(frames[blend] - fr[j - 1], 0, L - 1)] \
                * vels[j - 1]
            val[blend] = gval * t + val[blend] * (1 - t)
        elif blend.any():
            t = ((lerp_len - 1 - k[blend]) / lerp_len)[:, None]
            val[blend] = val[blend] * (1 - t)
        out[lo:hi] = val
    return out


def adsr_gain(tl: Timeline, ev, conf, use_max: bool, note, wet: float):
    """The per-frame factor lerp(1, av, wet) of a drum-mode Adsr vertex:
    av = max or min of the primary's and the ghost's envelope times their
    velocities. Hit j is the primary until hit j+1 and the ghost until
    hit j+2; before them the initial voices, of velocity 0, give 0."""
    c = conf9(conf)
    fr, vels = drum_hits(tl, ev, note)
    N = tl.N
    ends = np.concatenate([fr[1:], [N, N]]).astype(np.int64)
    env = np.zeros(N)      # primary
    genv = np.zeros(N)     # ghost
    for j in range(len(fr)):
        lo, hi_p, hi_g = int(fr[j]), int(ends[j]), int(ends[j + 1])
        e = adsr_full(c, tl.clock(lo, hi_g)).astype(np.float64) * vels[j]
        env[lo:hi_p] = e[:hi_p - lo]
        genv[hi_p:hi_g] = e[hi_p - lo:]
    av = np.maximum(env, genv) if use_max else np.minimum(env, genv)
    return 1.0 + wet * (av - 1.0)


# ---- notes (Synth, SampSyn) -------------------------------------------------

def notes(tl: Timeline, ev):
    """Voices of a note-mode vertex: (on frame, off frame or None, note,
    vel). A note-off releases every sounding voice of its note."""
    fr, ns, vels = tl.events(ev)
    out, open_ = [], []
    for f, n, v in zip(fr, ns, vels):
        if v > 0.001:
            open_.append([int(f), None, float(n), float(v)])
            out.append(open_[-1])
        else:
            for o in open_:
                if abs(o[2] - float(n)) <= 0.001 and o[1] is None:
                    o[1] = int(f)
            open_ = [o for o in open_ if o[1] is None]
    return out


def _note_env(tl: Timeline, on: int, off, end: int, c):
    """(frames, env f32, tau f32 = seconds since note-on in f32) of a
    voice from `on` to `end`."""
    if off is None or off >= end:
        t = tl.clock(on, end)
        return np.arange(on, end), ads(c, t), t
    t1 = tl.clock(on, off)
    rel_t = F32(tl.block_clock_at(on, off) + tl.fd[off % tl.bl])
    t2 = tl.clock(off, end)
    e = np.concatenate([ads(c, t1), rel(c, t2, ads(c, np.asarray(rel_t)))])
    tau = np.concatenate([t1, (t2 + rel_t).astype(F32)])
    return np.arange(on, end), e, tau


def _note_end(tl: Timeline, off, release_s: float) -> int:
    if off is None:
        return tl.N
    return min(tl.N, off + int(math.ceil(release_s * tl.sr)) + 2 * tl.bl)


def _sin_arg32(t, hz):
    return (np.asarray(t, F32) * F32(hz) * F32(2 * np.pi)).astype(F32)


def synth(tl: Timeline, ev, sq, tf, tr):
    (sqv, sqz, sqc), (tfv, tfz, tfc) = (
        (sq[0], sq[1], conf9(sq[2])), (tf[0], tf[1], conf9(tf[2])))
    trv, trc = tr[0], conf9(tr[1])
    mv = sqv * max_vel(sqc) + tfv * max_vel(tfc) + trv * max_vel(trc)
    amp = 1.0 / mv if mv != 0.0 else 0.0
    release_s = 0.0
    for vol, c in ((sqv, sqc), (tfv, tfc), (trv, trc)):
        if vol > 0:
            release_s = max(release_s, float(c[7]))
    out = np.zeros(tl.N)
    for on, off, note, vel in notes(tl, ev):
        # set_time clears a Synth's notes at the end of each pass
        end = min(_note_end(tl, off, release_s), (on // tl.F + 1) * tl.F)
        off = None if off is not None and off >= end else off
        hz = 440.0 * 2 ** ((note - 69.0) / 12.0)
        fr = np.arange(on, end)
        time = fdiv(tl.in_pass(fr), tl.sr)
        s = np.zeros(len(fr))
        if sqv > 0:
            _, e, _ = _note_env(tl, on, off, end, sqc)
            x = np.sin(_sin_arg32(time, hz).astype(np.float64))
            s += np.clip(x, -sqz, sqz) / sqz * vel * e * sqv
        if tfv > 0:
            _, e, _ = _note_env(tl, on, off, end, tfc)
            x = np.sin(_sin_arg32(time, hz).astype(np.float64))
            s += (np.minimum(x, tfz) + (1 - tfz) / 2) * (2 / (1 + tfz)) \
                * vel * e * tfv
        if trv > 0:
            _, e, _ = _note_env(tl, on, off, end, trc)
            x = (time.astype(F32) * F32(hz)).astype(np.float64)
            s += (4.0 * np.abs(x - np.floor(x + 0.5)) - 1.0) * vel * e * trv
        out[on:end] += s
    return out * amp


def sampsyn(tl: Timeline, ev, conf, times: np.ndarray, waves: np.ndarray):
    """Wavetable voices: the table read at the note's uint32 fixed-point
    phase, snapshots blended by seconds since note-on. A voice carried
    into the next pass keeps its phase and age."""
    c = conf9(conf)
    mv = max_vel(c)
    amp = 1.0 / mv if mv != 0.0 else 0.0
    K, W = waves.shape
    out = np.zeros(tl.N)
    for on, off, note, vel in notes(tl, ev):
        end = _note_end(tl, off, float(c[7]))
        fr, e, tau = _note_env(tl, on, off, end, c)
        n_since = fr - on
        hz = F32(440.0 * 2.0 ** ((note - 69.0) / 12.0))
        cyc = F32(hz / F32(tl.sr))
        c_fix = np.uint64(np.uint32(F32(cyc * F32(2.0 ** 32))))
        live = n_since >= 0
        ph_fix = ((np.maximum(n_since, 0).astype(np.uint64) * c_fix)
                  & np.uint64(0xFFFFFFFF))
        phase = (ph_fix.astype(F32) * F32(W / 2.0 ** 32)).astype(F32)
        p0 = np.clip(np.floor(phase), 0, W - 1).astype(np.int64)
        p1 = (p0 + 1) % W
        frac = (phase - p0.astype(F32)).astype(np.float64)
        taud = tau.astype(np.float64)
        if K > 1:
            k = np.clip(np.searchsorted(times, taud, side="right") - 1,
                        0, K - 2)
            blend = np.clip((taud - times[k]) / np.maximum(
                times[k + 1] - times[k], 1e-9), 0, 1)
            w0 = waves[k, p0] * (1 - frac) + waves[k, p1] * frac
            w1 = waves[k + 1, p0] * (1 - frac) + waves[k + 1, p1] * frac
            w = w0 * (1 - blend) + w1 * blend
        else:
            w = waves[0, p0] * (1 - frac) + waves[0, p1] * frac
        out[on:end] += np.where(live, w * vel * e.astype(np.float64), 0.0)
    return out * amp
