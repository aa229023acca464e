"""The plain reference of an instrument session (projects/poly_session.py),
in plain PyTorch float64: Synth and SampSyn tracks playing MIDI parts,
Sum buses, the block-wise Normalize and the 24-bit scale, from termdaw's
rules as benchmark/reference/voices.py states them (its `notes`,
`_note_env`, `_note_end`, `synth` and `sampsyn`) and the repo's float64
oracle (tests/oracle.py) keeps them. It imports nothing of the program, of
JAX or of the JAX package, and no compiled kernel; it reads only the
project's raw files (MIDI, TDWT wavetables) and spec, and runs on
whichever device it is handed (the check runs it on the card).

- Events: a MIDI row at t seconds falls on frame int(f32(t) f32(sr)) of
  every render, in time order (stable); a row louder than 0.001 is a
  note-on, any other a note-off.
- Voices (extensions.rs:459-578): a note-on always adds a voice; a
  note-off first drops the already-released voices of its pitch (they
  stop at that frame), then releases the held ones. A released voice
  ends once its release has run (its envelope is then 0).
- Repeat renders: set_time clears a Synth's voices at the end of each
  render; a SampSyn voice runs on into the next one with its phase and
  age. A render's third pass from a fresh start stands for every later
  one (PERF.md, Open questions, item 6): the voices entering it are those
  entering the second, and the Normalize's peak no longer grows.
- Clocks, as termdaw keeps them in float32: a voice's envelope clock
  starts at -f32(i/sr) at its on (or off) frame and adds f32(bl/sr) at
  every block end, each add rounded to float32; a frame reads f32(block
  clock + f32(i/sr)). The ADSR arithmetic is float32 too, as the
  program's and the oracle's: segment fractions are float32 divisions.
- Synth: time = f32(frame of the render) / f32(sr); the sine's argument
  is f32(f32(time hz) 2 pi), rounded as termdaw's is (at second-scale
  times f32 rounding of the argument is part of the sound), its sine in
  float64; the triangle reads x = f32(time hz). hz is the note's
  frequency rounded to float32.
- SampSyn: the table phase is uint32 fixed point, n c_fix mod 2^32 with
  c_fix = uint32(f32(f32(hz / sr) 2^32)), n the frames since the note-on;
  phase = f32(that) W / 2^32; the snapshots are blended by the voice's
  age (its clock plus the clock it had at its release).
- Sum: inputs added; a vertex's output is angle, then gain (each skipped
  within 0.001 of neutral). Normalize: each block divided by the running
  maximum of the block peaks since the session's start (at least 1e-6).

Departures from termdaw's rules, each noted:
- Voices are computed a voice at a time (batched over voices, each over
  its own frames), not a slot at a time; a released voice runs to its
  release's end plus two blocks, with an envelope of exactly 0 once the
  release has run, where termdaw drops it at the end of the block whose
  clock passed the release time.
- Everything but the clocks, the ADSR, the oscillators' float32
  arguments and the table phase is float64: sines, triangles, table
  reads and their blends, velocities, amplitudes, sums.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .files import read_midi, read_wavetable

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
F32 = torch.float32
f32 = np.float32
U32 = 0xFFFFFFFF
# voice-frames a batch computes at once, by device type
CHUNK = {"cuda": 1 << 23, "cpu": 1 << 20}


def song_frames(spec: dict) -> int:
    """A render's frames: the song's blocks at the project rate (the
    session renders at its own rate)."""
    if int(spec["render_sr"]) != int(spec["sr"]):
        raise ValueError("the instrument reference renders at the "
                         "project's rate only")
    bl = int(spec["bl"])
    return -(-int(round(int(spec["sr"]) * float(spec["length_s"]))) // bl) * bl


def conf9(arr) -> tuple:
    """An ADSR of 0, 6 or 9 values as its 9 float32 fields."""
    a = [float(x) for x in arr]
    if len(a) == 0:
        a = [0.0] * 9
    elif len(a) == 6:
        a = [0.0, a[0], 1.0, a[1], a[2], a[3], a[4], a[5], 0.0]
    return tuple(f32(x) for x in a)


def max_vel(c) -> float:
    return float(max(c[0], c[2], c[4], c[6], c[8]))


# ---- events and voices -------------------------------------------------------

def events(ev: np.ndarray, sr: int, F: int, passes: int):
    """(frames, notes, vels) of MIDI rows (t, note, vel) over `passes`
    renders of F frames: frame int(f32(t) f32(sr)) in every pass."""
    ev = np.asarray(ev, np.float64).reshape(-1, 3)
    ev = ev[np.argsort(ev[:, 0].astype(f32), kind="stable")]
    fr = (ev[:, 0].astype(f32) * f32(sr)).astype(np.int64)
    keep = fr < F
    fr, notes, vels = fr[keep], ev[keep, 1].astype(f32), ev[keep, 2].astype(f32)
    return (np.concatenate([fr + p * F for p in range(passes)]),
            np.tile(notes, passes), np.tile(vels, passes))


def voices_of(ev, sr: int, bl: int, F: int, passes: int, release_s: float,
              per_pass: bool) -> tuple:
    """(on, off, end, note, vel) arrays, a voice each: every voice of a
    note-mode vertex over the passes, by termdaw's note rules (see the
    module's doc); `off` is -1 for a voice never released, `end` its
    first frame of silence. `per_pass`: the voices end with their render
    (a Synth)."""
    fr, ns, vels = events(ev, sr, F, passes)
    N = F * passes
    tail = int(math.ceil(release_s * sr)) + 2 * bl
    on, off, end, note, vel = [], [], [], [], []
    held: dict = {}       # pitch -> held voices
    released: dict = {}   # pitch -> released voices still sounding
    cur = -1
    for f, n, v in zip(fr.tolist(), ns.tolist(), vels.tolist()):
        if per_pass and f // F != cur:
            cur = f // F
            held, released = {}, {}
        if v > 0.001:
            held.setdefault(n, []).append(len(on))
            on.append(f)
            off.append(-1)
            end.append(N if not per_pass else (f // F + 1) * F)
            note.append(n)
            vel.append(v)
            continue
        for j in released.pop(n, []):
            end[j] = min(end[j], f)
        for j in held.pop(n, []):
            off[j] = f
            end[j] = min(end[j], f + tail)
            released.setdefault(n, []).append(j)
    return (np.asarray(on, np.int64), np.asarray(off, np.int64),
            np.asarray(end, np.int64), np.asarray(note, f32),
            np.asarray(vel, f32))


def _folds(anchor: np.ndarray, K: int, q) -> np.ndarray:
    """[V, K] float32: row r the clocks of K blocks from a voice's anchor
    block on: anchor[r] first, each next one f32(previous + q) (np.cumsum
    in float32 adds along a row in order)."""
    m = np.full((len(anchor), K), q, f32)
    m[:, 0] = anchor
    return np.cumsum(m, axis=1, dtype=f32)


class _Env:
    """termdaw's ADSR in float32 on tensors (adsr.rs; benchmark/reference
    /voices.py `ads`, `rel`): divisions by device tensors, so that a
    card divides as the CPU does."""

    def __init__(self, c, device) -> None:
        self.c = c
        sv, a_s, av, d_s, dv, s_s, svel, r_s, rv = c
        self.ad = f32(a_s + d_s)
        self.ads_end = f32(self.ad + s_s)

        def t(v):
            return torch.tensor(float(v), dtype=F32, device=device)

        self.a_s, self.d_s, self.s_s, self.r_s = t(a_s), t(d_s), t(s_s), t(r_s)

    @staticmethod
    def _lerp(a, b, x):
        return x * float(f32(f32(b) - f32(a))) + float(f32(a))

    def ads(self, t: torch.Tensor) -> torch.Tensor:
        sv, a_s, av, d_s, dv, s_s, svel, r_s, rv = self.c
        v = torch.full_like(t, -1000.0)
        if s_s > 0:
            seg = self._lerp(dv, svel, ((t - float(a_s)) - float(d_s))
                             / self.s_s)
            v = torch.where(t <= float(self.ads_end), seg, v)
        v = torch.where(t <= float(self.ad), torch.full_like(t, float(av)), v)
        if d_s > 0:
            v = torch.where(t <= float(self.ad),
                            self._lerp(av, dv, (t - float(a_s)) / self.d_s), v)
        v = torch.where(t <= float(a_s), torch.full_like(t, float(sv)), v)
        if a_s > 0:
            v = torch.where(t <= float(a_s), self._lerp(sv, av, t / self.a_s),
                            v)
        return torch.where(v <= -1.0, torch.full_like(v, float(svel)), v)

    def rel(self, t: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        r_s, rv = self.c[7], self.c[8]
        frac = (torch.clamp(t / self.r_s, max=1.0) if r_s > 0
                else torch.ones_like(t))
        return old + frac * (float(rv) - old)


class _Arm:
    """One Synth's or SampSyn's constants on the device, and its voices
    added into an output a batch at a time."""

    def __init__(self, kind: str, v: dict, sr: int, bl: int, F: int,
                 device, table=None) -> None:
        self.kind, self.sr, self.bl, self.F = kind, sr, bl, F
        self.device = device
        if kind == "synth":
            self.oscs = [
                (float(v["sq"][0]), float(v["sq"][1]), conf9(v["sq"][2])),
                (float(v["tf"][0]), float(v["tf"][1]), conf9(v["tf"][2])),
                (float(v["tr"][0]), 0.0, conf9(v["tr"][1]))]
            mv = sum(vol * max_vel(c) for vol, _, c in self.oscs)
            self.release_s = max([float(c[7]) for vol, _, c in self.oscs
                                  if vol > 0], default=0.0)
            self.envs = {c: _Env(c, device) for vol, _, c in self.oscs
                         if vol > 0}
            # f32(i) / f32(sr) for the frames of a render (the time)
            self.ttab = self.up((np.arange(F, dtype=np.int64).astype(f32)
                                 / f32(sr)).astype(f32))
        else:
            c = conf9(v["conf"])
            mv, self.release_s = max_vel(c), float(c[7])
            self.env = _Env(c, device)
            self.times = self.up(table[0])
            self.flat = self.up(table[1].reshape(-1))
            self.K, self.W = table[1].shape
        self.amp = 1.0 / mv if mv != 0.0 else 0.0
        self.q = f32(f32(bl) / f32(sr))
        self.fd_np = (np.arange(bl, dtype=np.int64).astype(f32)
                      / f32(sr)).astype(f32)
        self.fd = self.up(self.fd_np)

    def up(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def add(self, out: torch.Tensor, on, off, end, hz, vel) -> None:
        """Adds voices (on, off or -1, end, f32 hz, vel) into out."""
        bl, fd_np = self.bl, self.fd_np
        L = int((end - on).max())
        k0 = on // bl
        K = int(((end - 1) // bl - k0).max()) + 1
        held = _folds(-fd_np[on % bl], K, self.q)              # [V, K]
        released = off >= 0
        koff = np.where(released, off // bl, k0)
        rel = _folds(-fd_np[np.where(released, off, on) % bl], K, self.q)
        # the clock a release captured: f32(held clock + f32(i/sr)) there
        rel_t = np.where(released, held[np.arange(len(on)),
                                        np.clip(koff - k0, 0, K - 1)]
                         + fd_np[np.where(released, off, 0) % bl], f32(0)
                         ).astype(f32)
        up = self.up
        on_t, end_t, off_t = up(on)[:, None], up(end)[:, None], up(off)[:, None]
        f = on_t + torch.arange(L, dtype=torch.int64,
                                device=self.device)[None, :]
        valid = f < end_t
        fc = torch.minimum(f, end_t - 1)
        blk, fi = fc // bl, fc % bl
        t_held = torch.gather(up(held), 1, blk - up(k0)[:, None]) \
            + self.fd[fi]
        t_rel = torch.gather(up(rel), 1, torch.clamp(
            blk - up(koff)[:, None], 0, K - 1)) + self.fd[fi]
        is_held = (off_t < 0) | (fc < off_t)
        rel_tt = up(rel_t)[:, None]
        velt = up(vel.astype(np.float64))[:, None]

        def envelope(env):
            return torch.where(is_held, env.ads(t_held),
                               env.rel(t_rel, env.ads(rel_tt))).double()

        if self.kind == "synth":
            x32 = self.ttab[fc % self.F] * up(hz)[:, None]   # f32(time hz)
            sin = torch.sin((x32 * float(f32(2 * np.pi))).double())
            envs = {c: envelope(env) for c, env in self.envs.items()}
            s = torch.zeros(f.shape, dtype=F64, device=self.device)
            for o, (vol, z, c) in enumerate(self.oscs):
                if vol <= 0:
                    continue
                if o == 0:      # square-sine
                    w = torch.clamp(sin, -z, z) / z
                elif o == 1:    # top-flat sine
                    w = (torch.clamp(sin, max=z) + (1 - z) / 2) \
                        * (2 / (1 + z))
                else:           # triangle
                    x = x32.double()
                    w = 4.0 * torch.abs(x - torch.floor(x + 0.5)) - 1.0
                s = s + w * velt * envs[c] * vol
        else:
            K_, W, flat = self.K, self.W, self.flat
            tau = torch.where(is_held, t_held, t_rel + rel_tt).double()
            cyc = (hz / f32(self.sr)).astype(f32)
            c_fix = up(np.uint32(cyc * f32(2.0 ** 32)).astype(np.int64))
            ph = ((fc - on_t) * c_fix[:, None]) & U32
            phase = ph.to(F32) * float(f32(W / 2.0 ** 32))
            p0 = torch.clamp(torch.floor(phase).long(), 0, W - 1)
            frac = (phase - p0.to(F32)).double()
            p1 = (p0 + 1) % W
            k = torch.zeros_like(p0)
            if K_ > 1:
                k = torch.clamp(torch.searchsorted(self.times, tau,
                                                   right=True) - 1, 0, K_ - 2)
                t_k, t_k1 = self.times[k], self.times[k + 1]
                blend = torch.clamp((tau - t_k) / torch.clamp(
                    t_k1 - t_k, min=1e-9), 0.0, 1.0)
            w = flat[k * W + p0] * (1 - frac) + flat[k * W + p1] * frac
            if K_ > 1:
                w1 = flat[(k + 1) * W + p0] * (1 - frac) \
                    + flat[(k + 1) * W + p1] * frac
                w = w * (1 - blend) + w1 * blend
            s = w * velt * envelope(self.env)
        out.index_add_(0, fc[valid], s[valid])


def voice_sum(kind: str, v: dict, ev, sr: int, bl: int, F: int, passes: int,
              device, table=None) -> torch.Tensor:
    """[passes * F] float64: a Synth's or SampSyn's mono output over the
    passes, before its pan and gain. Voices are computed in batches of
    similar length, CHUNK voice-frames at most (one voice at least)."""
    arm = _Arm(kind, v, sr, bl, F, device, table)
    on, off, end, note, vel = voices_of(ev, sr, bl, F, passes,
                                        arm.release_s,
                                        per_pass=kind == "synth")
    out = torch.zeros(F * passes, dtype=F64, device=device)
    hz = (440.0 * np.exp2((note.astype(np.float64) - 69.0) / 12.0)
          ).astype(f32)
    order = np.argsort(end - on, kind="stable")
    chunk = CHUNK.get(torch.device(device).type, CHUNK["cpu"])
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order) and (j - i + 1) * int(
                end[order[j]] - on[order[j]]) <= chunk:
            j += 1
        sel = order[i:j]
        arm.add(out, on[sel], off[sel], end[sel], hz[sel], vel[sel])
        i = j
    return out * arm.amp


# ---- the session ---------------------------------------------------------------

def pan_gain(y: torch.Tensor, gain, angle) -> torch.Tensor:
    angle = min(max(float(angle), -90.0), 90.0)
    if abs(angle) >= 0.001:
        rad = angle * 0.5 * 0.01745329
        y = y * torch.tensor(
            [math.sqrt(0.5) * (math.cos(rad) + math.sin(rad)),
             math.sqrt(0.5) * (math.cos(rad) - math.sin(rad))],
            dtype=F64, device=y.device)
    gain = float(f32(gain))
    if abs(gain - 1.0) >= 0.001:
        y = y * gain
    return y


def bf16(y: torch.Tensor) -> torch.Tensor:
    """y rounded to bfloat16 (the control's lower precision)."""
    return y.to(F32).to(torch.bfloat16).to(F64)


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
    for a, b in spec["edges"]:
        ins[b].append(a)

    def run(name):
        v = verts[name]
        k = v["kind"]
        if k in ("synth", "sampsyn"):
            ev = read_midi(d / spec["midi"][v["floww"]])
            table = None
            if k == "sampsyn":
                times, waves = read_wavetable(d / spec["tables"][v["table"]])
                table = (np.asarray(times, np.float64),
                         np.asarray(waves, np.float64))
            y = voice_sum(k, v, ev, sr, bl, F, passes, device, table)
            y = y[:, None].expand(N, 2)
        else:
            y = torch.zeros(N, 2, dtype=F64, device=device)
            for a in ins[name]:
                y = y + run(a)
            if k == "normalize":
                peaks = y.abs().reshape(-1, bl, 2).amax(dim=(1, 2))
                m = torch.cummax(torch.clamp(peaks, min=1e-6), dim=0).values
                y = y / m.repeat_interleave(bl)[:, None]
            elif k != "sum":
                raise ValueError(f"the instrument reference has no kind {k!r}")
        return cast(pan_gain(y, v.get("gain", 1.0), v.get("angle", 0.0)))

    return run(spec["output"])


def amplitude(bd: int) -> float:
    return float((1 << (bd - 1)) - 1) if bd < 32 else float(2 ** 31 - 1)


def bounce(spec: dict, d, renders: int, device=None,
           cast=None) -> np.ndarray:
    """Render number `renders` of a State that rendered back to back
    from a fresh start, scaled to the WAV's integer range (before the
    truncation), [frames, 2] on the host."""
    passes = min(int(renders), 3)
    x = render_passes(spec, d, passes, device, cast)
    last = x[(passes - 1) * song_frames(spec):] * amplitude(int(spec["bd"]))
    return (cast(last) if cast else last).cpu().numpy()
