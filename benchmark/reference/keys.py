"""The plain reference of a sampled-instrument session (projects/
piano_session.py), in plain PyTorch float64: tracks of SampleMultis, one a
key and velocity layer, playing MIDI parts in drum mode, track and bus
Sums, the block-wise Normalize and the 24-bit scale, from termdaw's rules
as benchmark/reference/voices.py states them. It imports nothing of the
program, of JAX or of the JAX package, and no compiled kernel; it reads
only the project's raw files (WAV samples, MIDI) and spec, and runs on
whichever device it is handed (the check runs it on the card).

- Samples: loaded as reference/render.py's `load_sample` loads them (raw
  counts, peak-normalised over both channels; the session's samples are
  at the project rate).
- Triggers: reference/voices.py's `drum_hits` over its `Timeline` of the
  back-to-back renders: at each frame the first on-event of a floww
  triggers, if its note is the vertex's; the frame's other on-events are
  passed over.
- Voices: each hit adds vel * sample[:n] from its frame on, the whole
  sample, on the timeline of the renders: a voice rings across windows
  and past the song's end into the next render (set_time keeps a
  SampleMulti voice's elapsed time). A render's third pass from a fresh
  start stands for every later one where every sample is shorter than
  the song: the voices entering it are those entering the second, and
  the Normalize's peak no longer grows.
- Sum: inputs added; a vertex's output is angle, then gain (each skipped
  within 0.001 of neutral; reference/poly.py's `pan_gain`). Normalize:
  each block divided by the running maximum of the block peaks since the
  session's start (at least 1e-6).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .files import read_midi
from .poly import amplitude, bf16, pan_gain, song_frames
from .render import load_sample
from .voices import Timeline, drum_hits

__all__ = ["bf16", "bounce", "hits", "render_passes", "song_frames"]

F64 = torch.float64


def hits(spec: dict, d, passes: int) -> dict:
    """{SampleMulti name: (frames, vels)} of the hits on the timeline of
    `passes` renders, from the project's MIDI files."""
    d = Path(d)
    sr, bl = int(spec["sr"]), int(spec["bl"])
    tl = Timeline(sr, bl, song_frames(spec) // bl, passes)
    ev = {name: read_midi(d / f) for name, f in spec["midi"].items()}
    out = {}
    for v in spec["vertices"]:
        if v["kind"] == "sample_multi":
            note = None if float(v.get("note", -1)) < 0 else float(v["note"])
            out[v["name"]] = drum_hits(tl, ev[v["floww"]], note)
    return out


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
    struck = hits(spec, d, passes)
    samples: dict = {}

    def sample(name):
        if name not in samples:
            x = load_sample(d / spec["samples"][name], sr)
            if len(x) >= F:
                raise ValueError("the keys reference needs every sample "
                                 "shorter than the song")
            samples[name] = torch.from_numpy(x).to(device)
        return samples[name]

    def run(name):
        v = verts[name]
        k = v["kind"]
        y = torch.zeros(N, 2, dtype=F64, device=device)
        if k == "sample_multi":
            s = sample(v["sample"])
            for f, vel in zip(*struck[name]):
                n = min(len(s), N - int(f))
                y[int(f):int(f) + n] += vel * s[:n]
        else:
            for a in ins[name]:
                y += run(a)
            if k == "normalize":
                peaks = y.abs().reshape(-1, bl, 2).amax(dim=(1, 2))
                m = torch.cummax(torch.clamp(peaks, min=1e-6), dim=0).values
                y = y / m.repeat_interleave(bl)[:, None]
            elif k != "sum":
                raise ValueError(f"the keys reference has no kind {k!r}")
        return cast(pan_gain(y, v.get("gain", 1.0), v.get("angle", 0.0)))

    return run(spec["output"])


def bounce(spec: dict, d, renders: int, device=None,
           cast=None) -> np.ndarray:
    """Render number `renders` of a State that rendered back to back
    from a fresh start, scaled to the WAV's integer range (before the
    truncation), [frames, 2] on the host."""
    passes = min(int(renders), 3)
    x = render_passes(spec, d, passes, device, cast)
    last = x[(passes - 1) * song_frames(spec):] * amplitude(int(spec["bd"]))
    return (cast(last) if cast else last).cpu().numpy()
