"""The least work of an instrument session's SampSyn voices (projects/
poly_session.py), from its spec and its raw files (not from what the
program launches), for the SampSyn kernel's roofline. A voice sounds from
its note-on until its release has run or a note-off of its pitch drops
it (benchmark/reference/poly.py's rules); a bounce is a render after the
first, whose voices include those the render before left sounding.

Operations: the sounding voice-frames times ops/synthv.py's float32
operations a live slot-frame (SAMPSYN_FLOPS, and SAMPSYN_BLEND_FLOPS more
with K > 1 snapshots), copied here. Bytes: each table and each voice's
note columns (on, off and end frames, velocity, phase increment, release
clock) read once, its two block clocks and its slot entry once a block it
sounds in, and each track's [T, 2] float32 mix written once. It reuses
harness/work.py's peaks and least time."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.harness.work import F32, PEAKS, least_s
from benchmark.reference import files, poly

__all__ = ["PEAKS", "least_s", "sampsyn_work"]

SAMPSYN_FLOPS = 18
SAMPSYN_BLEND_FLOPS = 10
NOTE_COLUMNS = 6


def sampsyn_work(spec: dict, d) -> tuple[float, float]:
    """(f32 flops, bytes) of one bounce's SampSyn voices."""
    d = Path(d)
    sr, bl = int(spec["sr"]), int(spec["bl"])
    F = poly.song_frames(spec)
    flops = nbytes = 0.0
    for v in spec["vertices"]:
        if v["kind"] != "sampsyn":
            continue
        K, W = files.read_wavetable(d / spec["tables"][v["table"]])[1].shape
        c = poly.conf9(v["conf"])
        rel = int(round(float(c[7]) * sr))
        on, off, end, _, _ = poly.voices_of(
            files.read_midi(d / spec["midi"][v["floww"]]), sr, bl, F, 2,
            float(c[7]), per_pass=False)
        end = np.where(off >= 0, np.minimum(end, off + rel), end)
        lo, hi = np.maximum(on, F), np.minimum(end, 2 * F)
        live = hi > lo
        lo, hi = lo[live], hi[live]
        blocks = (hi - 1) // bl - lo // bl + 1
        per = SAMPSYN_FLOPS + (SAMPSYN_BLEND_FLOPS if K > 1 else 0)
        flops += float((hi - lo).sum()) * per
        nbytes += (K * W + K) * F32 + len(lo) * NOTE_COLUMNS * F32 \
            + float(blocks.sum()) * 3 * F32 + F * 2 * F32
    return flops, nbytes
