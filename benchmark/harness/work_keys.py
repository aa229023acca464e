"""The least work of a sampled-instrument session's voice mixes (projects/
piano_session.py), from its spec and its raw files (not from what the
program launches), for the voice mix kernel's roofline. A hit sounds its
whole sample from its frame on (benchmark/reference/keys.py's rules); a
bounce is a render after the first, whose voices include those the
render before left ringing.

Operations: a multiply and an add a sounding voice-frame a channel.
Bytes: each frame of a sample that some voice sounds in the bounce read
once (both channels), however many voices sound it; each voice's table
entry (begin and two amps) once a block it sounds in; and each voice
mix's [T, 2] float32 output written once (a fused group's, or a lone
SampleMulti's). It reuses harness/work.py's peaks and least time."""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np

from benchmark.harness.work import F32, PEAKS, least_s
from benchmark.reference import keys

__all__ = ["PEAKS", "least_s", "voicemix_work"]

ENTRY = 3 * F32     # a slot's begin and its two channel amps


def _union(spans: np.ndarray) -> int:
    """The length of the union of [lo, hi) rows."""
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    lo, hi = spans[:, 0], spans[:, 1]
    before = np.maximum.accumulate(np.concatenate([[lo[0]], hi[:-1]]))
    return int(np.clip(hi - np.maximum(lo, before), 0, None).sum())


def voicemix_work(spec: dict, d, sample_frames: dict) -> tuple[float, float]:
    """(f32 flops, bytes) of one bounce's voice mixes. `sample_frames`
    gives each sample's length at the project rate."""
    bl = int(spec["bl"])
    F = keys.song_frames(spec)
    multis = {v["name"]: v for v in spec["vertices"]
              if v["kind"] == "sample_multi"}
    frames = blocks = 0
    read: dict = defaultdict(list)     # sample -> [lo, hi) offsets sounded
    for name, (fr, _) in keys.hits(spec, d, 2).items():
        sample = multis[name]["sample"]
        lo = np.maximum(fr, F)
        hi = np.minimum(fr + sample_frames[sample], 2 * F)
        live = hi > lo
        fr, lo, hi = fr[live], lo[live], hi[live]
        frames += int((hi - lo).sum())
        blocks += int(((hi - 1) // bl - lo // bl + 1).sum())
        if len(fr):
            read[sample].append(np.stack([lo - fr, hi - fr], 1))
    touched = sum(_union(np.concatenate(s)) for s in read.values())
    consumers = Counter(b for a, b in spec["edges"] if a in multis)
    mixes = sum(1 if n >= 2 else n for n in consumers.values())
    flops = 2.0 * 2 * frames
    nbytes = 2.0 * F32 * touched + ENTRY * blocks + mixes * F * 2 * F32
    return flops, nbytes
