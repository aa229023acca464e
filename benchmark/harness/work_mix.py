"""The least work of the recurrences a mix session asks for (projects/
mix_session.py), from its spec, for the scan family's roofline: each
track's tape one-pole, the compressors' followers and smoothing, the
eq3s' four biquad stages, the reverb's lines and the delay's comb. It
reuses harness/work.py's peaks, families and per-recurrence counts."""

from __future__ import annotations

from benchmark.harness.work import (F32, PEAKS, _frames, _linear, family_of,
                                    least_s)

__all__ = ["PEAKS", "family_of", "least_s", "scan_work"]


def scan_work(spec: dict) -> tuple[float, float]:
    """(f32 flops, bytes) of one bounce's recurrences at the project
    rate."""
    T = _frames(spec)
    flops = nbytes = 0.0

    def add(w):
        nonlocal flops, nbytes
        flops += w[0]
        nbytes += w[1]

    for v in spec["vertices"]:
        if v["kind"] != "fx":
            continue
        kind = spec["plugins"][v["plugin"]]["kind"]
        if kind == "tape":
            add(_linear(T, 2))                    # low-pass one-pole
        elif kind == "compressor":
            add((2.0 * T, 2.0 * F32 * T))         # envelope follower
            add(_linear(T, 1))                    # smoothing
        elif kind == "eq3":
            for _ in range(4):
                add(_linear(T, 4, order=2))       # biquad stages
        elif kind == "reverb":
            add(_linear(T, 2))                    # input damping
            for _ in range(16):
                add(_linear(T, 1))                # comb lines
            for _ in range(4):
                add(_linear(T, 2))                # allpass feedback
        elif kind == "delay":
            add(_linear(T, 2))
    return flops, nbytes
