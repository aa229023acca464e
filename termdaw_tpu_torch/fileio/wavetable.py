"""Carried over from termdaw_tpu/fileio/wavetable.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Time-varying wavetable format + default table.

The reference's SampSyn vertex uses the external `sampsyn` crate's opaque
`.wtable` files (reference state.rs:415-422, extensions.rs:531-578): a table
of waveform snapshots evolving over the life of a note. That format isn't
available, so the framework owns one (documented deviation — the graph
semantics and the load/parse/fallback behavior match the reference;
the on-disk bytes are first-party):

    magic   b"TDWT"
    u32     version (1)
    u32     K   number of snapshots
    u32     W   waveform length (samples per cycle)
    f32[K]      snapshot times, seconds since note-on, ascending from 0
    f32[K*W]    waveforms, row-major

Like the reference, an unparseable buffer falls back to a default table with
a console warning (state.rs:415-422). The default table morphs from a
16-harmonic sawtooth-ish wave into a pure sine over 1 second.

Synthesis semantics (ops/wavetable kernel): a note at frequency hz and age
tau seconds reads the table at phase frac(hz * age) with linear interpolation
within the waveform and linear blending between the two snapshots
surrounding tau (clamped at the ends).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"TDWT"


@dataclass
class WaveTable:
    times: np.ndarray  # [K] float32, ascending
    waves: np.ndarray  # [K, W] float32

    @staticmethod
    def default() -> "WaveTable":
        w = 2048
        x = np.arange(w) / w
        rich = np.zeros(w, np.float64)
        for h in range(1, 17):
            rich += np.sin(2 * np.pi * h * x) / h
        rich /= np.max(np.abs(rich))
        sine = np.sin(2 * np.pi * x)
        times = np.asarray([0.0, 1.0], np.float32)
        waves = np.stack([rich, sine]).astype(np.float32)
        return WaveTable(times, waves)


def parse_wavetable_from_buffer(buf: bytes) -> WaveTable | None:
    """Parse, returning None on any malformation (reference
    parse_wavetable_from_buffer returns Option, state.rs:415)."""
    try:
        if len(buf) < 16 or buf[:4] != MAGIC:
            return None
        version, k, w = struct.unpack_from("<III", buf, 4)
        if version != 1 or k < 1 or w < 2:
            return None
        need = 16 + 4 * k + 4 * k * w
        if len(buf) < need:
            return None
        times = np.frombuffer(buf, dtype="<f4", count=k, offset=16).astype(
            np.float32
        )
        waves = np.frombuffer(
            buf, dtype="<f4", count=k * w, offset=16 + 4 * k
        ).reshape(k, w).astype(np.float32)
        if np.any(np.diff(times) < 0):
            return None
        return WaveTable(times, waves)
    except Exception:
        return None


def write_wavetable(path, table: WaveTable) -> None:
    k, w = table.waves.shape
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<III", 1, k, w))
        f.write(np.asarray(table.times, "<f4").tobytes())
        f.write(np.asarray(table.waves, "<f4").tobytes())
