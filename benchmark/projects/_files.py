"""File writers the project generators use: 16-bit PCM WAV, a one-track
Standard MIDI File and the TDWT wavetable, with the drum-hit and default
wavetable generators.

Frozen copies of the program's fixture writers (its `utils/fixtures.drum`,
`fileio/midi.write_midi`, `fileio/wavetable.WaveTable.default` and
`write_wavetable`), kept here so that the benchmark's inputs stay the same
whatever the program's own helpers become.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def write_wav16(path: Path, data: np.ndarray, sr: int) -> None:
    """[frames, 2] float in [-1, 1] as 16-bit PCM: scaled by 32767,
    clipped and truncated toward zero."""
    ints = np.clip(np.trunc(np.asarray(data, np.float64).reshape(-1) * 32767.0),
                   -32768, 32767).astype("<i2")
    raw = ints.tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 2, sr, sr * 4, 4, 16)
           + b"data" + struct.pack("<I", len(raw)))
    Path(path).write_bytes(hdr + raw)


def drum(path: Path, sr: int, dur: float, freq: float, decay: float,
         noise: float = 0.0, seed: int = 0) -> None:
    """A decaying pitch-swept hit, peak 0.9, as a 16-bit stereo WAV."""
    t = np.arange(int(sr * dur)) / sr
    body = np.exp(-t * decay) * np.sin(2 * np.pi * freq * t * np.exp(-t * 4))
    if noise > 0:
        rng = np.random.default_rng(seed)
        body = body + noise * np.exp(-t * decay * 2) * rng.standard_normal(
            len(t))
    body = (0.9 * body / np.max(np.abs(body))).astype(np.float32)
    write_wav16(path, np.stack([body, body], 1), sr)


def write_midi(path: Path, notes: list, tpq: int = 480,
               bpm: float = 120.0) -> None:
    """A single-track SMF of (start_s, dur_s, note, velocity 0-127)."""
    spt = 60.0 / (bpm * tpq)
    events = []
    for start, dur, note, vel in notes:
        events.append((round(start / spt), 0x90, int(note), int(vel)))
        events.append((round((start + dur) / spt), 0x80, int(note), 0))
    events.sort(key=lambda e: (e[0], e[1]))

    def varlen(v: int) -> bytes:
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        return bytes(reversed(out))

    body = bytearray()
    body += varlen(0) + bytes([0xFF, 0x51, 0x03]) + round(
        60e6 / bpm).to_bytes(3, "big")
    tick = 0
    for t, status, note, vel in events:
        body += varlen(t - tick) + bytes([status, note, vel])
        tick = t
    body += varlen(0) + bytes([0xFF, 0x2F, 0x00])
    blob = b"MThd" + struct.pack(">IHHH", 6, 0, 1, tpq)
    blob += b"MTrk" + struct.pack(">I", len(body)) + bytes(body)
    Path(path).write_bytes(blob)


def default_wavetable() -> tuple[np.ndarray, np.ndarray]:
    """(times [2], waves [2, 2048]) float32: a 16-harmonic saw-like wave
    morphing into a sine over one second."""
    w = 2048
    x = np.arange(w) / w
    rich = np.zeros(w, np.float64)
    for h in range(1, 17):
        rich += np.sin(2 * np.pi * h * x) / h
    rich /= np.max(np.abs(rich))
    sine = np.sin(2 * np.pi * x)
    return (np.asarray([0.0, 1.0], np.float32),
            np.stack([rich, sine]).astype(np.float32))


def write_wavetable(path: Path, times: np.ndarray, waves: np.ndarray) -> None:
    k, w = waves.shape
    Path(path).write_bytes(
        b"TDWT" + struct.pack("<III", 1, k, w)
        + np.asarray(times, "<f4").tobytes()
        + np.asarray(waves, "<f4").tobytes())


def encode_events(stream: str, events: np.ndarray) -> bytes:
    """One floww EVENTS packet: u8 kind 0x01, u16 name length, the UTF-8
    name, u32 row count, then float32 rows (id, t_s, note, vel), all
    little-endian."""
    name = stream.encode()
    ev = np.ascontiguousarray(events, "<f4").reshape(-1, 4)
    return (struct.pack("<BH", 0x01, len(name)) + name
            + struct.pack("<I", ev.shape[0]) + ev.tobytes())
