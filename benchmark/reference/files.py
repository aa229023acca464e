"""Readers of the project's raw files, independent of the program's:
PCM WAV (stdlib `wave`), Standard MIDI Files and TDWT wavetables."""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np


def read_wav_ints(path) -> tuple[np.ndarray, int, int]:
    """([frames, channels] int64 counts, rate, bits) of a PCM WAV."""
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
    return v.reshape(-1, ch), rate, 8 * width


def read_midi(path) -> np.ndarray:
    """[n, 3] float64 rows (t_s, note, vel 0-1; note-offs vel 0) of an SMF
    with a tempo map, merged over tracks in tick order (stable)."""
    blob = Path(path).read_bytes()
    if blob[:4] != b"MThd":
        raise ValueError(f"not a MIDI file: {path}")
    hlen = struct.unpack_from(">I", blob, 4)[0]
    _fmt, _n, tpq = struct.unpack_from(">HHH", blob, 8)
    pos = 8 + hlen
    merged = []
    while pos + 8 <= len(blob):
        cid, clen = blob[pos:pos + 4], struct.unpack_from(">I", blob, pos + 4)[0]
        body = blob[pos + 8:pos + 8 + clen]
        pos += 8 + clen
        if cid != b"MTrk":
            continue
        p, tick, running = 0, 0, 0
        while p < len(body):
            delta = 0
            while True:
                b = body[p]
                p += 1
                delta = (delta << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            tick += delta
            st = body[p]
            if st & 0x80:
                p += 1
                if st < 0xF0:
                    running = st
            else:
                st = running
            kind = st & 0xF0
            if kind in (0x80, 0x90):
                note, vel = body[p], body[p + 1]
                p += 2
                on = kind == 0x90 and vel > 0
                merged.append((tick, 1 if on else 0, note, vel if on else 0))
            elif kind in (0xA0, 0xB0, 0xE0):
                p += 2
            elif kind in (0xC0, 0xD0):
                p += 1
            elif st == 0xFF:
                mtype = body[p]
                p += 1
                ln = 0
                while True:
                    b = body[p]
                    p += 1
                    ln = (ln << 7) | (b & 0x7F)
                    if not b & 0x80:
                        break
                if mtype == 0x51:
                    merged.append((tick, 2, int.from_bytes(
                        body[p:p + 3], "big"), 0))
                p += ln
            else:
                raise ValueError(f"unhandled MIDI status {st:#x}")
    merged.sort(key=lambda e: e[0])
    rows, uspq, last_tick, last_s = [], 500000, 0, 0.0
    for tick, kind, a, b in merged:
        s = last_s + (tick - last_tick) * (uspq / 1e6) / tpq
        if kind == 2:
            uspq, last_tick, last_s = a, tick, s
            continue
        rows.append((s, float(a), b / 127.0 if kind == 1 else 0.0))
    return np.asarray(rows, np.float64).reshape(-1, 3)


def read_wavetable(path) -> tuple[np.ndarray, np.ndarray]:
    buf = Path(path).read_bytes()
    if buf[:4] != b"TDWT":
        raise ValueError(f"not a TDWT wavetable: {path}")
    _v, k, w = struct.unpack_from("<III", buf, 4)
    times = np.frombuffer(buf, "<f4", k, 16).astype(np.float64)
    waves = np.frombuffer(buf, "<f4", k * w, 16 + 4 * k).reshape(k, w)
    return times, waves.astype(np.float64)
