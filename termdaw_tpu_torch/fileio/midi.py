"""Carried over from termdaw_tpu/fileio/midi.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Standard MIDI File (SMF) parser -> floww event arrays.

Replaces the reference's `floww::read_floww_from_midi` (reference
floww.rs:40-48, Cargo.toml:23). Parses format 0/1/2 files with a tempo map
and emits note events as float32 rows (id, t_sec, note, vel):

* `t_sec`  — absolute event time in seconds (tempo-map aware),
* `note`   — MIDI note number as float,
* `vel`    — velocity scaled to [0, 1]; note-off (or note-on with velocity
             0) emits vel 0.0, matching the floww convention that
             vel <= 0.001 means note-off (reference floww.rs:114, 134),
* `id`     — the MIDI channel (the reference ignores field .0; we store
             something useful).

Events from all tracks are merged in time order (stable by track).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


class MidiError(ValueError):
    pass


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    val = 0
    while True:
        if pos >= len(data):
            raise MidiError("truncated variable-length quantity")
        b = data[pos]
        pos += 1
        val = (val << 7) | (b & 0x7F)
        if not (b & 0x80):
            return val, pos


def _parse_track(data: bytes) -> list[tuple[int, int, int, int, int]]:
    """Parse one MTrk chunk body.

    Returns a list of (tick, kind, a, b, channel) where kind is:
    0 = note-off, 1 = note-on, 2 = tempo change (a = microseconds/quarter).
    """
    try:
        return _parse_track_inner(data)
    except IndexError:
        # a truncated MTrk body reads past the end mid-event; surface it
        # as MidiError so FlowwBank.add_floww's handler excludes the file
        # instead of the IndexError crashing refresh()
        raise MidiError("truncated MIDI track body") from None


def _parse_track_inner(data: bytes) -> list[tuple[int, int, int, int, int]]:
    events = []
    pos = 0
    tick = 0
    running = 0
    while pos < len(data):
        delta, pos = _read_varlen(data, pos)
        tick += delta
        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running = status
        else:
            status = running
            if not (status & 0x80):
                raise MidiError("running status without prior status byte")
        kind = status & 0xF0
        chan = status & 0x0F
        if kind == 0x90:  # note on
            note, vel = data[pos], data[pos + 1]
            pos += 2
            events.append((tick, 0 if vel == 0 else 1, note, vel, chan))
        elif kind == 0x80:  # note off
            note, vel = data[pos], data[pos + 1]
            pos += 2
            events.append((tick, 0, note, vel, chan))
        elif kind in (0xA0, 0xB0, 0xE0):  # 2-byte messages we skip
            pos += 2
        elif kind in (0xC0, 0xD0):  # 1-byte messages we skip
            pos += 1
        elif status == 0xFF:  # meta
            mtype = data[pos]
            pos += 1
            length, pos = _read_varlen(data, pos)
            if mtype == 0x51 and length == 3:
                uspq = (data[pos] << 16) | (data[pos + 1] << 8) | data[pos + 2]
                events.append((tick, 2, uspq, 0, 0))
            pos += length
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_varlen(data, pos)
            pos += length
        else:
            raise MidiError(f"unhandled MIDI status byte {status:#x}")
    return events


def read_floww_from_midi(path: str | Path) -> np.ndarray:
    """Parse an SMF file into a float32 floww array of shape [n, 4]:
    columns (id, t_sec, note, vel)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 14 or blob[0:4] != b"MThd":
        raise MidiError(f"not an SMF file: {path}")
    (hlen,) = struct.unpack_from(">I", blob, 4)
    fmt, ntrks, division = struct.unpack_from(">HHH", blob, 8)
    pos = 8 + hlen

    if division & 0x8000:
        # SMPTE: frames/sec * ticks/frame => fixed seconds per tick
        fps = 256 - ((division >> 8) & 0xFF)  # stored as negative
        tpf = division & 0xFF
        sec_per_tick_fixed = 1.0 / (fps * tpf)
        tpq = None
    else:
        tpq = division if division > 0 else 480
        sec_per_tick_fixed = None

    tracks = []
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        (clen,) = struct.unpack_from(">I", blob, pos + 4)
        body = blob[pos + 8 : pos + 8 + clen]
        if cid == b"MTrk":
            tracks.append(_parse_track(body))
        pos += 8 + clen

    if fmt == 2:
        # format 2: independent tracks; treat sequentially is unusual —
        # merge like format 1 (rare in practice)
        pass

    # merge, stable by (tick, track order)
    merged: list[tuple[int, int, int, int, int]] = []
    for tr in tracks:
        merged.extend(tr)
    merged.sort(key=lambda e: e[0])

    rows = []
    if sec_per_tick_fixed is not None:
        for tick, kind, a, b, chan in merged:
            if kind == 2:
                continue
            t = tick * sec_per_tick_fixed
            vel = (b / 127.0) if kind == 1 else 0.0
            rows.append((float(chan), t, float(a), vel))
    else:
        # tempo map: piecewise-linear ticks->seconds
        uspq = 500000  # default 120 bpm
        last_tick = 0
        last_sec = 0.0
        for tick, kind, a, b, chan in merged:
            sec = last_sec + (tick - last_tick) * (uspq / 1e6) / tpq
            if kind == 2:
                uspq = a
                last_tick, last_sec = tick, sec
                continue
            vel = (b / 127.0) if kind == 1 else 0.0
            rows.append((float(chan), sec, float(a), vel))

    if not rows:
        return np.zeros((0, 4), dtype=np.float32)
    return np.asarray(rows, dtype=np.float32)


def write_midi(
    path: str | Path,
    notes: list[tuple[float, float, int, int]],
    tpq: int = 480,
    bpm: float = 120.0,
) -> None:
    """Write a minimal single-track SMF (test fixture helper).

    `notes` is a list of (start_sec, dur_sec, note, velocity_0_127)."""
    spt = 60.0 / (bpm * tpq)  # seconds per tick
    events: list[tuple[int, int, int, int]] = []
    for start, dur, note, vel in notes:
        on_tick = round(start / spt)
        off_tick = round((start + dur) / spt)
        events.append((on_tick, 0x90, note, vel))
        events.append((off_tick, 0x80, note, 0))
    events.sort(key=lambda e: (e[0], e[1]))

    def varlen(v: int) -> bytes:
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        return bytes(reversed(out))

    body = bytearray()
    # tempo meta
    uspq = round(60e6 / bpm)
    body += varlen(0) + bytes([0xFF, 0x51, 0x03]) + uspq.to_bytes(3, "big")
    tick = 0
    for t, status, note, vel in events:
        body += varlen(t - tick) + bytes([status, note, vel])
        tick = t
    body += varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    blob = b"MThd" + struct.pack(">IHHH", 6, 0, 1, tpq)
    blob += b"MTrk" + struct.pack(">I", len(body)) + bytes(body)
    with open(path, "wb") as f:
        f.write(blob)
