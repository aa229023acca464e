"""Carried over from termdaw_tpu/fileio/packets.py, so that the port imports
nothing of termdaw_tpu; the decoder runs its numpy path only (the
reference's native frame scanner is not used); the packets are the same.

First-party floww packet protocol for the stream workflow.

The reference decodes binary `FlowwPacket`s from stdin via the external
`floww` crate (reference stream_workflow.rs:31-36, floww.rs:55-57). That
wire format is not available here, so the framework owns one:

Little-endian framing, one packet per frame:

    u8   kind        0x01 = EVENTS, 0x02 = TEXT
    kind 0x01 (append events to a named stream):
        u16  name_len,  name_len bytes of UTF-8 stream name
        u32  n_events
        n_events x (f32 id, f32 t_sec, f32 note, f32 vel)
    kind 0x02 (text message, echoed to the user):
        u32  text_len,  text_len bytes of UTF-8

`unpacket` routes EVENTS packets into the named flowws and returns the TEXT
messages, mirroring the reference's `append_streams -> Vec<String>`
(floww.rs:55-57). Unknown stream names are ignored with the name returned as
a message, so a producer targeting a not-yet-declared stream is visible.

"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

KIND_EVENTS = 0x01
KIND_TEXT = 0x02


class PacketError(ValueError):
    pass


@dataclass
class FlowwPacket:
    kind: int
    name: str = ""           # EVENTS: stream name
    events: np.ndarray | None = None  # EVENTS: [n, 4] float32 (id, t, note, vel)
    text: str = ""           # TEXT


def encode_events(name: str, events: np.ndarray) -> bytes:
    ev = np.asarray(events, dtype="<f4").reshape(-1, 4)
    nb = name.encode("utf-8")
    return (
        struct.pack("<BH", KIND_EVENTS, len(nb))
        + nb
        + struct.pack("<I", ev.shape[0])
        + ev.tobytes()
    )


def encode_text(text: str) -> bytes:
    tb = text.encode("utf-8")
    return struct.pack("<BI", KIND_TEXT, len(tb)) + tb


class PacketDecoder:
    """Incremental decoder: feed bytes, yields complete packets."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[FlowwPacket]:
        self._buf += data
        out: list[FlowwPacket] = []
        while True:
            pkt, consumed = self._try_decode()
            if pkt is None:
                break
            out.append(pkt)
            del self._buf[:consumed]
        return out

    def _try_decode(self) -> tuple[FlowwPacket | None, int]:
        buf = self._buf
        if len(buf) < 1:
            return None, 0
        kind = buf[0]
        if kind == KIND_EVENTS:
            if len(buf) < 3:
                return None, 0
            (name_len,) = struct.unpack_from("<H", buf, 1)
            pos = 3 + name_len
            if len(buf) < pos + 4:
                return None, 0
            name = bytes(buf[3:pos]).decode("utf-8")
            (n,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            nbytes = n * 16
            if len(buf) < pos + nbytes:
                return None, 0
            ev = np.frombuffer(bytes(buf[pos : pos + nbytes]), dtype="<f4")
            ev = ev.reshape(n, 4).astype(np.float32)
            return FlowwPacket(KIND_EVENTS, name=name, events=ev), pos + nbytes
        if kind == KIND_TEXT:
            if len(buf) < 5:
                return None, 0
            (tlen,) = struct.unpack_from("<I", buf, 1)
            if len(buf) < 5 + tlen:
                return None, 0
            text = bytes(buf[5 : 5 + tlen]).decode("utf-8")
            return FlowwPacket(KIND_TEXT, text=text), 5 + tlen
        raise PacketError(f"unknown packet kind {kind:#x}")
