"""Carried over from termdaw_tpu/fileio/packets.py, so that the port imports
nothing of termdaw_tpu. With the native library loaded (native/, the
port's copy of the reference's frame scanner), `PacketDecoder.feed`
takes the scanner's spans, at most 4096 frames a feed, and raises
`PacketError` where the scanner rejects the stream: an unknown kind
(code -1) or a declared size over its guard (code -2: more than 2^24
events, or more than 2^28 bytes of text), as the reference does. It
decodes each span in place, where the reference copies the rest of the
buffer for every frame. Without the library (TERMDAW_NATIVE=0) it runs
the reference's numpy loop, which has no size guard; the packets of a
well-formed stream are the same either way.

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

from .. import native

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
        # native frame scanner finds all complete frame spans in one pass
        try:
            spans = native.scan_frames(self._buf)
        except ValueError as e:
            raise PacketError(str(e)) from None
        if spans is not None:
            end = 0
            for off, length in spans:
                pkt, end = self._try_decode(off)
                assert pkt is not None and end == off + length
                out.append(pkt)
            del self._buf[:end]
            return out
        while True:
            pkt, consumed = self._try_decode()
            if pkt is None:
                break
            out.append(pkt)
            del self._buf[:consumed]
        return out

    def _try_decode(self, off: int = 0) -> tuple[FlowwPacket | None, int]:
        """The frame starting at byte `off` of the buffer, decoded in place,
        and the offset just past it; (None, 0) while it is incomplete."""
        buf = self._buf
        if len(buf) < off + 1:
            return None, 0
        kind = buf[off]
        if kind == KIND_EVENTS:
            if len(buf) < off + 3:
                return None, 0
            (name_len,) = struct.unpack_from("<H", buf, off + 1)
            pos = off + 3 + name_len
            if len(buf) < pos + 4:
                return None, 0
            name = bytes(buf[off + 3:pos]).decode("utf-8")
            (n,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            nbytes = n * 16
            if len(buf) < pos + nbytes:
                return None, 0
            ev = np.frombuffer(buf, dtype="<f4", count=4 * n, offset=pos)
            ev = ev.reshape(n, 4).astype(np.float32)
            return FlowwPacket(KIND_EVENTS, name=name, events=ev), pos + nbytes
        if kind == KIND_TEXT:
            if len(buf) < off + 5:
                return None, 0
            (tlen,) = struct.unpack_from("<I", buf, off + 1)
            if len(buf) < off + 5 + tlen:
                return None, 0
            text = bytes(buf[off + 5:off + 5 + tlen]).decode("utf-8")
            return FlowwPacket(KIND_TEXT, text=text), off + 5 + tlen
        raise PacketError(f"unknown packet kind {kind:#x}")
