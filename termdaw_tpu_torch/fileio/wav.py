"""Carried over from termdaw_tpu/fileio/wav.py, so that the port imports
nothing of termdaw_tpu.

First-party WAV (RIFF) codec.

Replaces the reference's `hound` crate (reference sample.rs:231-274 read path,
state.rs:508-574 write path). Supports:

* read: PCM int 8/16/24/32-bit, IEEE float 32/64-bit, any channel count,
  including WAVE_FORMAT_EXTENSIBLE headers.
* write: PCM int 8/16/24/32-bit interleaved stereo/mono.

Semantics notes vs the reference:

* hound yields 8-bit PCM as signed via an unsigned-to-signed shift; we mirror
  that (`raw - 128`).
* Int samples are returned as raw float32 counts (NOT scaled to [-1, 1]) —
  the reference reads `s as f32` with the scale divide commented out
  (sample.rs:268-274); its subsequent peak-normalization makes the scale moot.
  A `scale=True` option is provided for general use.

A C++ fast path (termdaw_tpu_torch/native/wavio.cpp, the port's copy of
the reference's) packs and unpacks 24-bit samples; this module falls back
to the numpy bodies (`_unpack24_np`, `_pack24_np`, the same bytes) when
the native library is not loaded (TERMDAW_NATIVE=0, no compiler).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import native
from ..utils.prof import Span, span

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavSpec:
    channels: int
    sample_rate: int
    bits_per_sample: int
    sample_format: str  # "int" | "float"


class WavError(ValueError):
    pass


def _unpack24(raw: bytes) -> np.ndarray:
    """Unpack little-endian signed 24-bit PCM into int32."""
    nat = native.unpack24(raw)
    if nat is not None:
        return nat
    return _unpack24_np(raw)


def _unpack24_np(raw: bytes) -> np.ndarray:
    """_unpack24's numpy body."""
    b = np.frombuffer(raw, dtype=np.uint8)
    n = len(b) // 3
    b = b[: n * 3].reshape(n, 3)
    out = (
        b[:, 0].astype(np.int32)
        | (b[:, 1].astype(np.int32) << 8)
        | (b[:, 2].astype(np.int32) << 16)
    )
    # sign-extend from 24 bits
    out = np.where(out & 0x800000, out - 0x1000000, out)
    return out.astype(np.int32)


def _pack24(vals: np.ndarray) -> np.ndarray:
    """Pack int32 (already clipped to 24-bit range) into little-endian
    24-bit: a flat uint8 array, 3 bytes a sample, which a file takes as
    it is."""
    nat = native.pack24(vals)
    if nat is not None:
        return nat
    return _pack24_np(vals)


def _pack24_np(vals: np.ndarray) -> np.ndarray:
    """_pack24's numpy body: the low 3 bytes of each little-endian int32,
    with no wider pass."""
    src = np.ascontiguousarray(vals, "<i4")
    out = np.empty((len(src), 3), np.uint8)
    out[:] = src.view(np.uint8).reshape(-1, 4)[:, :3]
    return out.reshape(-1)


def read_wav(path: str | Path, scale: bool = False) -> tuple[np.ndarray, WavSpec]:
    """Read a WAV file.

    Returns (data, spec) where data is float32 of shape [frames, channels].
    With scale=False int samples are raw counts as float32 (the reference's
    behavior, sample.rs:268-274); with scale=True they are scaled to [-1, 1].
    """
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12 or blob[0:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise WavError(f"not a RIFF/WAVE file: {path}")

    fmt = None
    data_raw = None
    pos = 12
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", blob, pos + 4)
        body = blob[pos + 8 : pos + 8 + csize]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data_raw = body
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned

    if fmt is None or data_raw is None:
        raise WavError(f"missing fmt/data chunk: {path}")
    if len(fmt) < 16:
        raise WavError(f"fmt chunk too short: {path}")
    (audio_format, channels, sample_rate, _byte_rate, _block_align, bits) = (
        struct.unpack_from("<HHIIHH", fmt, 0)
    )
    if audio_format == WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 40:
        # sub-format GUID: first 2 bytes are the real format tag
        (audio_format,) = struct.unpack_from("<H", fmt, 24)

    if audio_format == WAVE_FORMAT_IEEE_FLOAT:
        sample_format = "float"
        if bits == 32:
            vals = np.frombuffer(data_raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            vals = np.frombuffer(data_raw, dtype="<f8").astype(np.float32)
        else:
            raise WavError(f"unsupported float bit depth {bits}: {path}")
    elif audio_format == WAVE_FORMAT_PCM:
        sample_format = "int"
        if bits == 8:
            # 8-bit WAV is unsigned; hound exposes it as signed centered at 0
            vals = (
                np.frombuffer(data_raw, dtype=np.uint8).astype(np.int16) - 128
            ).astype(np.float32)
        elif bits == 16:
            vals = np.frombuffer(data_raw, dtype="<i2").astype(np.float32)
        elif bits == 24:
            vals = _unpack24(data_raw).astype(np.float32)
        elif bits == 32:
            vals = np.frombuffer(data_raw, dtype="<i4").astype(np.float32)
        else:
            raise WavError(f"unsupported int bit depth {bits}: {path}")
        if scale:
            vals = vals / float(1 << (bits - 1))
    else:
        raise WavError(f"unsupported WAV format tag {audio_format:#x}: {path}")

    frames = len(vals) // channels
    data = vals[: frames * channels].reshape(frames, channels)
    if channels == 2 and len(vals) > frames * 2:
        # odd interleaved tail: the dangling value becomes a final L frame
        # (sample.rs:283-292 pushes it to l; the reference leaves r short —
        # here R is zero-filled so the buffer stays rectangular)
        last = np.zeros((1, 2), vals.dtype)
        last[0, 0] = vals[frames * 2]
        data = np.concatenate([data, last], axis=0)
        frames += 1
    spec = WavSpec(
        channels=channels,
        sample_rate=sample_rate,
        bits_per_sample=bits,
        sample_format=sample_format,
    )
    return data, spec


class WavWriter:
    """Streaming WAV writer for PCM int output.

    Mirrors the reference render sink (hound WavWriter, state.rs:508-574):
    incremental chunk writes, header finalized on close. Input chunks are
    float32 already scaled by the amplitude factor; the int cast truncates
    toward zero like Rust's `as` (state.rs:521, 529) but saturates instead of
    wrapping (Rust `as` also saturates float->int).
    """

    def __init__(
        self, path: str | Path, channels: int, sample_rate: int, bits: int
    ) -> None:
        if bits not in (8, 16, 24, 32):
            raise WavError(f"unsupported write bit depth {bits}")
        self.path = Path(path)
        self.channels = channels
        self.sample_rate = sample_rate
        self.bits = bits
        self._f = open(self.path, "wb")
        self._data_bytes = 0
        self._write_header(0)

    def _write_header(self, data_size: int) -> None:
        bits = self.bits
        block_align = self.channels * (bits // 8)
        byte_rate = self.sample_rate * block_align
        hdr = b"RIFF"
        hdr += struct.pack("<I", 36 + data_size)
        hdr += b"WAVEfmt "
        hdr += struct.pack(
            "<IHHIIHH",
            16,
            WAVE_FORMAT_PCM,
            self.channels,
            self.sample_rate,
            byte_rate,
            block_align,
            bits,
        )
        hdr += b"data" + struct.pack("<I", data_size)
        self._f.seek(0)
        self._f.write(hdr)

    def write_scaled(self, scaled: np.ndarray) -> None:
        """Write float32 samples already multiplied by the int amplitude.

        `scaled` is [frames, channels] (or flat interleaved). Values are
        saturated to the target int range and truncated toward zero.
        """
        flat = np.asarray(scaled, dtype=np.float64).reshape(-1)
        bits = self.bits
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        ints = np.trunc(flat)
        ints = np.clip(ints, lo, hi).astype(np.int64)
        if bits == 8:
            raw = (ints + 128).astype(np.uint8).tobytes()
        elif bits == 16:
            raw = ints.astype("<i2").tobytes()
        elif bits == 24:
            raw = _pack24(ints.astype(np.int32))
        else:
            raw = ints.astype("<i4").tobytes()
        self._f.write(raw)
        self._data_bytes += len(raw)

    def write_ints(self, ints: np.ndarray) -> None:
        """Write already-quantized interleaved integer samples (values
        within the target bit range: the output of the device-side
        quantize kernel, ops/quantize.py, int16 up to 16 bits and int32
        above). Every depth takes the low bits of each value straight
        from the input's integer dtype; at 16 and 32 bits an input that
        already is the file's payload (contiguous little-endian samples
        of that width) goes to the file as it is. Spans: `wav write`
        holding `wav encode` (attribute `copied`: the bytes the encode
        allocated and wrote, 0 on that pass-through) and `wav file`."""
        with span("wav write"):
            with span("wav encode") as sp:
                src = np.asarray(ints)
                flat = src.reshape(-1)
                bits = self.bits
                if bits == 8:
                    raw = flat.astype(np.uint8)
                    raw += 128
                elif bits == 24:
                    raw = _pack24(flat)
                else:
                    dt = np.dtype("<i2" if bits == 16 else "<i4")
                    raw = (flat if flat.dtype == dt and flat.flags.c_contiguous
                           else flat.astype(dt))
                if isinstance(sp, Span):
                    sp.attr("copied", 0 if np.may_share_memory(raw, src)
                            else raw.nbytes)
            with span("wav file"):
                self._f.write(raw)
            self._data_bytes += raw.nbytes

    def close(self) -> None:
        if self._f.closed:
            return
        self._write_header(self._data_bytes)
        self._f.close()

    def __enter__(self) -> "WavWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_wav(
    path: str | Path,
    data: np.ndarray,
    sample_rate: int,
    bits: int = 16,
    amplitude: float | None = None,
) -> None:
    """One-shot write of [frames, channels] float data in [-1, 1]."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    if amplitude is None:
        amplitude = float((1 << (bits - 1)) - 1) if bits < 32 else float(2**31 - 1)
    with WavWriter(path, data.shape[1], sample_rate, bits) as w:
        w.write_scaled(data * amplitude)
