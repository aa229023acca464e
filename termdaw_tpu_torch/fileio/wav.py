"""Carried over from termdaw_tpu/fileio/wav.py, so that the port imports
nothing of termdaw_tpu; the 24-bit pack and unpack run on their numpy
paths only (the reference's native library is not used); the bytes are
the same.

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

The 24-bit pack/unpack is numpy.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

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


def _pack24(vals: np.ndarray) -> bytes:
    """Pack int32 (already clipped to 24-bit range) into little-endian 24-bit."""
    v = vals.astype(np.int64) & 0xFFFFFF
    out = np.empty((len(v), 3), dtype=np.uint8)
    out[:, 0] = v & 0xFF
    out[:, 1] = (v >> 8) & 0xFF
    out[:, 2] = (v >> 16) & 0xFF
    return out.tobytes()


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
        """Write already-quantized interleaved integer samples (int32 values
        within the target bit range — e.g. the output of the device-side
        quantize kernel, ops/quantize.py)."""
        flat = np.asarray(ints).reshape(-1).astype(np.int64)
        bits = self.bits
        if bits == 8:
            raw = (flat + 128).astype(np.uint8).tobytes()
        elif bits == 16:
            raw = flat.astype("<i2").tobytes()
        elif bits == 24:
            raw = _pack24(flat.astype(np.int32))
        else:
            raw = flat.astype("<i4").tobytes()
        self._f.write(raw)
        self._data_bytes += len(raw)

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
