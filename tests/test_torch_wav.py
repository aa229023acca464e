"""The port's WAV writer (termdaw_tpu_torch/fileio/wav.py) against the
reference's (termdaw_tpu/fileio/wav.py): `write_ints` on the same
integer samples writes the same file at every bit depth."""

import time

import numpy as np
import pytest

from termdaw_tpu.fileio.wav import WavWriter
from termdaw_tpu_torch.fileio import wav as port_wav
from termdaw_tpu_torch.utils import prof


@pytest.mark.parametrize("calls", [1, 2])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_port_write_ints_same_bytes_as_the_reference(tmp_path, bits, dtype,
                                                     calls):
    """The port's `write_ints` encodes straight from the input's dtype:
    the same file as the reference's int64 route, the header's data size
    after each write included, and no copy where the input already is
    the payload (int16 at 16 bits, int32 at 32)."""
    rng = np.random.default_rng(bits * 10 + calls)
    info = np.iinfo(dtype)
    lo = max(-(1 << (bits - 1)), int(info.min))
    hi = min((1 << (bits - 1)) - 1, int(info.max))
    chunks = []
    for i in range(calls):
        vals = rng.integers(lo, hi, 2 * 501 + i, endpoint=True).astype(dtype)
        vals[:2] = lo, hi
        chunks.append(vals.reshape(-1, 2) if i == 0 else vals)
    want, got = tmp_path / "ref.wav", tmp_path / "port.wav"
    with WavWriter(want, 2, 8000, bits) as w:
        for c in chunks:
            w.write_ints(c)
    t0 = time.perf_counter()
    with prof.recording(), port_wav.WavWriter(got, 2, 8000, bits) as w:
        for c in chunks:
            w.write_ints(c)
    assert got.read_bytes() == want.read_bytes()
    encodes = [r for r in prof.records()
               if r.name == "wav encode" and r.t0 >= t0]
    passes = (bits, dtype) in ((16, np.int16), (32, np.int32))
    assert [r.attrs["copied"] for r in encodes] == [
        0 if passes else c.size * bits // 8 for c in chunks]
