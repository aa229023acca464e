"""The port's native host library (termdaw_tpu_torch/native/) against the
reference's (termdaw_tpu/native/): the 24-bit WAV codecs and the packet
frame scanner, directly and through `fileio/wav.py`, `fileio/packets.py`
and a render, with the library on and off (TERMDAW_NATIVE=0). Every case
takes the same seeded inputs through both packages and requires exact
equality. The library builds here with the host's C++ compiler."""

import os
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import termdaw_tpu.native as ref_native
import termdaw_tpu_torch.native as port_native
from termdaw_tpu.banks import samplebank as ref_sb
from termdaw_tpu.fileio import packets as ref_packets
from termdaw_tpu.fileio import wav as ref_wav
from termdaw_tpu_torch.banks import samplebank as port_sb
from termdaw_tpu_torch.fileio import packets as port_packets
from termdaw_tpu_torch.fileio import wav as port_wav
from termdaw_tpu_torch.utils.fixtures import load_state, write_c4_project

REPO = Path(__file__).resolve().parents[1]
NATIVES = (ref_native, port_native)


def _load_ref() -> None:
    """The reference's library builds with make into its own directory at
    first use, with no lock: another test process may be writing it
    now, and a load of a half-written file fails. Retry for a while."""
    for _ in range(60):
        if ref_native.get_lib() is not None:
            return
        ref_native._tried = False
        time.sleep(0.5)
    pytest.fail("the reference's native library did not load")


@pytest.fixture
def native_on():
    _load_ref()
    assert port_native.get_lib() is not None, port_native.load_error


@pytest.fixture
def native_off(monkeypatch):
    """Both loaders reset and TERMDAW_NATIVE=0 read anew; the loaded
    libraries come back after the test."""
    for mod in NATIVES:
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    monkeypatch.setattr(port_native, "load_error", "")
    monkeypatch.setenv("TERMDAW_NATIVE", "0")
    assert all(mod.get_lib() is None for mod in NATIVES)
    assert port_native.load_error == "disabled by TERMDAW_NATIVE=0"


@pytest.fixture(params=["native", "numpy"])
def mode(request):
    request.getfixturevalue(
        "native_on" if request.param == "native" else "native_off")
    return request.param


# ---- 24-bit pack and unpack ----------------------------------------------

EDGES = np.asarray([-2 ** 23, 2 ** 23 - 1, 0, -1, 1, -2 ** 23 + 1], np.int32)


def _ints(case: str) -> np.ndarray:
    rng = np.random.default_rng(24)
    return {
        "edges": EDGES,
        "random": rng.integers(-2 ** 23, 2 ** 23, 10_007).astype(np.int32),
        "one": np.asarray([-5], np.int32),
        "empty": np.zeros(0, np.int32),
        # out of the 24-bit range: both keep the low 24 bits
        "wraps": np.asarray([2 ** 24 + 5, -2 ** 31, 2 ** 31 - 1, 2 ** 23],
                            np.int32),
    }[case]


def _raw(case: str) -> bytes:
    rng = np.random.default_rng(42)
    return {
        "edges": port_wav._pack24_np(EDGES).tobytes(),
        "random": rng.integers(0, 256, 3 * 10_007, np.uint8).tobytes(),
        # a tail that is not a whole sample is dropped
        "ragged1": rng.integers(0, 256, 3 * 17 + 1, np.uint8).tobytes(),
        "ragged2": rng.integers(0, 256, 3 * 17 + 2, np.uint8).tobytes(),
        "short": b"\xff\x7f",
        "empty": b"",
    }[case]


@pytest.mark.parametrize("case", ["edges", "random", "one", "empty", "wraps"])
def test_pack24_equal_on_every_path(case, native_on):
    vals = _ints(case)
    want = port_wav._pack24_np(vals).tobytes()
    n0 = port_native.calls["pack24"]
    assert port_native.pack24(vals).tobytes() == want
    assert port_native.calls["pack24"] == n0 + 1
    assert ref_native.pack24(vals) == want
    assert port_wav._pack24(vals).tobytes() == want
    assert port_native.calls["pack24"] == n0 + 2
    assert ref_wav._pack24(vals) == want
    # the packers hand the file a flat uint8 array: native and numpy
    for got in (port_native.pack24(vals), port_wav._pack24_np(vals)):
        assert got.dtype == np.uint8 and got.shape == (3 * len(vals),)
    if case == "edges":
        assert want == bytes([0, 0, 0x80, 0xff, 0xff, 0x7f, 0, 0, 0,
                              0xff, 0xff, 0xff, 1, 0, 0, 1, 0, 0x80])


@pytest.mark.parametrize("case", ["edges", "random", "ragged1", "ragged2",
                                  "short", "empty"])
def test_unpack24_equal_on_every_path(case, native_on):
    raw = _raw(case)
    want = port_wav._unpack24_np(raw)
    assert want.dtype == np.int32 and want.shape == (len(raw) // 3,)
    n0 = port_native.calls["unpack24"]
    for got in (port_native.unpack24(raw), ref_native.unpack24(raw),
                port_wav._unpack24(raw), ref_wav._unpack24(raw)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert port_native.calls["unpack24"] == n0 + 2
    if case == "edges":
        np.testing.assert_array_equal(want, EDGES)


@pytest.mark.parametrize("case", ["edges", "random", "empty"])
def test_codecs_numpy_bodies_equal_the_references(case, native_off):
    vals, raw = _ints(case), _raw(case)
    n0 = dict(port_native.calls)
    assert port_native.pack24(vals) is None
    assert port_wav._pack24(vals).tobytes() == ref_wav._pack24(vals)
    np.testing.assert_array_equal(port_wav._unpack24(raw),
                                  ref_wav._unpack24(raw))
    assert port_native.calls == n0


@pytest.mark.parametrize("channels", [1, 2])
def test_wav24_round_trip_equals_the_references(channels, mode, tmp_path):
    rng = np.random.default_rng(channels)
    data = rng.uniform(-1, 1, (4099, channels)).astype(np.float32)
    data[0], data[1] = 1.0, -1.0
    out = {}
    for name, mod in (("ref", ref_wav), ("port", port_wav)):
        path = tmp_path / f"{name}.wav"
        mod.write_wav(path, data, 44100, bits=24)
        with mod.WavWriter(tmp_path / f"{name}_ints.wav", 2, 8000, 24) as w:
            w.write_ints(_ints("random")[:2000])
        out[name] = (path.read_bytes(),
                     (tmp_path / f"{name}_ints.wav").read_bytes(),
                     *mod.read_wav(path), mod.read_wav(path, scale=True)[0],
                     mod.read_wav(tmp_path / f"{name}_ints.wav")[0])
    ref, port = out["ref"], out["port"]
    assert port[0] == ref[0] and port[1] == ref[1]
    for i in (2, 4, 5):
        np.testing.assert_array_equal(port[i], ref[i])
    assert port[3].bits_per_sample == 24 and port[3].channels == channels
    np.testing.assert_array_equal(
        port[5].reshape(-1), _ints("random")[:2000].astype(np.float32))


def test_samplebank_loads_a_24_bit_sample(mode, tmp_path):
    rng = np.random.default_rng(7)
    path = tmp_path / "hit.wav"
    port_wav.write_wav(path, rng.uniform(-0.9, 0.9, (3001, 2)), 8000,
                       bits=24)
    n0 = port_native.calls["unpack24"]
    banks = []
    for mod in (ref_sb, port_sb):
        sb = mod.SampleBank(8000)
        sb.add("hit", str(path), mod.SampleLoadMethod.STEREO)
        banks.append(sb)
    assert port_native.calls["unpack24"] == n0 + (mode == "native")
    (ref_s, port_s) = (b.get_sample(0) for b in banks)
    np.testing.assert_array_equal(port_s.l, ref_s.l)
    np.testing.assert_array_equal(port_s.r, ref_s.r)
    assert banks[1].get_max_sr_bd() == (8000, 24)


# ---- the frame scanner ---------------------------------------------------

def _blob(seed: int, frames: int = 40) -> bytes:
    """Random valid EVENTS and TEXT frames (empty names, texts and event
    lists among them, non-ASCII names)."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(frames):
        if rng.random() < 0.6:
            name = "".join(rng.choice(list("kicé_2"), rng.integers(0, 7)))
            ev = rng.normal(size=(rng.integers(0, 6), 4)).astype(np.float32)
            parts.append(port_packets.encode_events(name, ev))
        else:
            parts.append(port_packets.encode_text(
                "".join(rng.choice(list("ab ü\n"), rng.integers(0, 30)))))
    return b"".join(parts)


def _events_header(n: int) -> bytes:
    return b"\x01\x01\x00a" + struct.pack("<I", n)


def _text_header(n: int) -> bytes:
    return b"\x02" + struct.pack("<I", n)


def _scan(mod, buf, **kw):
    try:
        return mod.scan_frames(buf, **kw)
    except ValueError as e:
        return ("error", str(e))


SCAN_CASES = {
    "valid0": lambda: _blob(0),
    "valid1": lambda: _blob(1),
    "valid2": lambda: _blob(2, frames=300),
    "empty": lambda: b"",
    "unknown_kind": lambda: b"\x07",
    "unknown_after_frames": lambda: _blob(3, 5) + b"\x00\x01",
    "events_too_many": lambda: _events_header(2 ** 25),
    "events_guard_plus_1": lambda: _events_header(2 ** 24 + 1),
    "events_at_guard": lambda: _events_header(2 ** 24),
    "text_too_long": lambda: _text_header(2 ** 29),
    "text_guard_plus_1": lambda: _text_header(2 ** 28 + 1),
    "text_at_guard": lambda: _text_header(2 ** 28),
    "absurd_after_frames": lambda: _blob(4, 5) + _text_header(2 ** 31),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_frames_equal_to_the_references(case, native_on):
    buf = SCAN_CASES[case]()
    want = _scan(ref_native, buf)
    n0 = port_native.calls["scan_frames"]
    assert _scan(port_native, buf) == want
    assert _scan(port_native, bytearray(buf)) == want
    assert port_native.calls["scan_frames"] == n0 + 2
    if case.startswith(("unknown", "events_too", "events_guard", "text_too",
                        "text_guard", "absurd")):
        code = -1 if case.startswith("unknown") else -2
        assert want == ("error", f"malformed packet stream (code {code})")
    else:
        assert isinstance(want, list)


@pytest.mark.parametrize("seed", [5, 6])
def test_scan_frames_on_truncated_blobs(seed, native_on):
    blob = _blob(seed, frames=12)
    rng = np.random.default_rng(seed)
    cuts = sorted({0, 1, 2, 3, len(blob) - 1,
                   *rng.integers(0, len(blob), 60).tolist()})
    for cut in cuts:
        want = _scan(ref_native, blob[:cut])
        assert _scan(port_native, blob[:cut]) == want, cut
        # only whole frames, ending at or before the cut
        assert all(off + n <= cut for off, n in want)


@pytest.mark.parametrize("max_frames", [1, 3, 4096])
def test_scan_frames_max_frames(max_frames, native_on):
    blob = _blob(8, frames=10)
    want = _scan(ref_native, blob, max_frames=max_frames)
    assert _scan(port_native, blob, max_frames=max_frames) == want
    assert len(want) == min(10, max_frames)


# ---- PacketDecoder.feed ----------------------------------------------------

def _pkts(pkts) -> list:
    return [(p.kind, p.name, p.text, None if p.events is None else
             (p.events.dtype.str, p.events.shape, p.events.tobytes()))
            for p in pkts]


def _feed(mod, chunks) -> list:
    """What each feed returned, the error that ended the feeds (if one
    did), and the bytes left in the buffer."""
    dec = mod.PacketDecoder()
    out = []
    for c in chunks:
        try:
            out.append(_pkts(dec.feed(c)))
        except mod.PacketError as e:
            out.append(("error", str(e)))
            break
    return out + [bytes(dec._buf)]


def _chunks(blob: bytes, how: str) -> list[bytes]:
    if how == "whole":
        return [blob, b""]
    if how == "bytes":
        return [blob[i:i + 1] for i in range(len(blob))]
    rng = np.random.default_rng(len(blob))
    cuts = sorted(set(rng.integers(0, len(blob), 25).tolist()))
    return [blob[a:b] for a, b in zip([0] + cuts, cuts + [len(blob)])]


@pytest.mark.parametrize("how", ["whole", "bytes", "random"])
@pytest.mark.parametrize("seed", [10, 11])
def test_decoder_equal_to_the_references(seed, how, mode):
    blob = _blob(seed, frames=30)
    n0 = port_native.calls["scan_frames"]
    want = _feed(ref_packets, _chunks(blob, how))
    got = _feed(port_packets, _chunks(blob, how))
    assert got == want
    assert sum(len(r) for r in got[:-1]) == 30 and got[-1] == b""
    fed = len(_chunks(blob, how)) if mode == "native" else 0
    assert port_native.calls["scan_frames"] == n0 + fed


def test_decoder_caps_a_feed_at_4096_frames(mode):
    blob = b"".join(port_packets.encode_text(f"m{i}") for i in range(5000))
    want = _feed(ref_packets, [blob, b"", b""])
    assert _feed(port_packets, [blob, b"", b""]) == want
    sizes = [len(r) for r in want[:-1]]
    assert sizes == ([4096, 904, 0] if mode == "native" else [5000, 0, 0])


MALFORMED = {
    "events_2^25": _events_header(2 ** 25),
    "text_2^29": _text_header(2 ** 29),
    "unknown_kind": b"\x07abc",
    "valid_then_events_2^25": _blob(12, 4) + _events_header(2 ** 25),
}


@pytest.mark.parametrize("how", ["whole", "bytes"])
@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_decoder_on_malformed_streams(case, how, mode):
    blob = MALFORMED[case] + bytes(64)
    want = _feed(ref_packets, _chunks(blob, how))
    got = _feed(port_packets, _chunks(blob, how))
    assert got == want
    errors = [r for r in got[:-1] if r and r[0] == "error"]
    if mode == "native":
        code = -1 if case == "unknown_kind" else -2
        assert errors == [("error",
                           f"malformed packet stream (code {code})")]
    elif case == "unknown_kind":
        assert errors == [("error", "unknown packet kind 0x7")]
    else:
        # the numpy loop has no size guard: it keeps buffering
        assert errors == [] and got[-1].endswith(bytes(64))


# ---- a render ------------------------------------------------------------

def test_c4_cut_at_24_bit_same_bytes_native_on_and_off(tmp_path,
                                                        monkeypatch):
    write_c4_project(tmp_path, 1.0, 8000, 256, render_sr=8000, bd=24)
    _load_ref()
    assert port_native.get_lib() is not None
    n0 = port_native.calls["pack24"]
    load_state(tmp_path, torch.device("cpu")).render()
    on = (tmp_path / "outp.wav").read_bytes()
    assert port_native.calls["pack24"] > n0
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_tried", False)
    monkeypatch.setenv("TERMDAW_NATIVE", "0")
    (tmp_path / "outp.wav").unlink()
    n1 = port_native.calls["pack24"]
    load_state(tmp_path, torch.device("cpu")).render()
    off = (tmp_path / "outp.wav").read_bytes()
    assert port_native.calls["pack24"] == n1
    assert on == off
    data, spec = port_wav.read_wav(tmp_path / "outp.wav")
    assert spec.bits_per_sample == 24 and data.shape[1] == 2
    assert data.shape[0] >= 8000
    assert np.abs(data).max() > 2 ** 22


# ---- the build -----------------------------------------------------------

BUILD_SCRIPT = """
import sys
from pathlib import Path
import termdaw_tpu_torch.native as native
native.BUILD_DIR = Path(sys.argv[1])
lib = native.get_lib()
assert lib is not None, native.load_error
assert native.pack24([1, -1]).tobytes() == bytes([1, 0, 0, 255, 255, 255])
print(native.lib_path().name, native.build_seconds is not None)
"""


def test_two_processes_build_into_one_directory_and_both_load(tmp_path):
    build = tmp_path / "build"
    env = {k: v for k, v in os.environ.items() if k != "TERMDAW_NATIVE"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, str(build)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.split()[0] for out, _ in outs}
    assert len(names) == 1
    assert sorted(f.name for f in build.iterdir()) == sorted(names)
    # a third process finds it built
    again = subprocess.run([sys.executable, "-c", BUILD_SCRIPT, str(build)],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=120)
    assert again.returncode == 0 and again.stdout.split() == [
        names.pop(), "False"]


def test_a_failed_build_is_reported_and_the_numpy_paths_run(
        tmp_path, monkeypatch, capfd):
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_tried", False)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "/bin/false")
    monkeypatch.delenv("TERMDAW_NATIVE", raising=False)
    n0 = dict(port_native.calls)
    assert port_native.get_lib() is None
    assert port_native.get_lib() is None
    err = capfd.readouterr().err
    assert err.count("/bin/false failed (exit 1)") == 1
    assert "/bin/false failed (exit 1)" in port_native.load_error
    assert not list((tmp_path / "build").iterdir())
    vals = _ints("random")
    assert port_wav._pack24(vals).tobytes() == ref_wav._pack24(vals)
    np.testing.assert_array_equal(port_wav._unpack24(_raw("random")),
                                  ref_wav._unpack24(_raw("random")))
    blob = _blob(13)
    assert _feed(port_packets, [blob]) == _feed(ref_packets, [blob])
    assert port_native.calls == n0


def test_the_library_path_keys_the_compiler_and_the_sources(monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    default = port_native.lib_path()
    assert default.parent == REPO / "termdaw_tpu_torch" / "build"
    assert port_native.compiler() == ["g++"]
    monkeypatch.setenv("CXX", "ccache  g++ -m64")
    assert port_native.compiler() == ["ccache", "g++", "-m64"]
    assert port_native.lib_path() != default
    monkeypatch.setattr(port_native, "SOURCES", ("wavio.cpp",))
    monkeypatch.delenv("CXX")
    assert port_native.lib_path() != default
