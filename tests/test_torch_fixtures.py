"""The port's bench configs (termdaw_tpu_torch/utils/fixtures.py's
BUILDERS) on the CPU: each writer against bench.py's build function of
that name, and the widest config the port renders beside the reference
(c6, 256 tracks) against the JAX reference.

The reference renders c6 on its XLA gather path (no TERMDAW_PALLAS_INTERPRET
on the CPU: each SampleMulti vertex mixes its own voices), the plain
reference its own tests hold the Pallas kernel to; interpret mode takes
minutes at 256 tracks. Its fused bake tables, which the port's voice mix
reads, come from a second State with TERMDAW_PALLAS_INTERPRET=1 (host
numpy, no kernel run)."""

import importlib.util
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from termdaw_tpu.config import Config
from termdaw_tpu.engine.state import State as RefState
from termdaw_tpu.fileio import packets as rpackets
from termdaw_tpu.ops import mix as rmix

from termdaw_tpu_torch.engine.state import render_chunk_blocks
from termdaw_tpu_torch.ops import voices
from termdaw_tpu_torch.utils.fixtures import BUILDERS, build, load_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SHORT = dict(length_sec=2.0, sr=8000, bl=256)

@pytest.fixture(scope="module")
def ref_bench():
    spec = importlib.util.spec_from_file_location("ref_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(d: Path) -> dict[str, bytes]:
    return {f.name: f.read_bytes() for f in sorted(d.iterdir())}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_config_writes_the_reference_files(tmp_path, monkeypatch, name,
                                           ref_bench):
    """The Lua text, the WAVs, the MIDI files, the wavetable and the
    toml byte for byte, and the stream packets bench.py's build function
    feeds its State (c5-c7) equal to those the port's writer returns."""
    monkeypatch.setenv("TERMDAW_MESH", "0")
    fed = []
    feed = rpackets.PacketDecoder.feed
    monkeypatch.setattr(rpackets.PacketDecoder, "feed",
                        lambda self, b: fed.append(bytes(b)) or feed(self, b))
    d = tmp_path / name
    ref_bench.BUILDERS[name](d, *SHORT.values())
    want = _files(d)
    shutil.rmtree(d)
    packets = BUILDERS[name](d, *SHORT.values())
    assert _files(d) == want
    assert len(want) >= 3
    assert [packets] == (fed or [b""])
    if name.startswith(("c5", "c6", "c7")):
        assert len(packets) > 0



@pytest.mark.parametrize("name", list(BUILDERS))
def test_build_loads_the_config_with_its_streams_fed(tmp_path, monkeypatch,
                                                     name):
    """build() writes the config, refreshes it on the device it is given
    and feeds its packets: c5-c7 have one stream a track, each holding
    its 32 events; the others have no stream."""
    monkeypatch.setenv("TERMDAW_MESH", "0")
    st = build(name, tmp_path, SHORT["length_sec"], CPU, sr=SHORT["sr"],
               bl=SHORT["bl"])
    assert st.loaded and st.device == CPU
    assert st.config.settings.project_samplerate == SHORT["sr"]
    assert st.config.settings.buffer_length == SHORT["bl"]
    tracks = {"c5_stream64": 64, "c6_stream256": 256, "c7_stream1024": 1024}
    streams = st.fb.stream_list
    assert len(streams) == tracks.get(name, 0)
    assert all(len(st.fb.flowws[i]) == 32 for i in streams)

def _recorded_first_window(st, nb: int):
    """The port's first nb-block window: its audio and the arguments of
    its voice-mix call (buffer, begins, left and right amps)."""
    seen = []
    real = voices.voice_mix_stereo

    def record(*a):
        seen.append(a)
        return real(*a)

    st.fb.set_time(0)
    st.compiled.seed_caps(st.fb, st.cs, render_chunk_blocks(st.cs))
    voices.voice_mix_stereo = record
    try:
        audio = st.compiled.render_window(st.fb, nb).numpy()
    finally:
        voices.voice_mix_stereo = real
    assert len(seen) == 1
    return audio, [np.asarray(t) for t in seen[0][:4]]


def _ref_state(d, packets):
    st = RefState(Config.read(Path(d) / "project.toml"), str(d))
    st.refresh()
    assert st.loaded
    st.fb.append_streams(rpackets.PacketDecoder().feed(packets))
    return st


def test_c6_bake_and_render_match_reference(tmp_path, monkeypatch):
    """c6 (256 streamed tracks) at 8 kHz / 256 for 2 s, one window: the
    fused group's begins equal to the reference's, its per-voice amps
    (vel times the member's pan/gain amps) within 1e-6 of the reference's
    (the cos/sin of the pan), and the window within the atol 1e-5 that
    tests/test_torch_engine.py holds c5 to."""
    monkeypatch.setenv("TERMDAW_MESH", "0")
    packets = BUILDERS["c6_stream256"](tmp_path, *SHORT.values())
    port = load_state(tmp_path, CPU, packets)
    nb = port.cs
    got, (_, begins, amp_l, amp_r) = _recorded_first_window(port, nb)
    assert begins.shape[0] == nb and begins.shape[1] > 32

    monkeypatch.setenv("TERMDAW_PALLAS_INTERPRET", "1")
    fused = _ref_state(tmp_path, packets)
    ((consumer, members),) = fused.compiled.fused_groups.items()
    assert port.compiled.fused_groups == {consumer: members}
    assert len(members) == 256
    cg = fused.compiled
    fused.fb.set_time(0)
    cg.seed_caps(fused.fb, fused.cs, render_chunk_blocks(fused.cs))
    bakes, _ = cg._bake_all(fused.fb, 0, nb, fused=True)
    tbl = {k: np.asarray(v) for k, v in bakes[f"fused{consumer}"].items()}
    np.testing.assert_array_equal(begins, tbl["begins"])
    amps = np.asarray(jnp.stack([rmix.post_amps(cg._angles[m], cg._gains[m])
                                 for m in members]))
    for got_amp, c in ((amp_l, 0), (amp_r, 1)):
        want_amp = tbl["vel"] * amps[tbl["member"], c]
        np.testing.assert_allclose(got_amp, want_amp, rtol=0, atol=1e-6)
    assert np.abs(amp_l).max() > 0.1

    monkeypatch.delenv("TERMDAW_PALLAS_INTERPRET")
    ref = _ref_state(tmp_path, packets)
    assert not ref.compiled.fused_groups
    ref.fb.set_time(0)
    want = np.asarray(ref.compiled.render_window(ref.fb, nb))
    assert got.shape == want.shape == (nb * SHORT["bl"], 2)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

