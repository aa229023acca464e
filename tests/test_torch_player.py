"""Playback in the port (termdaw_tpu_torch/engine/player.py and the
manual workflow) against the reference's Player, both on the CPU.

The reference renders with TERMDAW_MESH=0 (one device, as the port).
Queued audio is compared at atol 1e-5, the bound of the render tests
(tests/test_torch_engine.py); the port against itself is exact."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from termdaw_tpu.config import Config
from termdaw_tpu.engine.player import Player as RefPlayer
from termdaw_tpu.engine.sink import Sink as RefSink
from termdaw_tpu.engine.state import State as RefState

from termdaw_tpu_torch.engine.player import Player
from termdaw_tpu_torch.engine.sink import Sink
from termdaw_tpu_torch.utils.fixtures import (
    load_state, write_c2_project, write_c3_project,
)

from .conftest import scrubbed_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SR, BL = 8000, 256


class _Capture:
    """Keeps every queued chunk; clear() drops them, as a real queue."""

    def __init__(self) -> None:
        self.chunks: list[np.ndarray] = []
        self.resumed = 0

    def queue_audio(self, interleaved: np.ndarray) -> None:
        assert isinstance(interleaved, np.ndarray)
        self.chunks.append(np.array(interleaved, np.float32, copy=True))

    def clear(self) -> None:
        self.chunks.clear()

    def resume(self) -> None:
        self.resumed += 1


class CaptureSink(_Capture, Sink):
    """The port's sink interface, for the port's Player."""


class RefCaptureSink(_Capture, RefSink):
    """The reference's sink interface, for the reference's Player."""


def _ref_state(d, monkeypatch):
    monkeypatch.setenv("TERMDAW_MESH", "0")
    st = RefState(Config.read(Path(d) / "project.toml"), str(d))
    st.refresh()
    assert st.loaded
    return st


def _players(d, monkeypatch):
    ref_sink, port_sink = RefCaptureSink(), CaptureSink()
    return (RefPlayer(_ref_state(d, monkeypatch), ref_sink, SR, BL), ref_sink,
            Player(load_state(d, CPU), port_sink, SR, BL), port_sink)


def _window(st, t, nb):
    st.compiled.set_time(t)
    st.fb.set_time(t)
    audio = st.compiled.render_window(st.fb, nb)
    st.fb.advance_blocks(nb)
    return audio.numpy().reshape(-1)


def test_play_queues_the_prebuffer_then_tick_continues(tmp_path, monkeypatch):
    write_c2_project(tmp_path, 2.0, SR, BL)
    ref, ref_sink, port, sink = _players(tmp_path, monkeypatch)
    nb = Player.PREBUFFER_BLOCKS
    port.play()
    assert port.playing and sink.resumed == 1
    assert port.state.compiled.get_time() == port.state.fb.frame == nb * BL
    (pre,) = sink.chunks
    fresh = load_state(tmp_path, CPU)
    np.testing.assert_array_equal(pre, _window(fresh, 0, nb))
    ref.play()
    (ref_pre,) = ref_sink.chunks
    np.testing.assert_allclose(pre, ref_pre, rtol=0, atol=1e-5)
    port.play()  # a second play neither re-prebuffers nor resets pacing
    assert len(sink.chunks) == 1
    # the lead is kept: the first tick renders at once
    n = port.tick()
    assert n >= 1 and port.state.compiled.get_time() == (nb + n) * BL
    np.testing.assert_array_equal(np.concatenate(sink.chunks[1:]),
                                  _window(fresh, nb * BL, n))


def test_seek_and_stop_match_reference(tmp_path, monkeypatch):
    """c3: a seek while playing re-primes the band-pass, clears the
    synth's notes and prebuffers again from the new time; stop rewinds
    graph and event cursor to 0 and drops the queue."""
    write_c3_project(tmp_path, 2.0, SR, BL)
    ref, ref_sink, port, sink = _players(tmp_path, monkeypatch)
    for p in (ref, port):
        p.play()
        p.seek(3000)
    for p in (ref, port):
        assert p.playing
        assert p.state.compiled.get_time() == p.state.fb.frame == (
            3000 + Player.PREBUFFER_BLOCKS * BL)
    (got,), (want,) = sink.chunks, ref_sink.chunks
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    for p in (ref, port):
        p.stop()
        assert not p.playing
        assert p.state.compiled.get_time() == p.state.fb.frame == 0
    assert sink.chunks == [] and ref_sink.chunks == []
    assert port.tick() == 0  # stopped: nothing renders


def test_cli_play_stop_quit_never_imports_jax(tmp_path):
    """`play` in `python -m termdaw_tpu_torch` runs the port's player,
    not the reference's (which imports jax and cannot take CUDA audio)."""
    write_c2_project(tmp_path, 2.0, SR, BL)
    script = f"""
import sys
from termdaw_tpu_torch import cli
rc = cli.main(["--device", "cpu", {str(tmp_path)!r}])
assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)
print('JAXFREE', rc)
"""
    proc = subprocess.run(
        [sys.executable, "-c", script], input="play\nget\nstop\nget\nquit\n",
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=scrubbed_env(TERMDAW_SINK="null"),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAXFREE 0" in proc.stdout
    assert "---- play" in proc.stdout and "---- stop" in proc.stdout
    frames = [line for line in proc.stdout.splitlines()
              if line.startswith("Frame:")]
    assert frames[-1].startswith("Frame: 0,")  # stop rewound
    assert int(frames[0].split()[1].rstrip(",")) >= (
        Player.PREBUFFER_BLOCKS * BL)
