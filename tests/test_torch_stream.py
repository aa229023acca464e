"""The port's stream workflow (termdaw_tpu_torch/workflows/stream.py) on
the CPU: the reference's cases (tests/test_workflows.py:246-292 and the
stream example, tests/test_examples.py:107), a session in both packages
with the clock replaced so that each tick renders a fixed block count,
and the CLI with `workflow = "stream"`."""

import io
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from termdaw_tpu.config import Config
from termdaw_tpu.engine.state import State as RefState
from termdaw_tpu.workflows.stream import (
    run_stream_workflow as ref_run_stream_workflow,
)

from termdaw_tpu_torch.engine.sink import NullSink, Sink
from termdaw_tpu_torch.fileio.packets import (
    PacketDecoder, encode_events, encode_text,
)
from termdaw_tpu_torch.fileio.wav import write_wav
from termdaw_tpu_torch.utils import example_assets
from termdaw_tpu_torch.utils.fixtures import drum, load_state
from termdaw_tpu_torch.workflows.stream import run_stream_workflow

from .conftest import scrubbed_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SR, BL = 8000, 256


def _project(d: Path, body: str) -> None:
    d.mkdir(parents=True, exist_ok=True)
    (d / "project.lua").write_text(body)
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = {BL}\n'
        f"project_samplerate = {SR}\n")


class CaptureSink(Sink):
    def __init__(self) -> None:
        self.chunks: list[np.ndarray] = []
        self.closed = False

    def queue_audio(self, interleaved: np.ndarray) -> None:
        self.chunks.append(np.array(interleaved, np.float32))

    def close(self) -> None:
        self.closed = True

    def audio(self) -> np.ndarray:
        return np.concatenate(self.chunks) if self.chunks else np.zeros(0)


def _kick_project(d: Path) -> None:
    t = np.arange(SR // 8) / SR
    x = (np.exp(-t * 60) * np.sin(2 * np.pi * 80 * t)).astype(np.float32)
    d.mkdir(parents=True, exist_ok=True)
    write_wav(d / "kick.wav", np.stack([x, x], 1), SR, bits=16)
    _project(d, f"""
load_sample("kick", "{d}/kick.wav", "");
declare_stream("drums");
add_sample_multi("hits", 1.0, 0.0, "kick", "drums", -1);
set_output("hits");
""")


def test_stream_events_render(tmp_path, capsys):
    """Events and a text packet from the input: the events are appended
    to the declared stream (and trimmed as they are consumed), the text
    is printed, and the sink gets audio that is non-zero after the first
    event; EOF does not stop playback, max_idle_s does."""
    _kick_project(tmp_path)
    st = load_state(tmp_path, CPU)
    v0 = st.fb.version
    events = np.asarray([[0.0, 0.05, 36.0, 0.9], [0.0, 0.2, 38.0, 0.8]],
                        np.float32)
    blob = encode_events("drums", events) + encode_text("hello-stream")
    sink = CaptureSink()
    run_stream_workflow(SR, BL, st, sink, input_stream=io.BytesIO(blob),
                        max_idle_s=0.5)
    assert sink.closed
    assert st.fb.get_index("drums") is not None and st.fb.version > v0
    assert "hello-stream" in capsys.readouterr().out
    audio = sink.audio()
    assert np.isfinite(audio).all()
    assert audio.size >= 2 * 4 * BL  # the prebuffer at least
    assert np.abs(audio[2 * int(0.05 * SR):]).max() > 0.1


def test_decode_error_stops(tmp_path, capsys):
    _project(tmp_path, """
declare_stream("s");
add_debug_sine("v", 1.0, 0.0, "s");
set_output("v");
""")
    st = load_state(tmp_path, CPU)
    t0 = time.monotonic()
    run_stream_workflow(SR, BL, st, NullSink(SR),
                        input_stream=io.BytesIO(bytes([0xFF, 1, 2, 3])),
                        max_idle_s=30.0)
    assert time.monotonic() - t0 < 20.0  # the error ended it, not idling
    assert "could not decode" in capsys.readouterr().out


def test_stream_example_plays_packets(tmp_path):
    """The shipped stream example (examples/stream, its assets generated
    into a temp dir by the port's utils/example_assets.py) in the port:
    fed packets render finite, audible audio (mirror of
    tests/test_examples.py:107)."""
    example_assets.ensure(tmp_path / "assets")
    d = tmp_path / "stream"
    d.mkdir()
    for f in ("project.lua", "project.toml"):
        (d / f).write_bytes((REPO / "examples" / "stream" / f).read_bytes())
    st = load_state(d, CPU)
    ev = np.array([[0.0, 0.05, 36.0, 1.0], [1.0, 0.30, 38.0, 0.9]],
                  np.float32)
    blob = encode_events("kick", ev[:1]) + encode_events("snare", ev[1:])
    st.fb.append_streams(PacketDecoder().feed(blob))
    st.fb.set_time(0)
    audio = st.compiled.render_window(st.fb, 4).numpy()
    assert np.all(np.isfinite(audio))
    assert np.max(np.abs(audio)) > 1e-4


_SESSION_LUA = """
load_sample("kick", "{d}/kick.wav", "");
declare_stream("drums");
declare_stream("keys");
add_sample_multi("hits", 1.0, 0.0, "kick", "drums", -1);
add_synth("syn", 0.4, 0.0, "keys", 0.4, 0.3,
          {{ 0.01, 0.1, 0.8, 0.5, 0.2, 0.5 }}, 0.0, 0.0, {{}}, 0.0, {{}});
add_sum("out", 1.0, 0.0);
connect("hits", "out");
connect("syn", "out");
set_output("out");
"""


def _session_packets() -> bytes:
    drums = np.asarray([[0.0, t, 36.0, 0.9] for t in (0.3, 0.55, 0.8, 1.3)],
                       np.float32)
    keys = np.asarray([[0.0, 0.4, 60.0, 0.8], [0.0, 0.9, 60.0, 0.0],
                       [0.0, 1.0, 64.0, 0.7], [0.0, 1.6, 64.0, 0.0]],
                      np.float32)
    return encode_events("drums", drums) + encode_events("keys", keys)


class _Clock:
    """time.monotonic for a session: each call advances half a block, so
    a tick renders the blocks of its deficit in a fixed pattern (at a
    whole block a call, tick's check and its one-block window would keep
    pace with each other and the tick would never end)."""

    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        self.t += 0.5 * BL / SR
        return self.t


def test_stream_session_matches_reference(tmp_path, monkeypatch):
    """One stream session in each package on the same small project and
    packets, with time.monotonic replaced by a clock that advances half a
    block a call: the captured audio agrees within one 16-bit count over
    the frames both rendered (more than two seconds of it)."""
    d = tmp_path / "proj"
    d.mkdir()
    drum(d / "kick.wav", SR, 0.12, 80.0, 60.0)
    _project(d, _SESSION_LUA.format(d=d))
    monkeypatch.setenv("TERMDAW_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TERMDAW_MESH", "0")
    ref = RefState(Config.read(d / "project.toml"), str(d))
    ref.refresh()
    assert ref.loaded
    port = load_state(d, CPU)
    out = []
    for run, st in ((ref_run_stream_workflow, ref), (run_stream_workflow,
                                                     port)):
        monkeypatch.setattr(time, "monotonic", _Clock())
        sink = CaptureSink()
        run(SR, BL, st, sink, input_stream=io.BytesIO(_session_packets()),
            max_idle_s=3.0)
        monkeypatch.undo()
        out.append(sink.audio())
    want, got = out
    n = min(want.size, got.size)
    assert n >= 2 * int(2.0 * SR)
    assert np.abs(want[:n]).max() > 0.1
    assert np.abs(got[:n] - want[:n]).max() <= 2.0 ** -15


def test_cli_stream_workflow_reads_stdin(tmp_path):
    """`workflow = "stream"` runs the stream workflow from the CLI on the
    CPU: packets on stdin, TERMDAW_STREAM_IDLE ends it, the FileSink
    captures the played audio."""
    _kick_project(tmp_path)
    toml = tmp_path / "project.toml"
    toml.write_text(toml.read_text() + 'workflow = "stream"\n')
    events = np.asarray([[0.0, 0.05, 36.0, 0.9]], np.float32)
    cap = tmp_path / "cap.wav"
    proc = subprocess.run(
        [sys.executable, "-m", "termdaw_tpu_torch", "--device", "cpu",
         str(tmp_path)],
        input=encode_events("drums", events) + encode_text("from-stdin"),
        cwd=REPO, capture_output=True, timeout=240,
        env=scrubbed_env(TERMDAW_SINK=f"file:{cap}",
                         TERMDAW_STREAM_IDLE="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert b"from-stdin" in proc.stdout
    assert cap.exists() and cap.stat().st_size > 44
