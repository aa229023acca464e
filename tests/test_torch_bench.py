"""The port's benchmark harness (termdaw_tpu_torch/bench.py) on the CPU:
its configs against bench.py's build functions, the widest config it adds to
the port's measured set (c6, 256 tracks) against the JAX reference, and
the harness's output contract in child processes (one JSON line, its
keys, the exit status, SIGTERM), with nothing of JAX importable there.

The reference renders c6 on its XLA gather path (no TERMDAW_PALLAS_INTERPRET
on the CPU: each SampleMulti vertex mixes its own voices), the plain
reference its own tests hold the Pallas kernel to; interpret mode takes
minutes at 256 tracks. Its fused bake tables, which the port's voice mix
reads, come from a second State with TERMDAW_PALLAS_INTERPRET=1 (host
numpy, no kernel run)."""

import importlib.util
import json
import shutil
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from termdaw_tpu.config import Config
from termdaw_tpu.engine.state import State as RefState
from termdaw_tpu.fileio import packets as rpackets
from termdaw_tpu.ops import mix as rmix

from termdaw_tpu_torch import bench
from termdaw_tpu_torch.engine.state import render_chunk_blocks
from termdaw_tpu_torch.ops import voices
from termdaw_tpu_torch.utils import fixtures
from termdaw_tpu_torch.utils.fixtures import load_state

from .conftest import scrubbed_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SHORT = dict(length_sec=2.0, sr=8000, bl=256)
# a run of the harness on the CPU: 1 s songs, 2 repetitions
RUN = dict(BENCH_LENGTH_SEC="1", BENCH_REPS="2")

@pytest.fixture(scope="module")
def ref_bench():
    spec = importlib.util.spec_from_file_location("ref_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(d: Path) -> dict[str, bytes]:
    return {f.name: f.read_bytes() for f in sorted(d.iterdir())}


@pytest.mark.parametrize("name", list(bench.BUILDERS))
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
    packets = bench.BUILDERS[name](d, *SHORT.values())
    assert _files(d) == want
    assert len(want) >= 3
    assert [packets] == (fed or [b""])
    if name.startswith(("c5", "c6", "c7")):
        assert len(packets) > 0


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
    packets = bench.BUILDERS["c6_stream256"](tmp_path, *SHORT.values())
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


def _harness_env(tmp_path, **env) -> dict:
    # every python process of the run: jax and the JAX package blocked,
    # each process and each attempt logged
    site = fixtures.block_site(tmp_path / "site")
    return scrubbed_env(PYTHONPATH=site,
                        BENCH_SIDECAR=str(tmp_path / "full.json"), **env)


def _one_line(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    assert len(lines[0]) <= bench.MAX_LINE_CHARS
    out = json.loads(lines[0])
    assert out["metric"] == "render_throughput_chip_sample_project"
    assert out["unit"] == "x_realtime_48k"
    return out


def _run(tmp_path, *args, timeout=300, **env):
    proc = subprocess.run(
        [sys.executable, "-m", "termdaw_tpu_torch.bench", *args],
        cwd=REPO, env=_harness_env(tmp_path, **env), capture_output=True,
        text=True, timeout=timeout)
    return proc, _one_line(proc.stdout)


def test_harness_on_the_cpu_prints_one_line(tmp_path):
    """c1, c5_stream64 and c7_stream1024: exit 0, one line with the
    headline, each config's chip and e2e xRT and roofline, the link,
    stream latency and playback keys and the device; the sidecar keeps
    the p50s, warm-ups and served windows. Two processes ran (the
    watchdog and the measuring child), none imported JAX; c7 was
    measured last, after playback, and the run left no directory of its
    own in TMPDIR."""
    tmpdir = tmp_path / "tmpdir"
    tmpdir.mkdir()
    proc, out = _run(tmp_path, "--device", "cpu", **RUN, TMPDIR=str(tmpdir),
                     BENCH_CONFIGS="c7_stream1024,c1,c5_stream64")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "error" not in out
    extra = out["extra"]
    assert out["value"] == extra["c1_chip_xrt"] > 0
    assert out["vs_baseline"] == round(out["value"] / 500, 3)
    for cfg in ("c1", "c5_stream64", "c7_stream1024"):
        assert extra[f"{cfg}_chip_xrt"] > 0 and extra[f"{cfg}_e2e_xrt"] > 0
        assert extra[f"{cfg}_util"]["gflops_per_s"] > 0
    for k in ("link_mbps", "stream_latency_p50_ms", "stream_latency_p95_ms",
              "stream_latency_ok", "playback_gen_per_wall",
              "playback_realtime_ok", "playback_max_deficit_ms",
              "playback_deficit_ok"):
        assert k in extra, k
    assert extra["device"]["device"] == "cpu"
    assert extra["device"]["torch"] == torch.__version__
    assert not any(k.endswith("_error") for k in extra)
    full = json.loads((tmp_path / "full.json").read_text())["extra"]
    for cfg in ("c1", "c5_stream64", "c7_stream1024"):
        assert full[f"{cfg}_chip_p50_ms"] > 0 and full[f"{cfg}_e2e_p50_ms"] > 0
        assert full[f"{cfg}_compile_s"] > 0
        assert full[f"{cfg}_chip_renders"] >= 2
        # the timed windows, served from a chain or baked live (a 1 s
        # song ends with voices sounding, which breaks a chain's lineage
        # at its repeat; at 40 s the chains serve)
        assert full[f"{cfg}_served_windows"] + full[f"{cfg}_live_bakes"] >= 2
        assert full[f"{cfg}_util"]["peaks"] is None  # no card, no share
    procs, blocked = fixtures.block_log(tmp_path / "site")
    assert len(procs) == 2 and not blocked, (procs, blocked)
    assert sum("--child" in argv for argv in procs.values()) == 1, procs
    log = proc.stderr
    assert log.index("playback:") < log.index("building c7_stream1024")
    assert not list(tmpdir.glob("termdaw_*"))


def test_chip_median_spans_every_timed_render(monkeypatch):
    """A set whose spread exceeds 2 is followed by another; the median,
    the spread and the count are those of all renders timed, the slow
    set included."""
    sets = iter([[1.0, 1.0, 3.0], [1.1, 1.2, 1.0], [9.0, 9.0, 9.0]])
    monkeypatch.setattr(bench, "time_fn", lambda fn, reps: next(sets))
    monkeypatch.setattr(bench, "chip_render", lambda st: None)

    class St:
        compiled = type("Cg", (), {"served_windows": 0, "live_bakes": 0})

    extra: dict = {}
    assert bench.measure_chip(St, 40.0, 3, "cx", extra) == 1.05
    assert extra["cx_chip_renders"] == 6
    assert extra["cx_chip_spread"] == 3.0
    assert extra["cx_chip_p50_ms"] == 1050.0


def test_harness_without_a_card_fails(tmp_path):
    """The default device is cuda; without a card the line carries the
    error and the exit status is not 0: no quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    proc, out = _run(tmp_path, timeout=120, **RUN, BENCH_CONFIGS="c1")
    assert proc.returncode != 0
    assert "is_available() is false" in out["error"]
    assert out["value"] == 0.0 and "c1_chip_xrt" not in out["extra"]


def test_harness_unknown_config_fails(tmp_path):
    proc, out = _run(tmp_path, "--device", "cpu", timeout=120, **RUN,
                     BENCH_CONFIGS="c1,c9_nope")
    assert proc.returncode != 0
    assert "c9_nope" in out["error"]
    assert out["extra"]["bench_configs_unknown"] == ["c9_nope"]
    assert "c1_chip_xrt" not in out["extra"]


def test_failing_config_is_reported_and_the_rest_measured(
        tmp_path, monkeypatch, capsys):
    """A config that raises gets its `{name}_error`; c1 is still measured
    (headline, e2e, playback), and the reported exit status is 1."""
    def broken(d, length_sec, sr, bl):
        raise RuntimeError("a config that cannot be written")

    monkeypatch.setitem(bench.BUILDERS, "c2_negadsr", broken)
    for k, v in dict(RUN, BENCH_CONFIGS="c2_negadsr,c1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_SIDECAR", str(tmp_path / "full.json"))
    res, status = tmp_path / "result.json", tmp_path / "status"
    assert bench.child_main(res, status, "cpu") == 0
    result = json.loads(res.read_text())
    assert result["done"] is True
    extra = result["extra"]
    assert "cannot be written" in extra["c2_negadsr_error"]
    assert extra["c1_chip_xrt"] > 0 and extra["c1_e2e_xrt"] > 0
    assert "playback_gen_per_wall" in extra
    assert "chip:c1" in status.read_text()
    capsys.readouterr()
    assert bench.report(result) == 1
    line = _one_line(capsys.readouterr().out)
    assert line["value"] == line["extra"]["c1_chip_xrt"] > 0
    assert "cannot be written" in line["extra"]["c2_negadsr_error"]


def test_sigterm_prints_the_partial_line(tmp_path):
    """SIGTERM once c1's chip timing is banked: the watchdog kills the
    measuring child's group and prints the line with the banked headline
    and the error; the exit status is not 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "termdaw_tpu_torch.bench", "--device", "cpu"],
        cwd=REPO, env=_harness_env(tmp_path, **RUN, BENCH_CONFIGS="c1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    banked = threading.Event()
    err: list[str] = []

    def read_stderr():
        for ln in proc.stderr:
            err.append(ln)
            if ln.startswith("link:"):  # logged after c1 was banked
                banked.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        assert banked.wait(timeout=180), "".join(err)[-3000:]
        proc.send_signal(signal.SIGTERM)
        stdout = proc.stdout.read()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)
    assert not reader.is_alive()
    assert rc != 0
    out = _one_line(stdout)
    assert "SIGTERM" in out["error"]
    assert out["value"] == out["extra"]["c1_chip_xrt"] > 0
