"""The shipped examples through the port on the CPU, with the port alone.

The port's asset generator (termdaw_tpu_torch/utils/example_assets.py)
against the reference's examples/_gen.py, the port's renders of the four
golden examples against tests/goldens/{name}.cpu.wav (the bound and
length of tests/test_examples.py, read from tools/make_goldens.py), the
five manual examples at full length, the CLI opening a fresh copy of an
example with `jax` and every `termdaw_tpu` module blocked, and the port's
stream generator (termdaw_tpu_torch/tools/stream_gen.py) against
tools/stream_gen.py and piped into the CLI on the stream example.
"""

import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from termdaw_tpu_torch.fileio.wav import read_wav
from termdaw_tpu_torch.utils import example_assets
from termdaw_tpu_torch.utils.fixtures import (
    alone_argv, load_state, read_wav_ints,
)
from tools.make_goldens import (
    EXAMPLES as GOLDEN_EXAMPLES, GOLDEN_BLOCKS, SAME_BACKEND_TOL_DBFS,
)

from .conftest import scrubbed_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MANUAL = ["project", "sample-project", "neg-adsr-env", "synth-adsr-fx",
          "generative"]


def _copy_examples(dst: Path, names) -> Path:
    """Copies of examples/<name> (project.lua, project.toml and
    make_assets.py) under dst/examples, without assets/ or _gen.py."""
    root = dst / "examples"
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        for f in ("project.lua", "project.toml", "make_assets.py"):
            shutil.copyfile(REPO / "examples" / name / f, d / f)
    return root


@pytest.fixture(scope="module")
def examples(tmp_path_factory) -> Path:
    """Every example copied into one temp dir, its assets generated by the
    port."""
    root = _copy_examples(tmp_path_factory.mktemp("ex"), MANUAL + ["stream"])
    example_assets.ensure(root / "assets")
    return root


def _render(d: Path, out: Path, blocks: int | None = None) -> None:
    st = load_state(d, CPU)
    if blocks is not None:
        st.cs = blocks
    st.output_file = str(out)
    st.render()


def test_example_assets_match_reference_generator(tmp_path, monkeypatch):
    """example_assets.ensure writes the file set of examples/_gen.py's
    ensure, every file byte-identical, and skips what exists."""
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import _gen
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(_gen, "ASSETS", tmp_path / "b")
    want = _gen.ensure()
    got = example_assets.ensure(tmp_path / "a")
    names = sorted(p.name for p in want.iterdir())
    assert sorted(p.name for p in got.iterdir()) == names
    assert len(names) == 16
    for n in names:
        assert (got / n).read_bytes() == (want / n).read_bytes(), n
    stamps = {n: (got / n).stat().st_mtime_ns for n in names}
    example_assets.ensure(got)
    assert {n: (got / n).stat().st_mtime_ns for n in names} == stamps


@pytest.mark.parametrize("name", GOLDEN_EXAMPLES)
def test_example_matches_golden(name, examples, tmp_path):
    """The port's CPU render of GOLDEN_BLOCKS blocks within
    SAME_BACKEND_TOL_DBFS (one 16-bit LSB) of the committed CPU golden."""
    _render(examples / name, tmp_path / "out.wav", GOLDEN_BLOCKS)
    got, _ = read_wav(tmp_path / "out.wav", scale=True)
    want, _ = read_wav(REPO / "tests" / "goldens" / f"{name}.cpu.wav",
                       scale=True)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    err_dbfs = 20.0 * math.log10(max(err, 1e-12))
    assert err_dbfs <= SAME_BACKEND_TOL_DBFS, (name, err_dbfs)


@pytest.mark.parametrize("name", MANUAL)
def test_example_renders_whole_song(name, examples, tmp_path):
    """Each manual example rendered at its full length: finite, not
    silent (tests/test_examples.py's check), 16-bit stereo at 48 kHz."""
    _render(examples / name, tmp_path / "out.wav")
    audio, spec = read_wav(tmp_path / "out.wav", scale=True)
    assert (spec.channels, spec.sample_rate, spec.bits_per_sample) == (
        2, 48000, 16)
    seconds = 16.0 if name == "generative" else 40.0
    assert len(audio) == int(seconds * 48000)
    assert np.all(np.isfinite(audio))
    assert np.max(np.abs(audio)) > 1e-4, f"{name} rendered silence"


def test_cli_opens_example_with_port_alone(tmp_path):
    """`python -m termdaw_tpu_torch --device cpu` on a fresh copy of
    examples/project (no assets/, no _gen.py beside it) with jax and the
    JAX package blocked: the first-run hook generates the assets through
    the port, and the WAV equals the in-process port render."""
    root = _copy_examples(tmp_path, ["project"])
    proc = subprocess.run(
        alone_argv("termdaw_tpu_torch", "--device", "cpu",
                   str(root / "project")),
        input="render\nquit\n", cwd=REPO, capture_output=True, text=True,
        timeout=240, env=scrubbed_env(TERMDAW_SINK="null",
                                      OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done rendering" in proc.stdout
    assert len(list((root / "assets").iterdir())) == 16
    wav = root / "project" / "outp.wav"
    got, rate = read_wav_ints(wav)
    _render(root / "project", wav)
    want, _ = read_wav_ints(wav)
    assert rate == 48000 and got.size == 2 * 40 * 48000
    np.testing.assert_array_equal(got, want)


def test_stream_gen_matches_reference():
    """The port's stream_gen with --burst writes the bytes of
    tools/stream_gen.py for the same arguments."""
    args = ["--burst", "--seed", "3", "--duration", "8",
            "--streams", "kick,snare,hihat,ride,bass,chords"]
    env = scrubbed_env()
    want = subprocess.run(
        [sys.executable, str(REPO / "tools" / "stream_gen.py"), *args],
        capture_output=True, timeout=120, env=env, check=True).stdout
    got = subprocess.run(
        alone_argv("termdaw_tpu_torch.tools.stream_gen", *args), cwd=REPO,
        capture_output=True, timeout=120, env=env, check=True).stdout
    assert len(want) > 1000
    assert got == want


def test_stream_gen_pipes_into_cli(examples, tmp_path):
    """The port's stream_gen, paced for 4 s, piped into the port's CLI on
    the stream example, jax and the JAX package blocked in both: both
    exit 0 and the captured playback is finite and audible. The CLI runs
    one thread, as this module does: the Player, like the reference's,
    renders until it has caught up with the wall clock, and on a busy
    host a window's threads waiting on each other can keep it slower
    than real time."""
    cap = tmp_path / "capture.wav"
    env = scrubbed_env(TERMDAW_SINK=f"file:{cap}", TERMDAW_STREAM_IDLE="2",
                       OMP_NUM_THREADS="1")
    gen = subprocess.Popen(
        alone_argv("termdaw_tpu_torch.tools.stream_gen", "--duration", "4",
                   "--streams", "kick,snare,hihat,ride,bass,chords"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    try:
        daw = subprocess.run(
            alone_argv("termdaw_tpu_torch", "--device", "cpu",
                       str(examples / "stream")),
            stdin=gen.stdout, cwd=REPO, capture_output=True, text=True,
            timeout=240, env=env)
    finally:
        gen.stdout.close()
        try:
            gen_rc = gen.wait(timeout=60)
        except subprocess.TimeoutExpired:
            gen.kill()
            gen_rc = gen.wait()
        gen_err = gen.stderr.read().decode()
        gen.stderr.close()
    assert gen_rc == 0, gen_err
    assert daw.returncode == 0, daw.stdout + daw.stderr
    assert "stream_gen: 120.0 bpm" in daw.stdout
    audio, spec = read_wav(cap, scale=True)
    assert spec.sample_rate == 48000 and len(audio) > 0
    assert np.all(np.isfinite(audio))
    assert np.max(np.abs(audio)) > 0.05
