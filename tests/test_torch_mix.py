"""The port against the plain reference of a mix session
(benchmark/reference/mix.py, the benchmark's own) on the CPU: SampleLoop
stems that wrap and restart at every render, Sum buses fanned in and out
with gains and pans, tape, chorus and flanger alone, and a small session
of the benchmark's layout (benchmark/projects/mix_session.py) over three
renders. Each case is held to a tolerance written with its reason, which
the reference computed with every vertex's output in bfloat16 fails."""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.projects import mix_session as ms
from benchmark.reference import mix
from termdaw_tpu_torch.fileio.wav import read_wav
from termdaw_tpu_torch.utils.fixtures import load_state

ROOT = Path(__file__).resolve().parents[1]
FULL = float(2 ** 23 - 1)

# the float32 signal path against float64, after the 24-bit truncation
# (1.2e-7 of full scale): the loader's peak division, pans, gains, sums
# and the tape's one-pole round at about 6e-8 of the signal a step
EXACT = 2e-6
# chorus and flanger read their delay line at float32 positions, whose
# step at these window lengths is 2^-8 of a frame, times the signal's
# slope (a few hundredths a frame for these tones)
READ = 1e-3
# the session adds the eq3's poles, taken in float32, and the
# compressors' envelopes and the reverb's and delay's lines in float32
SESSION = 1e-3


def _spec(d: Path, vertices: list, edges: list, samples: dict,
          plugins: dict | None = None, length_s: float = 1.5) -> dict:
    spec = {"sr": 48000, "bl": 1024, "length_s": length_s,
            "render_sr": 48000, "bd": 24, "samples": samples,
            "plugins": plugins or {}, "vertices": vertices, "edges": edges,
            "output": "out", "packets": b""}
    ms.write_project(spec, d)
    return spec


def _stem(d: Path, name: str, kind: str, seconds: float, seed: int) -> None:
    ms.write_wav24(d / f"{name}.wav", ms.stem(
        kind, 48000, seconds, 120.0, np.random.default_rng(seed)), 48000)


def loop_wrap(d: Path) -> dict:
    """A 0.5 s stem looped under a 1.5 s song of 71 blocks: it wraps three
    times a render and starts again at every render."""
    _stem(d, "s", "kick", 0.5, 1)
    return _spec(d, [{"name": "t", "kind": "sample_loop", "sample": "s",
                      "gain": 0.8, "angle": 25.0},
                     {"name": "out", "kind": "normalize"}],
                 [["t", "out"]], {"s": "s.wav"})


def sum_fan(d: Path) -> dict:
    """Two loops into a bus Sum, the bus fanned out to two send Sums and
    the output, one loop also read by a send."""
    _stem(d, "a", "kick", 0.5, 2)
    _stem(d, "b", "keys", 1.0, 3)
    return _spec(d, [
        {"name": "a", "kind": "sample_loop", "sample": "a", "gain": 0.7,
         "angle": -30.0},
        {"name": "b", "kind": "sample_loop", "sample": "b"},
        {"name": "bus", "kind": "sum", "gain": 0.9},
        {"name": "s1", "kind": "sum", "gain": 0.3},
        {"name": "s2", "kind": "sum", "gain": 0.5, "angle": 45.0},
        {"name": "out", "kind": "normalize"}],
        [["a", "bus"], ["b", "bus"], ["bus", "s1"], ["bus", "s2"],
         ["b", "s2"], ["s1", "out"], ["s2", "out"], ["bus", "out"]],
        {"a": "a.wav", "b": "b.wav"})


def alone(kind: str, stem: str):
    """One loop through one effect, its output panned and scaled."""
    def build(d: Path) -> dict:
        _stem(d, "s", stem, 1.0, 4)
        wet = 0.5 if kind in ("chorus", "flanger") else 1.0
        params = ms.effect_params(kind, np.random.default_rng(5))
        return _spec(d, [
            {"name": "t", "kind": "sample_loop", "sample": "s"},
            {"name": "f", "kind": "fx", "wet": wet, "plugin": "f",
             "gain": 0.8, "angle": 20.0},
            {"name": "out", "kind": "normalize"}],
            [["t", "f"], ["f", "out"]], {"s": "s.wav"},
            {"f": {"kind": kind, "params": params}})
    return build


def session(d: Path) -> dict:
    """The benchmark's layout at 4 tracks: a chorus on the keys, a
    flanger on the pad, the reverb and delay sends, the master chain."""
    cfg = json.loads((ROOT / "benchmark/configs/c8_mix64.json").read_text())
    cfg.update({"tracks": 4, "length_s": 1.0, "stem_s": 0.5,
                "stems": ["kick", "keys", "pad", "bass"],
                "chorus_tracks": [4, 1], "flanger_tracks": [4, 2],
                "delay_tracks": [4, 0]})
    return ms.build(cfg, 20261018, d)


CASES = {
    "loop_wrap": (loop_wrap, 2, EXACT),
    "sum_fan": (sum_fan, 2, EXACT),
    "tape": (alone("tape", "keys"), 2, EXACT),
    "chorus": (alone("chorus", "keys"), 2, READ),
    "flanger": (alone("flanger", "pad"), 2, READ),
    "session": (session, 3, SESSION),
}


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap of the WAV's integers from the reference's unrounded
    samples, as a share of full scale."""
    assert got.shape == want.shape
    want = np.clip(want, -FULL - 1, FULL)
    return float(np.abs(got.astype(np.float64) - want).max() / FULL)


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_the_mix_reference(tmp_path, case):
    build, renders, tol = CASES[case]
    torch.set_num_threads(1)
    spec = build(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        st = load_state(tmp_path, torch.device("cpu"))
        for _ in range(renders):
            st.render()
    got, info = read_wav(tmp_path / "outp.wav")
    assert (info.sample_rate, info.bits_per_sample) == (48000, 24)
    want = mix.bounce(spec, tmp_path, renders)
    assert _gap(got, want) < tol
    low = mix.bounce(spec, tmp_path, renders, cast=mix.bf16)
    assert _gap(np.trunc(low), want) > tol


def test_program_arms_by_kind(tmp_path):
    """The window program's arms by kind, as a capture records them: one
    a vertex, an effect's by its effect kind. On the CPU nothing is
    captured, so no replay adds nodes."""
    from termdaw_tpu_torch.graph.compile import _arms

    spec = session(tmp_path)
    want: dict = {}
    for v in spec["vertices"]:
        k = {"sample_loop": "sampleloop", "fx": "pluginfx."}.get(
            v["kind"], v["kind"])
        if k == "pluginfx.":
            k += spec["plugins"][v["plugin"]]["kind"]
        want[k] = want.get(k, 0) + 1
    with contextlib.redirect_stdout(io.StringIO()):
        st = load_state(tmp_path, torch.device("cpu"))
        st.render()
    assert _arms(st.compiled) == want
    assert st.compiled.replayed_nodes == 0
    assert [p.nodes for p in st.compiled.programs()] == [0]


def test_mix_reference_recurrences_against_a_loop():
    """The reference's blocked recurrences equal a plain loop in
    float64, across many blocks and for both orders."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3 * mix.BLOCK + 17, 2))
    for a in ([-0.999], [-1.97, 0.9704]):
        want = np.zeros_like(x)
        for t in range(len(x)):
            want[t] = x[t] - sum(
                a[k] * want[t - 1 - k] for k in range(len(a)) if t > k)
        got = mix.allpole(torch.from_numpy(x), a).numpy()
        # float64 rounding of the block products, against the signal's
        # peak
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-11 * np.abs(want).max())
