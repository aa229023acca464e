"""The mix session's cell, c8_mix64.bounce: its tiny size for the CPU,
its bfloat16 control, faults underneath the timed path that its check
reads `correct` false on (a SampleLoop that stops at its stem's end
instead of wrapping, a dropped reverb send, a chorus that reads its input
undelayed), and the readers of its two per-layer metrics."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from conftest import TINY

# registered at import, before the pytest session's first tiny copy is
# made (every test module is imported before any test runs); the stems
# are cut with the song, so that they still loop under it
TINY["configs"]["c8_mix64"] = {"length_s": 4.0, "tracks": 4, "stem_s": 2.0}

CELL = "c8_mix64.bounce"


def test_bench_mix_bf16_control_fails(tmp_path, tiny_kept):
    from benchmark.harness.cell import find, limits, project_module
    from benchmark.reference import compare, mix

    c = find(CELL, tiny_kept / "BENCHMARK.json")
    spec = project_module(c.config["project"]).build(c.config, 11,
                                                      tmp_path / "p")
    want = mix.bounce(spec, tmp_path / "p", 3)
    low = mix.bounce(spec, tmp_path / "p", 3, cast=mix.bf16)
    vals = compare.wav_vs(compare.quantize(low, 24), want, 24)
    assert vals["max_err_fs"] > 3 * limits(CELL)["max_err_fs"]


def test_bench_mix_sound_run_passes(drive):
    checks, ok = drive(CELL, 1.0, seed=9)
    assert ok, checks


def test_bench_mix_fault_loop_does_not_wrap(drive, monkeypatch):
    """Every SampleLoop holds its stem's last frame past its end."""
    import torch

    from termdaw_tpu_torch.ops import sampler

    def held(sample, t0, T):
        i = torch.arange(T, dtype=torch.int64, device=sample.device)
        return sample[torch.clamp(t0 + i, max=sample.shape[0] - 1)]

    monkeypatch.setattr(sampler, "sample_loop", held)
    checks, ok = drive(CELL, 1.0)
    assert not ok, checks


def test_bench_mix_fault_send_dropped(drive, monkeypatch):
    """The first track's reverb send loses its input."""
    from termdaw_tpu_torch.graph.graph import Graph

    orig = Graph.connect

    def connect(self, a, b):
        return False if b == "verbsend0" else orig(self, a, b)

    monkeypatch.setattr(Graph, "connect", connect)
    checks, ok = drive(CELL, 1.0)
    assert not ok, checks


def test_bench_mix_fault_chorus_reads_undelayed(drive, monkeypatch):
    """The chorus reads its input where its delay line should be."""
    from termdaw_tpu_torch.ops import fx

    monkeypatch.setattr(fx, "delayed_read", lambda x, tail, delay: x)
    checks, ok = drive(CELL, 1.0)
    assert not ok, checks


def test_bench_mix_graph_nodes_reads_the_counter():
    from benchmark.harness import cell as cells

    read = cells.metric_reader("graph_nodes.mix")
    assert read(SimpleNamespace(graph_nodes=12345.0)) == 12345.0
    assert read(SimpleNamespace()) is None


def test_bench_mix_scans_roofline_counts_the_session():
    """The scan family's share: the session's least work over the
    profiled seconds of the scan kernels; nothing without them."""
    from benchmark.harness import cell as cells
    from benchmark.harness import work, work_mix

    read = cells.metric_reader("scans_roofline.mix")
    spec = {"sr": 48000, "bl": 1024, "length_s": 1.0,
            "plugins": {"t": {"kind": "tape"}, "c": {"kind": "chorus"}},
            "vertices": [{"kind": "sample_loop"},
                         {"kind": "fx", "plugin": "t"},
                         {"kind": "fx", "plugin": "c"}]}
    kind = next(iter(work.PEAKS))

    def run(kernels):
        return SimpleNamespace(trace=SimpleNamespace(units=2, kernels=kernels),
                               device_kind=kind, spec=spec)

    assert read(run({"voice_mix_kernel": 1e-3})) is None
    T = 47 * 1024
    assert work_mix.scan_work(spec) == work._linear(T, 2)
    got = read(run({"tile_scan<4>": 1e-3, "tile_reduce<4>": 1e-3}))
    least = work.least_s(*work._linear(T, 2), work.PEAKS[kind]) * 2
    assert got == pytest.approx(100.0 * least / 2e-3)
    assert np.isfinite(got)
