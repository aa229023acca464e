"""The comparison that decides `correct` fails what it should: the
program's output brought to a lower precision, the reference's own
bfloat16 control, and runs whose timed path is broken underneath (a
window that leaves its state unchanged, half the tracks left out, a
sample altered where it is produced, the song cut short, the prebuffer
shrunk, playback stopped short)."""

from __future__ import annotations


import numpy as np
import pytest

from conftest import TINY
from benchmark.harness.cell import find, limits
from benchmark.reference import compare, precision


def _spec(tmp_path, bench, cell):
    from benchmark.harness.cell import project_module

    c = find(cell, bench / "BENCHMARK.json")
    c.config.update(TINY["configs"][c.workload["config"]])
    return project_module(c.config["project"]).build(c.config, 11,
                                                      tmp_path / "p")


@pytest.mark.parametrize("cell", ["c4_fullgraph.bounce",
                                  "c5_stream64.bounce"])
def test_bench_sound_runs_pass(drive, cell):
    checks, ok = drive(cell, 1.0, seed=9)
    assert ok, checks


@pytest.mark.parametrize("cell", ["c4_fullgraph.bounce",
                                  "c5_stream64.bounce"])
def test_bench_bf16_control_fails(tmp_path, tiny_kept, cell):
    spec = _spec(tmp_path, tiny_kept, cell)
    vals = compare.bounce_control(spec, tmp_path / "p")
    assert vals["max_err_fs"] > 3 * limits(cell)["max_err_fs"]


def test_bench_program_output_in_bf16_fails(drive, monkeypatch):
    """The program's own render, rounded to bfloat16 before the
    quantize, fails the bounce check."""
    from termdaw_tpu_torch.ops import quantize

    orig = quantize.quantize_interleave

    def low(x, bd):
        import torch

        return orig(x.to(torch.bfloat16).to(torch.float32), bd)

    monkeypatch.setattr(quantize, "quantize_interleave", low)
    checks, ok = drive("c4_fullgraph.bounce", 1.0)
    assert not ok and checks["max_err_fs"]["value"] > 3 * checks[
        "max_err_fs"]["limit"]


def test_bench_fault_state_unchanged(drive, monkeypatch):
    """Every window program leaves the graph's carried state as it found
    it: the renders after the first start fresh, not from the song's
    end."""
    from termdaw_tpu_torch.graph.compile import CompiledGraph

    orig = CompiledGraph.render_window

    def frozen(self, fb, nb, *a, **kw):
        saved = dict(self.carries)
        out = orig(self, fb, nb, *a, **kw)
        self.carries.update(saved)
        return out

    monkeypatch.setattr(CompiledGraph, "render_window", frozen)
    checks, ok = drive("c4_fullgraph.bounce", 1.0)
    assert not ok, checks


def test_bench_fault_half_the_tracks(drive, monkeypatch):
    """Half of the streamed tracks' hits are dropped inside the feed."""
    from termdaw_tpu_torch.banks.flowwbank import FlowwBank

    orig = FlowwBank.append_streams

    def half(self, pkts):
        return orig(self, [p for p in pkts
                           if p.name and int(p.name[1:]) % 2 == 0])

    monkeypatch.setattr(FlowwBank, "append_streams", half)
    checks, ok = drive("c5_stream64.bounce", 1.0)
    assert not ok, checks


@pytest.mark.parametrize("cell", ["c4_fullgraph.bounce",
                                  "c5_stream64.bounce",
                                  "c4_fullgraph.refresh",
                                  "c5_stream64.live"])
def test_bench_fault_sample_altered(drive, monkeypatch, cell):
    """One sample of every window is altered where the window program
    produces it."""
    from termdaw_tpu_torch.graph.compile import CompiledGraph

    orig = CompiledGraph.render_window

    def altered(self, fb, nb, *a, **kw):
        out = orig(self, fb, nb, *a, **kw)
        out = out.contiguous().clone()
        out.view(-1)[out.numel() // 3] += 0.05
        return out

    monkeypatch.setattr(CompiledGraph, "render_window", altered)
    checks, ok = drive(cell, 1.5)
    assert not ok, checks


def test_bench_fault_live_hits_dropped(drive, monkeypatch):
    """The stream workflow appends only half of each packet's streams."""
    from termdaw_tpu_torch.banks.flowwbank import FlowwBank

    orig = FlowwBank.append_streams
    seen = {"n": 0}

    def drop(self, pkts):
        seen["n"] += 1
        return orig(self, pkts if seen["n"] % 2 else [])

    monkeypatch.setattr(FlowwBank, "append_streams", drop)
    checks, ok = drive("c5_stream64.live", 2.0)
    assert not ok, checks


@pytest.mark.parametrize("cell", ["c4_fullgraph.bounce",
                                  "c5_stream64.bounce"])
def test_bench_fault_song_cut_short(drive, monkeypatch, cell):
    """Every bounce writes only the first half of the song."""
    from termdaw_tpu_torch.engine.state import State

    orig = State.render_device

    def half(self):
        return [c[: c.shape[0] // 2] for c in orig(self)]

    monkeypatch.setattr(State, "render_device", half)
    checks, ok = drive(cell, 1.0)
    assert not ok
    assert checks["frames_off"]["value"] > 0, checks
    assert checks["bounces_off"]["value"] > 0, checks


def test_bench_fault_prebuffer_shrunk(drive, monkeypatch):
    """play() queues half of termdaw's prebuffer."""
    from termdaw_tpu_torch.engine.player import Player

    monkeypatch.setattr(Player, "PREBUFFER_BLOCKS", 8)
    checks, ok = drive("c4_fullgraph.refresh", 1.5)
    assert not ok and checks["prebuffer_short"]["value"] > 0, checks


def test_bench_fault_playback_stops_short(drive, monkeypatch):
    """Playback stops at its first tick, past the prebuffer."""
    from termdaw_tpu_torch.engine.player import Player

    monkeypatch.setattr(Player, "tick", Player.stop)
    checks, ok = drive("c4_fullgraph.refresh", 1.5)
    assert not ok and checks["frames_off"]["value"] > 0, checks


def test_bench_roofline_needs_every_family():
    """The kernels' share reads nothing where a family the project needs
    ran no kernel under its names, and counts every family otherwise."""
    from types import SimpleNamespace

    from benchmark.harness import cell as cells
    from benchmark.harness import work

    read = cells.metric_reader("kernels_roofline.bounce")
    spec = {"sr": 48000, "bl": 1024, "length_s": 1.0,
            "vertices": [{"kind": "sample_multi", "sample": "s",
                          "floww": "f"}, {"kind": "bandpass"}],
            "hit_counts": {"f": 4}}
    kind = next(iter(work.PEAKS))

    def run(kernels):
        trace = SimpleNamespace(units=1, kernels=kernels)
        return SimpleNamespace(trace=trace, device_kind=kind, spec=spec,
                               sample_frames={"s": 4800})

    assert read(run({"voice_mix_kernel": 1e-3})) is None
    both = read(run({"voice_mix_kernel": 1e-3, "tile_scan<4>": 1e-3}))
    need = work.bounce_work(spec, {"s": 4800})
    least = sum(work.least_s(*w, work.PEAKS[kind]) for w in need.values())
    assert both == pytest.approx(100.0 * least / 2e-3)


def test_bench_resample_of_a_sine_keeps_its_level():
    """The reference's resampler passes a 1 kHz sine at unity gain."""
    from benchmark.reference.effects import resample

    t = np.arange(48000) / 48000
    x = np.stack([np.sin(2 * np.pi * 1000 * t)] * 2, 1)
    y = resample(x, 48000, 44100)
    assert len(y) == 44100
    mid = y[2000:-2000, 0]
    assert abs(np.max(np.abs(mid)) - 1.0) < 2e-3


def test_bench_bf16_rounding():
    x = np.array([1.0, 1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9, -3.14159])
    y = precision.bf16(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.0 + 2 ** -7 * 1
    assert abs(y[3] + 3.14159) < 2 ** -7 * 4
