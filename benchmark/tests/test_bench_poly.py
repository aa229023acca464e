"""The instrument session's cell, c9_poly32.bounce: its tiny size for the
CPU, its bfloat16 control, faults underneath the timed path that its
check reads `correct` false on (the Synths' triangle oscillator dropped,
the release cut to 0, the SampSyns' snapshot blend frozen at snapshot 0),
and the readers of its two per-layer metrics."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import TINY

# registered at import, before the pytest session's first tiny copy is
# made (every test module is imported before any test runs): 2 Synths and
# 2 SampSyns over a 4 s song, two buses
TINY["configs"]["c9_poly32"] = {"length_s": 4.0, "tracks": 4,
                                "bus_tracks": 2}

CELL = "c9_poly32.bounce"


def test_bench_poly_bf16_control_fails(tmp_path, tiny_kept):
    from benchmark.harness.cell import find, limits, project_module
    from benchmark.reference import compare, poly

    c = find(CELL, tiny_kept / "BENCHMARK.json")
    spec = project_module(c.config["project"]).build(c.config, 11,
                                                      tmp_path / "p")
    want = poly.bounce(spec, tmp_path / "p", 3)
    low = poly.bounce(spec, tmp_path / "p", 3, cast=poly.bf16)
    vals = compare.wav_vs(compare.quantize(low, 24), want, 24)
    assert vals["max_err_fs"] > 3 * limits(CELL)["max_err_fs"]


def test_bench_poly_sound_run_passes(drive):
    checks, ok = drive(CELL, 1.0, seed=9)
    assert ok, checks


def test_bench_poly_fault_triangle_dropped(drive, monkeypatch):
    """The Synths' triangle oscillator is silent."""
    import torch

    from termdaw_tpu_torch.ops import osc

    monkeypatch.setattr(osc, "triangle",
                        lambda t, hz: torch.zeros_like(t * hz))
    checks, ok = drive(CELL, 1.0)
    assert not ok, checks


def test_bench_poly_fault_release_cut(drive, monkeypatch):
    """Every note falls silent at its note-off."""
    import torch

    from termdaw_tpu_torch.ops import synthv

    monkeypatch.setattr(synthv, "apply_r_rt",
                        lambda conf, t, rt: torch.zeros_like(t))
    checks, ok = drive(CELL, 1.0)
    assert not ok, checks


def test_bench_poly_fault_blend_frozen(drive, monkeypatch):
    """The SampSyns read snapshot 0 at every age."""
    from termdaw_tpu_torch.ops import synthv

    plain = synthv.sampsyn_plain

    def frozen(bake, frames, nb, bl, conf, times, waves, ib):
        return plain(bake, frames, nb, bl, conf, times,
                     waves[:1].expand_as(waves).contiguous(), ib)

    monkeypatch.setattr(synthv, "sampsyn_plain", frozen)
    checks, ok = drive(CELL, 1.0)
    assert not ok, checks


def test_bench_poly_voice_fill_reads_the_counters():
    from benchmark.harness import cell as cells

    read = cells.metric_reader("voice_fill.poly")
    assert read(SimpleNamespace(note_fill=(3200, 1600))) == 50.0
    assert read(SimpleNamespace(note_fill=None)) is None
    assert read(SimpleNamespace(note_fill=(0, 0))) is None
    assert read(SimpleNamespace()) is None


def test_bench_poly_sampsyn_roofline_reads_the_kernel():
    """The SampSyn kernel's share: the session's least time over the
    profiled seconds of kernels named `sampsyn`; nothing without them."""
    from benchmark.harness import cell as cells
    from benchmark.harness import work_poly

    read = cells.metric_reader("sampsyn_roofline.poly")
    kind = next(iter(work_poly.PEAKS))
    work = (6.7e9, 1e8)

    def run(kernels, **kw):
        return SimpleNamespace(trace=SimpleNamespace(units=3, kernels=kernels),
                               device_kind=kind, sampsyn_work=work, **kw)

    assert read(run({"tile_scan<4>": 1e-3})) is None
    assert read(SimpleNamespace(trace=None, device_kind=kind,
                                sampsyn_work=work)) is None
    got = read(run({"sampsyn_kernel(long long const*)": 2e-3,
                    "voice_mix_kernel": 1.0}))
    least = work_poly.least_s(*work, work_poly.PEAKS[kind])
    assert least == pytest.approx(1e-4)
    assert got == pytest.approx(100.0 * 3 * least / 2e-3)
