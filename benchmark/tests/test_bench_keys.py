"""The sampled-piano session's cell, c10_piano16.bounce: its tiny size for
the CPU, its bfloat16 control, faults underneath the timed path that its
check reads `correct` false on (the loud velocity layer dropped, voices
cut at the window's end instead of carried, a same-frame chord note let
through the drum rule), and the readers of its two per-layer metrics."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from conftest import TINY

# registered at import, before the pytest session's first tiny copy is
# made (every test module is imported before any test runs): 2 tracks of
# 6 keys x 2 layers over a 2 s song (one bar), samples shorter than it
TINY["configs"]["c10_piano16"] = {
    "length_s": 2.0, "tracks": 2, "bus_tracks": 1, "keys": [57, 62],
    "sample_s": [0.9, 0.5],
    "left_hand": {"chords": 2, "notes": 2, "low": 57, "high": 59,
                  "spread_ticks": [2, 11], "hold_s": 0.9},
    "right_hand": {"notes": 6, "low": 60, "high": 62, "jitter_ms": 8.0,
                   "hold_s": 0.1}}

CELL = "c10_piano16.bounce"


def test_bench_keys_bf16_control_fails(tmp_path, tiny_kept):
    from benchmark.harness.cell import find, limits, project_module
    from benchmark.reference import compare, keys

    c = find(CELL, tiny_kept / "BENCHMARK.json")
    spec = project_module(c.config["project"]).build(c.config, 11,
                                                      tmp_path / "p")
    want = keys.bounce(spec, tmp_path / "p", 3)
    low = keys.bounce(spec, tmp_path / "p", 3, cast=keys.bf16)
    vals = compare.wav_vs(compare.quantize(low, 24), want, 24)
    assert vals["max_err_fs"] > 3 * limits(CELL)["max_err_fs"]


def test_bench_keys_sound_run_passes(drive):
    checks, ok = drive(CELL, 1.0, seed=9)
    assert ok, checks


def test_bench_keys_fault_loud_layer_dropped(drive, monkeypatch):
    """The groups' members of the loud layer never trigger."""
    from termdaw_tpu_torch.graph.compile import CompiledGraph

    pool_of = CompiledGraph._group_pool

    def soft_only(self, fb, consumer, members):
        pool = pool_of(self, fb, consumer, members)
        loud = np.asarray([self.graph.names[m].endswith("v1")
                           for m in members])
        keep = ~loud[pool[2]]
        return tuple(a[keep] for a in pool)

    monkeypatch.setattr(CompiledGraph, "_group_pool", soft_only)
    checks, ok = drive(CELL, 1.0)
    assert not ok, checks


def test_bench_keys_fault_voices_cut_at_window_end(drive, monkeypatch):
    """No group voice carries into the next window."""
    from termdaw_tpu_torch.graph import bake as B
    from termdaw_tpu_torch.graph.compile import CompiledGraph

    bake_of = CompiledGraph._bake_fused_group

    def cut(self, fb, consumer, members, t0, t1, carries):
        voices, _ = bake_of(self, fb, consumer, members, t0, t1, carries)
        return voices, {m: B.MultiCarry() for m in members}

    monkeypatch.setattr(CompiledGraph, "_bake_fused_group", cut)
    checks, ok = drive(CELL, 1.0)
    assert not ok, checks


def _same_frame_chords(monkeypatch):
    """Each part's chord notes doubled by a note two keys up at the same
    tick and velocity (so in the same floww): termdaw's drum rule passes
    over the second."""
    from benchmark.projects import piano_session

    part = piano_session.part

    def doubled(cfg, track, rng):
        out = []
        for tick, p, vel in part(cfg, track, rng):
            out.append((tick, p, vel))
            if p < cfg["right_hand"]["low"]:
                out.append((tick, p + 2, vel))
        return out

    monkeypatch.setattr(piano_session, "part", doubled)


def test_bench_keys_same_frame_chord_notes_pass_over(drive, monkeypatch):
    _same_frame_chords(monkeypatch)
    checks, ok = drive(CELL, 1.0)
    assert ok, checks


def test_bench_keys_fault_same_frame_note_triggers(drive, monkeypatch):
    """A same-frame on-event is moved to the next frame, so it triggers."""
    from termdaw_tpu_torch.banks.flowwbank import FlowwBank

    _same_frame_chords(monkeypatch)
    frames_of = FlowwBank._event_frames

    def spread(self, i):
        f = frames_of(self, i).copy()
        on = np.nonzero(self.flowws[i][:, 3] > 0.001)[0]
        dup = np.zeros(len(on), bool)
        dup[1:] = f[on][1:] == f[on][:-1]
        f[on[dup]] += 1
        return f

    monkeypatch.setattr(FlowwBank, "_event_frames", spread)
    checks, ok = drive(CELL, 1.0)
    assert not ok, checks


def test_bench_keys_group_fill_reads_the_counters():
    from benchmark.harness import cell as cells

    read = cells.metric_reader("group_fill.keys")
    assert read(SimpleNamespace(group_fill=(3200, 800))) == 25.0
    assert read(SimpleNamespace(group_fill=None)) is None
    assert read(SimpleNamespace(group_fill=(0, 0))) is None
    assert read(SimpleNamespace()) is None


def test_bench_keys_voicemix_roofline_reads_the_kernel():
    """The voice mix kernel's share: the session's least time over the
    profiled seconds of kernels named `voice_mix`; nothing without
    them."""
    from benchmark.harness import cell as cells
    from benchmark.harness import work_keys

    read = cells.metric_reader("voicemix_roofline.keys")
    kind = next(iter(work_keys.PEAKS))
    work = (6.7e8, 3.35e8)

    def run(kernels):
        return SimpleNamespace(trace=SimpleNamespace(units=3, kernels=kernels),
                               device_kind=kind, voicemix_work=work)

    assert read(run({"tile_scan<4>": 1e-3})) is None
    assert read(SimpleNamespace(trace=None, device_kind=kind,
                                voicemix_work=work)) is None
    got = read(run({"{anon}::voice_mix_kernel<true>(float const*)": 4e-4,
                    "sampsyn_kernel": 1.0}))
    least = work_keys.least_s(*work, work_keys.PEAKS[kind])
    assert least == pytest.approx(1e-4)
    assert got == pytest.approx(100.0 * 3 * least / 4e-4)
