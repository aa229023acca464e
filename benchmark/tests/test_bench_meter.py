"""The per-layer metrics that read the program's render meter
(harness/meter.py and the `meter_*` readers in metrics/) on synthetic
render records: only the renders whose interval (from the previous
render's end) begins after the traced window count, the idle share is
taken over the split renders' own intervals, each value is a bounce's,
and a run without a trace, without such records or against a program
without the meter reads none."""

from __future__ import annotations

import types

import pytest

from benchmark.harness.cell import metric_reader
from termdaw_tpu_torch.utils import prof


def _render(t0, t1, prev_t1, busy_ms, idle_ms, windows):
    steps = [("window", a, b, 2) for a, b in windows]
    steps.append(("render", t0, t1, 0))
    return types.SimpleNamespace(
        t0=t0, t1=t1, prev_t1=prev_t1, steps=steps, busy_ms=busy_ms,
        idle_ms=idle_ms,
        busy=None if busy_ms is None else [[t0, t0 + busy_ms * 1e-3]])


RENDERS = [
    # inside the traced window [100, 101): not read
    _render(100.2, 100.3, None, 50.0, {"wav write": 40.0, "window": 9.0},
            [(100.21, 100.25)]),
    # after the window, but its interval begins inside it (the
    # profiler's teardown): not read
    _render(101.0, 101.010, 100.3, 6.0, {"outside": 700.0, "window": 4.0},
            [(101.001, 101.002)]),
    _render(101.011, 101.019, 101.010, 6.0,
            {"wav write": 1.0, "wav encode": 0.5, "wav file": 0.25,
             "window": 0.5, "seed caps": 0.25, "render": 0.5},
            [(101.012, 101.013), (101.014, 101.0145)]),
    # no device split: its host steps count, its idle does not, and it
    # lies between the split renders' intervals
    _render(101.020, 101.028, 101.019, None, None, [(101.021, 101.022)]),
    _render(101.030, 101.040, 101.028, 6.0,
            {"wav file": 2.0, "window.bake": 1.0, "quantize": 0.5,
             "render.device": 0.5, "outside": 2.0},
            [(101.031, 101.0325)]),
]

WANT = {
    # idle over the split renders' own intervals, 9 ms and 12 ms
    "meter_idle_pct.bounce": 100.0 * (3.0 + 6.0) / (9.0 + 12.0),
    "meter_idle_wav_ms.bounce": (1.75 + 2.0) / 2,
    "meter_idle_enqueue_ms.bounce": (0.75 + 2.0) / 2,
    "meter_window_ms.bounce": (1.0 + 0.5 + 1.0 + 1.5) / 3,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_bench_reader_of_the_render_meter(metric, monkeypatch):
    read = metric_reader(metric)
    monkeypatch.setattr(prof, "renders", lambda: RENDERS)
    run = types.SimpleNamespace(
        tracer=types.SimpleNamespace(t_window=100.0),
        trace=types.SimpleNamespace(units=3, window_s=1.0))
    assert read(run) == pytest.approx(WANT[metric])
    monkeypatch.setattr(prof, "renders", lambda: RENDERS[:1])
    assert read(run) is None
    monkeypatch.setattr(prof, "renders", lambda: [])
    assert read(run) is None
    monkeypatch.setattr(prof, "renders", lambda: RENDERS)
    run.trace = None
    assert read(run) is None
    run.trace = types.SimpleNamespace(units=3, window_s=1.0)
    monkeypatch.delattr(prof, "renders")
    assert read(run) is None
