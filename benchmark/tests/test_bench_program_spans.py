"""The per-layer metrics that read the program's own spans
(harness/program_spans.py and the readers in metrics/), and the records
of the program's recorder as a `spans` argument of the trace
reduction."""

from __future__ import annotations

import time
import types

import pytest

from benchmark.harness import trace as bench_trace
from benchmark.harness.cell import metric_reader
from termdaw_tpu_torch.utils import prof


def test_bench_program_records_name_a_gap_in_the_trace_reduction():
    """[(t0, t1, name)] of the records is a `spans` argument of
    reduce_events: a device gap in the middle of a program span is named
    by it, the innermost."""
    with prof.recording():
        with prof.span("outer"):
            time.sleep(0.002)
            with prof.span("inner"):
                time.sleep(0.02)
            time.sleep(0.002)
    inner, outer = prof.records()[-2:]
    t_window = outer.t0 - 0.001
    w0 = 1000.0                                  # the trace's microseconds

    def us(t):
        return w0 + (t - t_window) * 1e6

    mid = 0.5 * (inner.t0 + inner.t1)
    gap = (us(mid) - 2000.0, us(mid) + 2000.0)   # 4 ms idle inside inner
    w1 = us(outer.t1) + 1000.0
    events = [
        {"name": bench_trace.WINDOW, "ph": "X", "cat": "user_annotation",
         "ts": w0, "dur": w1 - w0},
        {"name": "k0", "ph": "X", "cat": "kernel", "ts": w0,
         "dur": gap[0] - w0},
        {"name": "k1", "ph": "X", "cat": "kernel", "ts": gap[1],
         "dur": w1 - gap[1]},
    ]
    spans = [(s.t0, s.t1, s.name) for s in prof.records()]
    tr = bench_trace.reduce_events(events, spans, t_window, 1)
    assert set(tr.gaps) == {"inner"}
    assert tr.gaps["inner"] == pytest.approx(0.004, abs=1e-9)


READERS = {"enqueue_ms.bounce": "window",
           "fetch_wait_ms.bounce": "fetch",
           "wav_encode_ms.bounce": "wav encode"}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_bench_reader_of_a_program_span(metric, monkeypatch):
    """The reader sums its span's records inside the traced window, over
    the traced bounces, in ms; none without a trace, without such a
    span, or against a program whose recorder has no records."""
    read = metric_reader(metric)
    name = READERS[metric]
    rec = types.SimpleNamespace
    recs = [rec(name=name, t0=99.0, t1=100.5),      # before the window
            rec(name=name, t0=100.1, t1=100.103),
            rec(name=name, t0=100.2, t1=100.205),
            rec(name="other", t0=100.3, t1=100.4),
            rec(name=name, t0=100.9, t1=101.2)]     # ends after it
    monkeypatch.setattr(prof, "records", lambda: recs)
    run = types.SimpleNamespace(
        tracer=types.SimpleNamespace(t_window=100.0),
        trace=types.SimpleNamespace(units=2, window_s=1.0))
    assert read(run) == pytest.approx((0.003 + 0.005) / 2 * 1e3)
    monkeypatch.setattr(prof, "records", lambda: recs[3:4])
    assert read(run) is None
    run.trace = None
    assert read(run) is None
    run.trace = types.SimpleNamespace(units=2, window_s=1.0)
    monkeypatch.delattr(prof, "records")
    assert read(run) is None
