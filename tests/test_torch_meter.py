"""The port's render meter (termdaw_tpu_torch/utils/prof.py): always on,
it ticks a render's metered steps into one record a render, maps the
render's device marks onto the host clock from its anchor (one render
in SPLIT_EVERY on a card), and puts the time the stream held none of
the render's work down to the innermost step open on the host. On the
CPU a render has no device split; the device path runs here against a
stand-in stream and timing events on a clock the test moves. The card's
tests are in tests/test_torch_cuda.py. Imports no JAX."""

import collections
import itertools
import threading
import time
import types

import pytest
import torch

from termdaw_tpu_torch.utils import prof
from termdaw_tpu_torch.utils.fixtures import load_state, write_c1_project

_split_every = prof.SPLIT_EVERY

# each metered step and the step it runs inside, as the call sites nest
PARENT = {"render.device": "render", "seed caps": "render.device",
          "window": "render.device", "window.bake": "window",
          "resample": "render.device", "quantize": "render.device",
          "fetch": "render", "wav write": "render",
          "wav encode": "wav write", "wav file": "wav write"}


@pytest.fixture
def quiet(monkeypatch):
    """No TERMDAW_TIMING and no TERMDAW_PROFILE, and a store of the
    meter's own for the test, whose first render has no previous one."""
    monkeypatch.setattr(prof, "TIMING", False)
    monkeypatch.setattr(prof, "PROFILE_DIR", "")
    monkeypatch.setattr(prof, "_renders",
                        collections.deque(maxlen=prof.MAX_RENDERS))
    monkeypatch.delitem(prof._local.__dict__, "last_t1", raising=False)


class _Clock:
    """The meter's clock, moved by hand: `wait(s)` stands for `s` seconds
    of host work."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def wait(self, seconds):
        self.t += seconds


class _Event:
    """A timing event read off the stand-in stream's clock (ms)."""

    made = 0

    def __init__(self, device=None, *, enable_timing=False):
        assert enable_timing and device.type == "cuda"
        type(self).made += 1
        self.t = None
        self.done = True

    def record(self, stream):
        self.t = stream.clock_ms()
        stream.recorded.append(self)

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t


class _Stream:
    """A current stream whose events read the meter's clock `lag_s`
    late, as a device clock that runs elsewhere."""

    def __init__(self, clock, idle=True, lag_s=0.0):
        self.clock = clock
        self.idle = idle
        self.lag_s = lag_s
        self.device = torch.device("cuda", 0)
        self.recorded = []

    def clock_ms(self):
        return (self.clock() + self.lag_s) * 1e3

    def query(self):
        return self.idle


@pytest.fixture
def card(monkeypatch, quiet):
    """A stand-in CUDA stream and timing events on a clock the test moves:
    `card.device` is a CUDA device, `card.stream` the stream every render
    of the test gets, `card.clock` the meter's clock. Every render gets a
    device split."""
    clock = _Clock()
    stream = _Stream(clock)
    _Event.made = 0
    monkeypatch.setattr(torch, "Event", _Event)
    monkeypatch.setattr(torch.accelerator, "current_stream",
                        lambda d=None: stream)
    monkeypatch.setattr(prof, "_now", clock)
    monkeypatch.setattr(prof, "_turns", itertools.count())
    monkeypatch.setattr(prof, "SPLIT_EVERY", 1)
    return types.SimpleNamespace(device=torch.device("cuda", 0),
                                 stream=stream, clock=clock)


def _parents(rec):
    """Each step's innermost enclosing step of one less depth."""
    out = {}
    for i, (name, t0, t1, d) in enumerate(rec.steps):
        up = [s for s in rec.steps if s[3] == d - 1
              and s[1] <= t0 and t1 <= s[2]]
        out[i] = up[0][0] if len(up) == 1 else None
    return out


def test_a_cpu_render_leaves_one_record_nested_as_called(tmp_path, quiet):
    d = tmp_path / "c1"
    write_c1_project(d, 3.0, 48000, 256)
    st = load_state(d, torch.device("cpu"))
    assert prof.renders() == []
    t0 = time.perf_counter()
    st.render()
    (rec,) = prof.renders()
    assert t0 <= rec.t0 < rec.t1 <= time.perf_counter()
    assert rec.steps[-1] == ("render", rec.t0, rec.t1, 0)
    names = [s[0] for s in rec.steps]
    assert set(names) == set(prof.METERED)
    assert names.count("window") == 2 and names.count("render.device") == 1
    parents = _parents(rec)
    for i, (name, t0_, t1_, depth) in enumerate(rec.steps[:-1]):
        assert parents[i] == PARENT[name], name
        assert depth == 1 + [s[3] for s in rec.steps
                             if s[0] == PARENT[name]][0]
    # steps end in order: the device side, then the fetch, then the file
    end = {n: t1_ for n, _, t1_, _ in rec.steps}
    assert end["render.device"] <= end["fetch"] <= end["wav write"]
    assert rec.anchor is None and rec.marks == []
    assert rec.busy is None and rec.busy_ms is None and rec.idle_ms is None
    st.render()
    assert prof.renders()[-1].prev_t1 == rec.t1


def test_a_recording_render_meters_the_same_steps(tmp_path, quiet):
    """While the spans record, each metered `Span` ticks the meter too:
    the render's record holds a step for each of its metered spans."""
    d = tmp_path / "c1"
    write_c1_project(d, 3.0, 48000, 256)
    st = load_state(d, torch.device("cpu"))
    t0 = time.perf_counter()
    with prof.recording():
        st.render()
    spans = sorted(r.name for r in prof.records() if r.t0 >= t0)
    (rec,) = prof.renders()
    assert sorted(s[0] for s in rec.steps) == spans
    for r in prof.records():
        if r.t0 >= t0:
            (s,) = [s for s in rec.steps
                    if s[0] == r.name and s[1] <= r.t0 and r.t1 <= s[2]]


def test_off_nothing_lands_in_the_records(tmp_path, quiet):
    st = load_state(_c1(tmp_path), torch.device("cpu"))
    before = prof.records()
    st.render()
    after = prof.records()
    assert len(after) == len(before) and (
        not after or after[-1] is before[-1])
    assert len(prof.renders()) == 1


def _c1(tmp_path):
    d = tmp_path / "c1"
    write_c1_project(d, 3.0, 48000, 256)
    return d


def test_steps_outside_a_render_are_not_metered(quiet):
    """A playback window or a stream feed, with no render open on its
    thread: the shared no-op, and no device mark either. Another thread's
    steps stay out of this thread's render."""
    assert prof.span("window") is prof.span("wav write") is prof._OFF
    assert prof.device_mark() is prof._OFF
    got = {}

    def other():
        got["window"] = prof.span("window")

    with prof.span("render"):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        with prof.span("window"):
            pass
        assert prof.device_mark() is prof._OFF    # no split on the CPU
    assert not th.is_alive() and got["window"] is prof._OFF
    (rec,) = prof.renders()
    assert [s[0] for s in rec.steps] == ["window", "render"]


def test_the_store_keeps_the_newest_records(quiet):
    assert prof.MAX_RENDERS == 8192
    n = prof.MAX_RENDERS + 5
    for _ in range(n):
        with prof.span("render"):
            pass
    got = prof.renders()
    assert len(got) == prof.MAX_RENDERS
    assert all(a.t1 <= b.t0 for a, b in zip(got, got[1:]))
    assert all(b.prev_t1 == a.t1 for a, b in zip(got, got[1:]))


def test_idle_splitter_cuts_at_step_boundaries():
    """Host steps A > B > C nested, D after them, and a gap between
    renders: the device idles from 1.0 to 7.0 ms and from 8.0 ms to the
    end. The gap across A, B and C is cut at their boundaries and each
    piece goes to the innermost step; before the render starts it is
    `outside`."""
    ms = 1e-3
    steps = [("C", 3 * ms, 4 * ms, 3), ("B", 2 * ms, 5 * ms, 2),
             ("D", 6 * ms, 9 * ms, 2), ("A", 1.5 * ms, 9 * ms, 1),
             ("render", 0.5 * ms, 10 * ms, 0)]
    busy = [[0.0, 1 * ms], [7 * ms, 8 * ms]]
    got = prof.split_idle(steps, busy, 0.0, 10 * ms)
    # the device is busy before the render starts: nothing is outside
    assert got == pytest.approx({"render": 0.5 + 1.0, "A": 0.5 + 1.0,
                                 "B": 1.0 + 1.0, "C": 1.0, "D": 1.0 + 1.0})
    # the previous render ended at -2 ms: its gap to this one is outside
    got = prof.split_idle(steps, [[1 * ms, 10 * ms]], -2 * ms, 10 * ms)
    assert got == pytest.approx({"outside": 2.5, "render": 0.5})
    # a busy device leaves nothing to split
    assert prof.split_idle(steps, [[-1.0, 1.0]], 0.0, 10 * ms) == {}
    assert prof.merge([(3, 4), (1, 2), (1.5, 3)]) == [[1, 4]]


def test_marks_map_onto_the_host_clock_from_the_anchor(card):
    """A render on a (stand-in) card: the anchor ties the events' clock
    to perf_counter, so two marks around 2 ms of device work read as 2 ms
    of busy time each, where the host had them, the 3 ms host wait
    between them as idle under its step, and the fetch's mark as busy
    inside the fetch. Each mark's two events are let go when the record
    is read; the next render's gap from this one is `outside`."""
    clock = card.clock
    card.stream.lag_s = 5.0         # the device's clock runs elsewhere
    with prof.span("render") as top:
        t = clock()
        prof.anchor(card.device)
        with prof.span("render.device"):
            with prof.span("window"), prof.device_mark():
                clock.wait(0.002)
            with prof.span("seed caps"):
                clock.wait(0.003)
            with prof.span("window"), prof.device_mark():
                clock.wait(0.002)
        clock.wait(0.001)
        with prof.span("fetch"), prof.device_mark():
            clock.wait(0.001)
    assert top.rec.anchor is not None
    (rec,) = prof.renders()
    assert len(rec.marks) == 3 and _Event.made == 7
    busy = rec.busy
    assert rec._busy is busy and rec.marks == []
    assert busy == [pytest.approx([t + a, t + b]) for a, b in
                    ((0.0, 0.002), (0.005, 0.007), (0.008, 0.009))]
    assert rec.busy_ms == pytest.approx(5.0)
    (fetch,) = [s for s in rec.steps if s[0] == "fetch"]
    assert busy[2] == pytest.approx([fetch[1], fetch[2]])
    assert rec.idle_ms == pytest.approx({"seed caps": 3.0, "render": 1.0})
    clock.wait(0.004)
    with prof.span("render"):
        prof.anchor(card.device)
        with prof.device_mark():
            clock.wait(0.001)
        clock.wait(0.0005)
    second = prof.renders()[-1]
    assert second.prev_t1 == rec.t1
    assert second.idle_ms == pytest.approx({"outside": 4.0, "render": 0.5})


def test_a_read_does_not_wait_for_the_device(card):
    """A record whose events the device has not passed yet reads with no
    device split, and resolves at a later read."""
    with prof.span("render"):
        prof.anchor(card.device)
        with prof.device_mark():
            card.clock.wait(0.001)
    (rec,) = prof.renders()
    card.stream.recorded[-1].done = False
    assert rec.busy is None and rec.idle_ms is None and len(rec.marks) == 1
    card.stream.recorded[-1].done = True
    assert rec.busy_ms == pytest.approx(1.0) and rec.marks == []


def test_queued_work_at_the_start_leaves_no_device_split(card):
    card.stream.idle = False
    with prof.span("render"):
        prof.anchor(card.device)
        with prof.span("window"), prof.device_mark():
            pass
    (rec,) = prof.renders()
    assert rec.anchor is None and rec.busy is None
    assert [s[0] for s in rec.steps] == ["window", "render"]
    assert _Event.made == 0


def test_a_cpu_device_records_no_anchor(card):
    with prof.span("render"):
        prof.anchor(torch.device("cpu"))
        assert prof.device_mark() is prof._OFF
    assert prof.renders()[-1].anchor is None and _Event.made == 0


def test_one_render_in_split_every_gets_a_device_split(card, monkeypatch):
    """The device split samples the renders on a card: the first and
    then every SPLIT_EVERY-th, so its events cost a render 1/SPLIT_EVERY
    of a split's; every render keeps its host steps."""
    assert _split_every == 16
    monkeypatch.setattr(prof, "SPLIT_EVERY", 4)
    for _ in range(9):
        with prof.span("render"):
            prof.anchor(card.device)
            with prof.span("window"), prof.device_mark():
                card.clock.wait(0.001)
    got = prof.renders()
    assert [r.anchor is not None for r in got] == [
        i % 4 == 0 for i in range(9)]
    assert _Event.made == 3 * 3
    assert all([s[0] for s in r.steps] == ["window", "render"] for r in got)
    assert [r.busy_ms for r in got[:2]] == [pytest.approx(1.0), None]


def test_timing_prints_the_meter_line_of_a_split_render(card, monkeypatch,
                                                        capsys):
    monkeypatch.setattr(prof, "TIMING", True)
    with prof.span("render"):
        prof.anchor(card.device)
        with prof.span("wav write"):
            card.clock.wait(0.001)
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if "render meter" in ln]
    assert len(out) == 1 and "busy 0.0 ms, idle 1.0 ms" in out[0]
    assert "wav write 1.0" in out[0]
