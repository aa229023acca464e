"""Timing and profiling hooks, carried over from termdaw_tpu/utils/prof.py
so that the port imports nothing of termdaw_tpu, grown into the port's
one span recorder; the reference's jax trace becomes a torch.profiler
trace.

* `span(name)` marks a step of the program's host code. It records while
  any of these holds: a torch.profiler session is active (the span is
  then also a `record_function` range of its name, a `user_annotation`
  on the device trace above the kernels it launched), TERMDAW_TIMING=1
  (the stages, `refresh` and `render`, and their direct steps print
  their wall-clock milliseconds when they end, BLUE values, reference
  logging convention; the per-window and per-packet spans of playback
  and streaming stay quiet), or the code runs inside `recording()`. A
  record (`Span`) holds the name, `t0` and `t1` on `time.perf_counter`,
  the enclosing span of its thread (`parent`), the thread and a few
  attributes (`attr`); `records()` gives the newest MAX_RECORDS, oldest
  first, in the order they ended. While nothing records, a span is one
  flag check: no clock read, no `record_function` (about 12 us a call
  even with no profiler), no allocation.
* The port's spans: `refresh` > `refresh.lua` (the script), then
  `refresh.compile` (the window program's build); `render` >
  `render.device` (> `seed caps`; one `window` a window, attributes
  `nb` and `served`, > `window.bake` when baked live and
  `window.capture` when a new program is warmed up and captured;
  `resample`; `quantize`), then per chunk `fetch` (attribute `bytes`:
  the wait for what the device still has queued and the copy to the
  host) and `wav write` > `wav encode` (attribute `copied`: the bytes
  the encode wrote, 0 where the fetched samples are the file's
  payload), `wav file`; `stream feed` a
  packet in the stream workflow. Playback renders `window`s with no
  parent.
* TERMDAW_PROFILE=<dir> captures a torch.profiler trace (CPU and, where
  the build has them, CUDA activities) around each render and writes it
  into <dir> as a Chrome trace, `<name>-<pid>-<n>.json` (open it with
  Perfetto or chrome://tracing); the program's spans are on its device
  timeline. Both variables are read at import; without TERMDAW_PROFILE
  `device_trace` costs nothing.
* The render meter is always on, like a DAW's DSP-load meter. The steps
  of METERED are ticked whatever records: inside a `render` step of its
  thread each one appends (name, t0, t1, depth) to that render's record
  (`Render`) on `perf_counter` (bound once, `_now`), with no `Span`, no
  `record_function` and no dict; outside one (playback windows) a step
  is not metered. One render in SPLIT_EVERY on a CUDA device also gets a
  device split: `anchor(device)`, at its start, records a timing event
  on the current stream when nothing is queued there and takes its
  device time to be the `perf_counter` read just before; each
  `device_mark()` then records a timing event on that stream before and
  after one device submission of the render. A mark holds the stream
  from the one event to the other, the gaps between a replayed graph's
  kernels included, so the marks' union is at least the kernels' own
  time. The other renders, renders on the CPU and renders that start
  with work still queued keep their host steps, and their marks record
  nothing. `renders()` gives the newest MAX_RENDERS records. A record
  maps its marks onto the host clock through `elapsed_time` from its
  anchor when it is first read after the device has passed them (no
  read waits for the device), and gives `busy_ms`, the union of the
  marks, and `idle_ms`: the time from the previous render's end to its
  own in which the stream held none of the render's work, cut at its
  steps' boundaries and put down to the innermost step open at the time
  (`outside` where none is: the caller's time between renders). Under
  TERMDAW_TIMING a render with a device split prints its line.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from pathlib import Path

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from .term import DEFAULT, BLUE

TIMING = os.environ.get("TERMDAW_TIMING", "0") == "1"
PROFILE_DIR = os.environ.get("TERMDAW_PROFILE", "")
MAX_RECORDS = 1 << 16
STAGES = ("refresh", "render")  # what TERMDAW_TIMING prints, with steps
METERED = ("render", "render.device", "seed caps", "window", "window.bake",
           "resample", "quantize", "fetch", "wav write", "wav encode",
           "wav file")          # the render meter's steps, always ticked
MAX_RENDERS = 8192
SPLIT_EVERY = 16               # renders on a card a device split samples

_traces = itertools.count()
_store: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()     # .stack: the thread's open spans
_scopes = 0                    # open recording() scopes, any thread
_scopes_lock = threading.Lock()
_metered = frozenset(METERED)
_renders: collections.deque = collections.deque(maxlen=MAX_RENDERS)
_turns = itertools.count()     # renders anchored on a card
_now = time.perf_counter       # the meter's clock


class _Off:
    """The span of a step while nothing records: one shared no-op."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def attr(self, key: str, value) -> None:
        pass


_OFF = _Off()


class Span:
    """One recorded span: `name`, `t0`/`t1` (perf_counter seconds), the
    `parent` span open on the same thread when it began (None at the
    top), the `thread` ident and `attrs`."""

    __slots__ = ("name", "t0", "t1", "parent", "thread", "attrs", "_range",
                 "_tick")

    def __init__(self, name: str) -> None:
        self.name = name
        self.t0 = self.t1 = 0.0
        self.parent: Span | None = None
        self.thread = 0
        self.attrs: dict = {}
        self._range = None
        self._tick = None

    def attr(self, key: str, value) -> None:
        self.attrs[key] = value

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def __enter__(self) -> "Span":
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.thread = threading.get_ident()
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self._tick = _tick(self.name) if self.name in _metered else None
        if self._tick is not None:
            self._tick.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._tick is not None:
            self._tick.__exit__(*exc)
            self._tick = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _local.stack.pop()
        _store.append(self)
        top = self.parent or self
        if TIMING and top.parent is None and top.name in STAGES:
            print(f"{DEFAULT}timing: {self.name} = "
                  f"{BLUE}{self.ms:.1f} ms{DEFAULT}")

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.ms:.3f} ms, {self.attrs})"


def span(name: str):
    """The span of one step named `name`: a `Span` while something
    records (see the module's doc), else the meter's tick for a metered
    step inside a render, else a shared no-op. Use it as a context
    manager; `.attr(key, value)` notes an attribute."""
    if TIMING or _scopes or _profiler_enabled():
        return Span(name)
    if name in _metered:
        return _tick(name) or _OFF
    return _OFF


@contextlib.contextmanager
def recording():
    """Record every span in the process while the body runs."""
    global _scopes
    with _scopes_lock:
        _scopes += 1
    try:
        yield
    finally:
        with _scopes_lock:
            _scopes -= 1


def records() -> list[Span]:
    """The newest MAX_RECORDS recorded spans, in the order they ended."""
    return list(_store)


# ---------------------------------------------------------------- the meter
class Render:
    """The meter's record of one render: `t0`/`t1` on perf_counter,
    `prev_t1` (the previous render's end on its thread, None for its
    first), `steps` [(name, t0, t1, depth)] in the order they ended, the
    render itself last at depth 0. `busy`, `busy_ms` and `idle_ms` are
    None without a device split, or until the device has passed the
    render's marks."""

    __slots__ = ("t0", "t1", "prev_t1", "steps", "depth", "stream",
                 "anchor", "marks", "_busy", "_idle")

    def __init__(self, prev_t1: float | None) -> None:
        self.t0 = 0.0
        self.t1: float | None = None
        self.prev_t1 = prev_t1
        self.steps: list = []
        self.depth = 0
        self.stream = None
        self.anchor = None       # (perf_counter, event) of the split
        self.marks: list = []    # (event before, event after)
        self._busy: list | None = None
        self._idle: dict | None = None

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    @property
    def busy(self) -> list | None:
        """The marks' union, [[start, end]] on perf_counter seconds."""
        if self._busy is None:
            _resolve(self)
        return self._busy

    @property
    def busy_ms(self) -> float | None:
        busy = self.busy
        return None if busy is None else sum(e - s for s, e in busy) * 1e3

    @property
    def idle_ms(self) -> dict | None:
        """The ms from `prev_t1` (else `t0`) to `t1` in which the stream
        held none of the render's work, by the innermost step open on
        the host, `outside` between renders."""
        if self._idle is None:
            busy = self.busy
            if busy is None:
                return None
            lo = self.t0 if self.prev_t1 is None else self.prev_t1
            self._idle = split_idle(self.steps, busy, lo, self.t1)
        return self._idle

    def __repr__(self) -> str:
        return (f"Render({self.ms:.3f} ms, {len(self.steps)} steps, "
                f"busy {self.busy_ms} ms)")


class _Tick:
    """A metered step of the open render: its (name, t0, t1, depth)."""

    __slots__ = ("name", "rec", "t0", "depth")

    def __init__(self, name: str, rec: Render) -> None:
        self.name = name
        self.rec = rec

    def __enter__(self) -> "_Tick":
        rec = self.rec
        self.depth = rec.depth
        rec.depth += 1
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        t1 = _now()
        rec = self.rec
        rec.depth -= 1
        rec.steps.append((self.name, self.t0, t1, self.depth))

    def attr(self, key: str, value) -> None:
        pass


class _Open:
    """The metered `render` step: opens its thread's render record, then
    closes and stores it."""

    __slots__ = ("rec", "outer")

    def __enter__(self) -> "_Open":
        loc = _local.__dict__
        self.outer = loc.get("render")
        rec = self.rec = Render(loc.get("last_t1"))
        rec.depth = 1
        loc["render"] = rec
        rec.t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.t1 = t1 = _now()
        rec.steps.append(("render", rec.t0, t1, 0))
        loc = _local.__dict__
        loc["render"] = self.outer
        loc["last_t1"] = t1
        _renders.append(rec)
        if TIMING and rec.anchor is not None:
            line = _line(rec)
            if line:
                print(line)

    def attr(self, key: str, value) -> None:
        pass


def _tick(name: str):
    """The meter's tick of metered step `name`, None outside a render."""
    if name == "render":
        return _Open()
    rec = _local.__dict__.get("render")
    return None if rec is None else _Tick(name, rec)


def _event(stream):
    """A timing event recorded on `stream`."""
    ev = torch.Event(stream.device, enable_timing=True)
    ev.record(stream)
    return ev


class _Mark:
    """A device submission of the open render: a timing event on the
    render's stream before it and one after it."""

    __slots__ = ("rec", "start")

    def __init__(self, rec: Render) -> None:
        self.rec = rec

    def __enter__(self) -> "_Mark":
        self.start = _event(self.rec.stream)
        return self

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.marks.append((self.start, _event(rec.stream)))


def anchor(device) -> None:
    """Give the open render of this thread a device split, one render in
    SPLIT_EVERY on a CUDA device: called at its start. Where the current
    stream has nothing queued, records the anchor event; the
    `perf_counter` read just before stands for its device time.
    Otherwise (the CPU, the other renders, work still queued) the render
    keeps its host steps and its marks record nothing."""
    rec = _local.__dict__.get("render")
    if rec is None or device.type != "cuda" or next(_turns) % SPLIT_EVERY:
        return
    stream = torch.accelerator.current_stream(device)
    if not stream.query():
        return
    ev = torch.Event(stream.device, enable_timing=True)
    t = _now()
    ev.record(stream)
    rec.stream, rec.anchor = stream, (t, ev)


def device_mark():
    """A context manager around one device submission of the open
    render: a timing event on the render's stream before it and one
    after it. The stream is held from the one to the other; a submission
    queued behind another overlaps it, and the union counts that time
    once. The shared no-op where the render has no device split or none
    is open."""
    rec = _local.__dict__.get("render")
    if rec is None or rec.anchor is None:
        return _OFF
    return _Mark(rec)


def renders() -> list[Render]:
    """The meter's newest MAX_RENDERS render records, in the order they
    ended."""
    return list(_renders)


def _resolve(rec: Render) -> None:
    """Map a closed render's marks onto perf_counter, once the device has
    passed all of them, and let their events go."""
    if rec.anchor is None or rec.t1 is None or rec._busy is not None:
        return
    t_a, ev_a = rec.anchor
    marks = rec.marks
    if not (marks[-1][1] if marks else ev_a).query():
        return                   # one stream: the last is the latest
    rec._busy = merge([(t_a + ev_a.elapsed_time(a) * 1e-3,
                        t_a + ev_a.elapsed_time(b) * 1e-3)
                       for a, b in marks])
    rec.marks = []


def merge(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def split_idle(steps, busy, lo: float, hi: float) -> dict:
    """The idle time in [lo, hi] outside the merged `busy` intervals, in
    ms by step: each idle interval is cut at the steps' boundaries, and
    each piece goes to the innermost step (name, t0, t1, depth) open
    over it, to `outside` where none is. The steps of one thread nest,
    so the open ones form a stack."""
    idle = []
    t = lo
    for s, e in busy:
        if s > t:
            idle.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        idle.append((t, hi))
    out: dict = collections.defaultdict(float)
    if not idle:
        return {}
    pts = sorted({lo, hi, *(p for _, a, b, _ in steps for p in (a, b)
                            if lo < p < hi)})
    order = sorted(steps, key=lambda st: (st[1], st[3]))
    stack: list = []
    k = i = 0
    for x, y in zip(pts, pts[1:]):
        while i < len(idle) and idle[i][1] <= x:
            i += 1
        if i == len(idle):
            break
        mid = 0.5 * (x + y)
        while stack and stack[-1][2] <= mid:
            stack.pop()
        while k < len(order) and order[k][1] <= mid:
            if order[k][2] > mid:
                stack.append(order[k])
            k += 1
        m, gap = i, 0.0
        while m < len(idle) and idle[m][0] < y:
            gap += min(y, idle[m][1]) - max(x, idle[m][0])
            m += 1
        if gap > 0:
            out[stack[-1][0] if stack else "outside"] += gap * 1e3
    return dict(out)


def _line(rec: Render) -> str | None:
    """TERMDAW_TIMING's line of a render with a device split."""
    busy, idle = rec.busy_ms, rec.idle_ms
    if busy is None:
        return None
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:4]
    by = ", ".join(f"{k} {v:.1f}" for k, v in top)
    return (f"{DEFAULT}timing: render meter = {BLUE}busy {busy:.1f} ms, "
            f"idle {sum(idle.values()):.1f} ms{DEFAULT} ({by})")


@contextlib.contextmanager
def device_trace(name: str):
    """A torch.profiler trace of the body written into PROFILE_DIR as
    `<name>-<pid>-<n>.json` when TERMDAW_PROFILE is set; otherwise
    nothing."""
    if not PROFILE_DIR:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(PROFILE_DIR)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        str(out / f"{name}-{os.getpid()}-{next(_traces)}.json"))
