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
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from pathlib import Path

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from .term import DEFAULT, BLUE

TIMING = os.environ.get("TERMDAW_TIMING", "0") == "1"
PROFILE_DIR = os.environ.get("TERMDAW_PROFILE", "")
MAX_RECORDS = 1 << 16
STAGES = ("refresh", "render")  # what TERMDAW_TIMING prints, with steps

_traces = itertools.count()
_store: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()     # .stack: the thread's open spans
_scopes = 0                    # open recording() scopes, any thread
_scopes_lock = threading.Lock()


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

    __slots__ = ("name", "t0", "t1", "parent", "thread", "attrs", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self.t0 = self.t1 = 0.0
        self.parent: Span | None = None
        self.thread = 0
        self.attrs: dict = {}
        self._range = None

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
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
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
    records (see the module's doc), else a shared no-op. Use it as a
    context manager; `.attr(key, value)` notes an attribute."""
    if TIMING or _scopes or _profiler_enabled():
        return Span(name)
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
