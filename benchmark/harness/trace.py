"""The device trace of a traced run: torch.profiler over the first units
of the measured window, reduced to what the result line and the
per-layer readers need.

* busy: the union of the device's kernel, copy and set intervals inside
  the traced window, seconds;
* window: the traced window's length, from the benchmark's own
  "traced window" range;
* kernels: seconds by kernel name;
* gaps: the device's idle seconds inside the window, each gap named by
  the innermost of the benchmark's own spans (spans.py, any thread) that
  holds its midpoint on the host ("other" where none does)."""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "traced window"


@dataclass
class Trace:
    busy_s: float
    window_s: float
    units: int
    kernels: dict = field(default_factory=dict)   # name -> seconds
    gaps: dict = field(default_factory=dict)      # host range -> seconds

    def breakdown(self, n: int = 10) -> dict:
        by: dict = defaultdict(float)
        for k, v in self.kernels.items():
            by[short_name(k)] += v
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def short_name(kernel: str, width: int = 120) -> str:
    """A kernel's name without its return type and parameter list."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    name = name.replace("(anonymous namespace)", "{anon}")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


class Tracer:
    """Profiles units [0, units) of a window: `before(i)` starts the
    profiler at unit 0, `after(i)` stops it after unit units-1. `reduce()`
    reads it once the window has closed. Off (units 0): does nothing."""

    def __init__(self, units: int, device_type: str, spans) -> None:
        self.units = units
        self.device_type = device_type
        self.spans = spans
        self.t_window = 0.0      # perf_counter at the traced range's start
        self._prof = None
        self._range = None
        self.done = 0
        self._primed = False

    def prime(self) -> None:
        """Start and stop one empty profile (the profiler's own first
        start, which sets up device tracing, takes seconds): called
        before the window of a traced run."""
        if self.units <= 0 or self._primed:
            return
        from torch.profiler import profile

        with profile(activities=self._activities()):
            pass
        self._primed = True

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def last_allowed(self, i: int) -> bool:
        """Whether unit i may be a window's last: a traced window holds
        at least `units` units."""
        return i >= self.units - 1

    def before(self, i: int) -> None:
        if self.units <= 0 or i != 0:
            return
        import torch
        from torch.autograd.profiler import record_function
        from torch.profiler import profile

        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self._prof = profile(activities=self._activities())
        self._prof.__enter__()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        self.t_window = time.perf_counter()

    def after(self, i: int) -> None:
        if self._range is None:
            return
        self.done = i + 1
        if i != self.units - 1:
            return
        import torch

        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._range = None
        self._prof.__exit__(None, None, None)

    def close(self) -> None:
        """Stop a profile the window left open: the units it holds count."""
        if self._range is not None:
            done = self.done
            self.after(self.units - 1)
            self.done = done

    def reduce(self) -> Trace | None:
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            events = json.loads(Path(path).read_text()).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        return reduce_events(events, self.spans.events, self.t_window,
                             self.done)


def _merge(iv: list) -> list:
    out: list = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events: list, spans: list, t_window: float,
                  units: int) -> Trace | None:
    """Chrome-trace events (microseconds) to a Trace; `spans` are the
    benchmark's (start, end, name) on the perf_counter clock, whose
    `t_window` is the traced range's start."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernels = [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        dev.append((s, t))
        kernels[e["name"]] += (t - s) * 1e-6
    busy = _merge(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    def us(t: float) -> float:
        return w0 + (t - t_window) * 1e6

    ranges = sorted((us(a), us(b), name) for a, b, name in spans
                    if us(b) >= w0 and us(a) <= w1)
    gaps: dict = defaultdict(float)
    active: list = []
    j = 0
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = 0.5 * (prev + s)
            while j < len(ranges) and ranges[j][0] <= mid:
                active.append(ranges[j])
                j += 1
            active = [r for r in active if r[1] >= mid]
            inner = min(active, key=lambda r: r[1] - r[0], default=None)
            gaps[inner[2] if inner else "other"] += (s - prev) * 1e-6
        prev = max(prev, e)
    return Trace(busy_s, (w1 - w0) * 1e-6, units, dict(kernels), dict(gaps))
