"""Timing and profiling hooks, carried over from termdaw_tpu/utils/prof.py
so that the port imports nothing of termdaw_tpu; the reference's jax
trace becomes a torch.profiler trace.

* TERMDAW_TIMING=1 prints wall-clock timings of refresh/compile/render/
  scan stages (BLUE values, reference logging convention).
* TERMDAW_PROFILE=<dir> captures a torch.profiler trace (CPU and, where
  the build has them, CUDA activities) around each render and writes it
  into <dir> as a Chrome trace, `<name>-<pid>-<n>.json` (open it with
  Perfetto or chrome://tracing). Both variables are read at import;
  without TERMDAW_PROFILE `device_trace` costs nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from pathlib import Path

from .term import DEFAULT, BLUE

TIMING = os.environ.get("TERMDAW_TIMING", "0") == "1"
PROFILE_DIR = os.environ.get("TERMDAW_PROFILE", "")

_traces = itertools.count()


@contextlib.contextmanager
def span(name: str):
    """Timed span; prints when TERMDAW_TIMING=1."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if TIMING:
            dt = (time.perf_counter() - t0) * 1000.0
            print(f"{DEFAULT}timing: {name} = {BLUE}{dt:.1f} ms{DEFAULT}")


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
