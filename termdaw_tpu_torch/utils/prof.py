"""Carried over from termdaw_tpu/utils/prof.py, so that the port imports
nothing of termdaw_tpu; only `span` is kept (the port has no caller for the
jax trace `device_trace`).

Timing hooks: TERMDAW_TIMING=1 prints wall-clock timings of refresh/
compile/render/scan stages (BLUE values, reference logging convention).
"""

from __future__ import annotations

import contextlib
import os
import time

from .term import DEFAULT, BLUE

TIMING = os.environ.get("TERMDAW_TIMING", "0") == "1"


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
