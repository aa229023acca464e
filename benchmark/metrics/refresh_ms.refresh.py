"""Median milliseconds of `State.refresh()` over the window's edits (the
Lua run, the bank diffs and the graph build), from the benchmark's host
timer around each call."""

import statistics


def read(run):
    calls = getattr(run, "refresh_s", None)
    if not calls:
        return None
    return statistics.median(calls) * 1e3
