"""The share of the bounces after the traced window in which the card's
stream held none of the bounce's work, from the program's render meter:
100 x the split renders' idle time over their intervals, each from the
previous render's end. Not the device's idle: a mark holds the stream
through the gaps between a replayed graph's kernels, which the
profiler's `device_idle_pct.bounce` counts as idle."""

from benchmark.harness.meter import idle_pct


def read(run):
    return idle_pct(run)
