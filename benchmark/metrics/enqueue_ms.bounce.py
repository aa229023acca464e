"""Milliseconds a traced bounce spends in the program's `window` spans
(termdaw_tpu_torch/utils/prof.py), one a window: the host's time to
serve or bake each window's inputs, copy them into its program and
launch the replay. None of it waits for the device; the resample's
wait and the fetch are read elsewhere (PERF.md, Layers)."""

from benchmark.harness.program_spans import span_ms


def read(run):
    return span_ms(run, "window")
