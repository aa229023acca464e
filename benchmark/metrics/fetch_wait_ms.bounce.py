"""Milliseconds a traced bounce spends in the program's `fetch` span
(termdaw_tpu_torch/utils/prof.py), the copy of the render's ints to the
host: the wait for whatever the device still has queued when the fetch
begins, and the copy into pageable memory. Where a step before it has
already waited for the device (today the resampler's filter upload),
only the tail queued after that step is left to wait for."""

from benchmark.harness.program_spans import span_ms


def read(run):
    return span_ms(run, "fetch")
