"""Milliseconds a traced bounce spends in the program's `wav encode`
span (termdaw_tpu_torch/utils/prof.py): the WAV writer's widening,
clipping and packing of the samples, without the file write."""

from benchmark.harness.program_spans import span_ms


def read(run):
    return span_ms(run, "wav encode")
