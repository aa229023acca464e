"""Milliseconds a bounce spends in the WAV writer's `write_ints` (the
integer widening, packing and the file write), from the benchmark's
host timer around each call, over every bounce of the window."""


def read(run):
    calls = getattr(run, "wav_write_s", None)
    if not calls or run.attempted <= 0:
        return None
    return sum(calls) / run.attempted * 1e3
