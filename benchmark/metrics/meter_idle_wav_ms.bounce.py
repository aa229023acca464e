"""The ms a bounce in which the card's stream held none of the bounce's
work while the host was in `wav write` (its `wav encode` and `wav file`
included), over the bounces after the traced window, from the program's
render meter: the unprofiled counterpart of the "WAV write" idle
gaps."""

from benchmark.harness.meter import WAV, idle_ms


def read(run):
    return idle_ms(run, WAV)
