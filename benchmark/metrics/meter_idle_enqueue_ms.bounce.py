"""The ms a bounce in which the card's stream held none of the bounce's
work while the host was in `render.device` (its `seed caps`, `window`,
`window.bake`, `resample` and `quantize` included), over the bounces
after the traced window, from the program's render meter: the
unprofiled counterpart of the "render windows" idle gaps."""

from benchmark.harness.meter import ENQUEUE, idle_ms


def read(run):
    return idle_ms(run, ENQUEUE)
