"""The host's ms a bounce in the program's `window` steps, over the
bounces after the traced window, from the program's render meter: the
unprofiled counterpart of `enqueue_ms.bounce`."""

from benchmark.harness.meter import host_ms


def read(run):
    return host_ms(run, "window")
