"""Device busy milliseconds a bounce: the union of the device's kernel,
copy and set intervals over the traced bounces, per bounce."""


def read(run):
    t = run.trace
    if t is None or t.units <= 0 or t.busy_s <= 0:
        return None
    return t.busy_s / t.units * 1e3
