"""The device's idle share of the live window's first TRACED_S seconds:
100 minus the busy union over the traced stretch."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
