"""The share of the window's rendered windows whose events were baked
live rather than served from a stored chain: live_bakes over live_bakes
plus served_windows (graph/compile.py counters), in %."""


def read(run):
    c = getattr(run, "window_counters", None)
    if not c:
        return None
    n = c["live_bakes"] + c["served_windows"]
    return None if n <= 0 else 100.0 * c["live_bakes"] / n
