"""95th percentile milliseconds of the stream workflow's feed: each
`trim_streams` and `append_streams` pair (workflows/stream.py,
banks/flowwbank.py), from the benchmark's host timers, over the window's
packets."""

import numpy as np


def read(run):
    feeds = getattr(run, "feed_s", None)
    if not feeds:
        return None
    return float(np.percentile(feeds, 95)) * 1e3
