"""The program's render meter (termdaw_tpu_torch/utils/prof.py
`renders()`) over the bounces of a `--trace 1` run that follow its
traced window: the bounces the profiler did not slow, as the untraced
runs bounce. What the `meter_*` readers share. A render's interval runs
from the previous render's end (`prev_t1`, else its own start) to its
end; only renders whose interval begins after the window closed count,
so the profiler's own teardown falls in none."""

# the steps under `render.device`, and `wav write` with its children
ENQUEUE = ("render.device", "seed caps", "window", "window.bake",
           "resample", "quantize")
WAV = ("wav write", "wav encode", "wav file")


def _lo(r) -> float:
    return r.t0 if r.prev_t1 is None else r.prev_t1


def renders(run, split: bool = False) -> list | None:
    """The program's render records whose interval begins after the
    traced window closed (`split`: only those with a device split, one
    render in the program's SPLIT_EVERY); None without a trace, where
    the program keeps no such records, or where none lies there."""
    t = run.trace
    if t is None:
        return None
    from termdaw_tpu_torch.utils import prof

    read = getattr(prof, "renders", None)
    if read is None:
        return None
    end = run.tracer.t_window + t.window_s
    got = [r for r in read() if _lo(r) >= end
           and (not split or r.busy is not None)]
    return got or None


def idle_pct(run) -> float | None:
    """100 x the split renders' idle time, when the stream held none of
    their work, over their intervals."""
    rs = renders(run, split=True)
    if rs is None:
        return None
    span = sum(r.t1 - _lo(r) for r in rs) * 1e3
    return 100.0 * sum(sum(r.idle_ms.values()) for r in rs) / span


def idle_ms(run, steps: tuple) -> float | None:
    """The idle ms a split render under `steps`."""
    rs = renders(run, split=True)
    if rs is None:
        return None
    return sum(v for r in rs for k, v in r.idle_ms.items()
               if k in steps) / len(rs)


def host_ms(run, name: str) -> float | None:
    """The host's ms a render in steps named `name`."""
    rs = renders(run)
    if rs is None:
        return None
    return sum(t1 - t0 for r in rs for n, t0, t1, _ in r.steps
               if n == name) / len(rs) * 1e3
