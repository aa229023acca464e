"""The program's own spans (termdaw_tpu_torch/utils/prof.py) over a
traced window: what the per-layer metrics that read a program span
share."""


def span_ms(run, name: str):
    """Milliseconds a traced unit spends in the program's spans named
    `name`: the durations of its records that lie inside the traced
    window, summed, over the traced units. None without a trace, where
    no such span lies in the window, or where the program records no
    spans."""
    t = run.trace
    if t is None or t.units <= 0:
        return None
    from termdaw_tpu_torch.utils import prof

    records = getattr(prof, "records", None)
    if records is None:
        return None
    w0 = run.tracer.t_window
    w1 = w0 + t.window_s
    got = [r.t1 - r.t0 for r in records()
           if r.name == name and w0 <= r.t0 and r.t1 <= w1]
    if not got:
        return None
    return sum(got) / t.units * 1e3
