"""The SampSyn kernel's share of its roofline over the traced bounces of
an instrument session: the least time of the session's SampSyn voices
(harness/work_poly.py, from the spec, kept by loops/bounce_poly.py) times
the bounces traced, over the profiled seconds of the kernels whose name
holds `sampsyn`. Nothing to read where the card has no peaks in the table
or no such kernel ran."""

from benchmark.harness import work_poly


def read(run):
    t = run.trace
    work = getattr(run, "sampsyn_work", None)
    if (t is None or t.units <= 0 or work is None
            or run.device_kind not in work_poly.PEAKS):
        return None
    spent = sum(s for name, s in t.kernels.items() if "sampsyn" in name)
    if spent <= 0:
        return None
    least = work_poly.least_s(*work, work_poly.PEAKS[run.device_kind])
    return 100.0 * least * t.units / spent
