"""The scan family's share of its roofline over the traced bounces of a
mix session: the least time of every recurrence the session asks for
(harness/work_mix.py, from the spec) times the bounces traced, over the
profiled seconds of the family's kernels (`tile_scan`, `tile_reduce`,
`biquad_seq`). Nothing to read where the card has no peaks in the table
or no scan kernel ran."""

from benchmark.harness import work_mix


def read(run):
    t = run.trace
    kind = run.device_kind
    if t is None or t.units <= 0 or kind not in work_mix.PEAKS:
        return None
    spent = sum(s for name, s in t.kernels.items()
                if work_mix.family_of(name) == "scan")
    if spent <= 0:
        return None
    least = work_mix.least_s(*work_mix.scan_work(run.spec),
                             work_mix.PEAKS[kind]) * t.units
    return 100.0 * least / spent
