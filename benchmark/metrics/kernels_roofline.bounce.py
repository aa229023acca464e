"""The hand-written kernels' share of their roofline over the traced
bounces: the least time of all the work the project asks of the kernel
families (harness/work.py: its recurrences and voice mixes, from the
spec) times the bounces traced, over the profiled seconds of the
families' kernels. Nothing to read where the card has no peaks in the
table, and none where a family the project needs ran no kernel under
its names: its work has moved elsewhere and the share would leave it
out (the family is named on stderr)."""

import sys

from benchmark.harness import work


def read(run):
    t = run.trace
    kind = run.device_kind
    if t is None or t.units <= 0 or kind not in work.PEAKS:
        return None
    spent: dict = {}
    for name, s in t.kernels.items():
        fam = work.family_of(name)
        if fam is not None:
            spent[fam] = spent.get(fam, 0.0) + s
    need = work.bounce_work(run.spec, run.sample_frames)
    missing = sorted(f for f in need if spent.get(f, 0.0) <= 0)
    if missing or not need:
        print(f"kernels_roofline: no kernel ran for {missing}",
              file=sys.stderr)
        return None
    least = sum(work.least_s(*w, work.PEAKS[kind]) * t.units
                for w in need.values())
    return 100.0 * least / sum(spent[f] for f in need)
