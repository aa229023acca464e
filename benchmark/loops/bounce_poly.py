"""Bounce loop of an instrument session: loops/bounce_ref.py's set-up,
window, release and check (reused, unchanged), and around the window the
rise of the program's `note_slots` and `note_voices` counters (the slots
of the windows' polyphonic instance tables and the voices that filled
them; None where the program has no such counters), kept as
`run.note_fill`. After the window it keeps the least work of the
session's SampSyn voices (harness/work_poly.py, from the spec and the
project's files) as `run.sampsyn_work`, and prints to stderr the
window's counters and the slots each note arm's table was pinned at."""

from __future__ import annotations

import sys

from benchmark.harness.cell import loop_module

_ref = loop_module("bounce_ref")
TRACED_UNITS = _ref.TRACED_UNITS
setup = _ref.setup
release = _ref.release
check = _ref.check


def _fill(run):
    cg = run.state.compiled
    if not hasattr(cg, "note_slots"):
        return None
    return int(cg.note_slots), int(cg.note_voices)


def window(run, seconds: float) -> None:
    from benchmark.harness import work_poly

    f0 = _fill(run)
    _ref.window(run, seconds)
    f1 = _fill(run)
    run.note_fill = (None if f0 is None
                     else (f1[0] - f0[0], f1[1] - f0[1]))
    run.sampsyn_work = work_poly.sampsyn_work(run.spec,
                                              run.workdir / "project")
    cg = run.state.compiled
    slots = sorted({int(c["p"]) for c in cg.bake_caps.values() if "p" in c})
    print(f"bounce_poly: window counters {run.counters}, note tables' "
          f"slots {slots}, fill {run.note_fill}", file=sys.stderr)
