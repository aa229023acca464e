"""Bounce loop of a sampled-instrument session: loops/bounce_ref.py's
set-up, window, release and check (reused, unchanged), and around the
window the rise of the program's `group_slots` and `group_voices`
counters (the slots of the windows' fused SampleMulti group tables and
the voices that filled them; None where the program has no such
counters), kept as `run.group_fill`. After the window it keeps the least
work of the session's voice mixes (harness/work_keys.py, from the spec
and the project's files) as `run.voicemix_work`, and prints to stderr
the window's counters, the slots each group's table was pinned at and
the bytes of the groups' shared sample pools."""

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
    if not hasattr(cg, "group_slots"):
        return None
    return int(cg.group_slots), int(cg.group_voices)


def window(run, seconds: float) -> None:
    from benchmark.harness import work_keys

    f0 = _fill(run)
    _ref.window(run, seconds)
    f1 = _fill(run)
    run.group_fill = (None if f0 is None
                      else (f1[0] - f0[0], f1[1] - f0[1]))
    run.voicemix_work = work_keys.voicemix_work(
        run.spec, run.workdir / "project", run.sample_frames)
    cg = run.state.compiled
    slots = sorted({int(c["pf"]) for c in cg.bake_caps.values()
                    if "pf" in c})
    print(f"bounce_keys: window counters {run.counters}, group tables' "
          f"slots {slots}, fill {run.group_fill}, group pool bytes "
          f"{getattr(cg, 'group_pool_bytes', None)}", file=sys.stderr)
