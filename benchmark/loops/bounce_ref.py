"""Bounce loop held to the configuration's own plain reference: the same
set-up, window and release as loops/bounce.py (reused, unchanged), and a
check of the window's last WAV against `benchmark/reference/<name>.py`,
the module the configuration names under "reference" (its
`bounce(spec, d, renders, device)` gives that render at the WAV's scale).
The check reads `frames_off`, `bounces_off` and `max_err_fs` as
reference/compare.py does.

Before the release it keeps `graph_nodes`: the device nodes the window
programs replayed a bounce over the window, from the program's
`replayed_nodes` counter (None where the program has no such counter)."""

from __future__ import annotations

import importlib

from benchmark.harness.cell import loop_module

_bounce = loop_module("bounce")
TRACED_UNITS = _bounce.TRACED_UNITS
setup = _bounce.setup
release = _bounce.release


def _replayed_nodes(run):
    return getattr(run.state.compiled, "replayed_nodes", None)


def window(run, seconds: float) -> None:
    n0 = _replayed_nodes(run)
    _bounce.window(run, seconds)
    n1 = _replayed_nodes(run)
    run.graph_nodes = (None if n0 is None or run.attempted <= 0
                       else (n1 - n0) / run.attempted)


def check(run) -> dict:
    from benchmark.harness.cell import limits
    from benchmark.reference import compare, files

    ref = importlib.import_module(
        f"benchmark.reference.{run.cell.config['reference']}")
    spec = run.spec
    ints, rate, bits = files.read_wav_ints(run.final_wav)
    want = ref.bounce(spec, run.workdir / "project", run.renders, run.device)
    frames = ref.song_frames(spec)
    assert len(want) == frames
    vals = compare.wav_vs(ints, want, int(spec["bd"]))
    if rate != int(spec["render_sr"]) or bits != int(spec["bd"]):
        vals["frames_off"] = float("inf")
    vals["bounces_off"] = sum(w != frames for w in run.window_written)
    return compare.checked(vals, limits(run.cell.name))
