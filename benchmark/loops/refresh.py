"""Edit loop: a composer iterating on the project, a closed loop.

Each cycle writes one seeded edit of project.lua (an effect parameter, a
vertex's gain or pan, an envelope value, or adding or removing one extra
vertex and its connection; each four edits hold one of each kind, in a
seeded order; sample and MIDI files stay as they are), then
`State.refresh()` and `Player.play()`, then `Player.stop()`.
`edit_to_audio_p90_ms` is the 90th percentile, over every edit of the
window, of the time from the written file to the moment the sink holds
the traffic's `prebuffer_blocks` (termdaw's prebuffer, frozen here);
the check counts the edits whose `play()` queued fewer
(`prebuffer_short`).

Set-up loads the project and runs one cycle of each edit kind. The check
takes the window's last edit: its prebuffer, and what the same Player's
`tick()` queues once the window has closed, up to the traffic's
`check_blocks` more, against the reference's render of the edited
project from a fresh state."""

from __future__ import annotations

import copy
import statistics
import time

import numpy as np

TRACED_UNITS = 3
# the check waits at most this long for the Player's ticks
CHECK_TIMEOUT_S = 60.0
MIX_VERTICES = ("kick", "snare", "hat", "bass", "chords")
EXTRA = {"name": "extra", "kind": "sample_multi", "gain": 0.5,
         "angle": 30.0, "sample": "hat", "floww": "snare", "note": -1}


def edit(spec: dict, kind: int, rng: np.random.Generator) -> dict:
    """The spec after one edit of the given kind."""
    s = copy.deepcopy(spec)
    verts = {v["name"]: v for v in s["vertices"]}
    if kind == 0:
        s["plugins"]["del"]["params"]["feedback"] = round(
            float(rng.uniform(0.2, 0.5)), 3)
    elif kind == 1:
        v = verts[MIX_VERTICES[int(rng.integers(len(MIX_VERTICES)))]]
        if rng.random() < 0.5:
            v["gain"] = round(float(rng.uniform(0.3, 1.2)), 3)
        else:
            v["angle"] = round(float(rng.uniform(-60.0, 60.0)), 2)
    elif kind == 2:
        conf = list(verts["duck"]["conf"])
        conf[2] = round(float(rng.uniform(0.2, 0.6)), 3)
        verts["duck"]["conf"] = conf
    else:
        if "extra" in verts:
            s["vertices"] = [v for v in s["vertices"] if v["name"] != "extra"]
            s["edges"] = [e for e in s["edges"] if e[0] != "extra"]
        else:
            s["vertices"].insert(-1, dict(EXTRA))
            s["edges"].append(["extra", "sum"])
    return s


def setup(run) -> None:
    from benchmark.harness.cell import project_module
    from benchmark.harness.program import RecordingSink, load
    from termdaw_tpu_torch.engine.player import Player
    from termdaw_tpu_torch.engine.state import State
    from termdaw_tpu_torch.graph.compile import CompiledGraph

    d = run.workdir / "project"
    run.spec = project_module(run.cell.config["project"]).build(
        run.cell.config, run.seed, d)
    run.project_dir = d
    run.state = st = load(run, d)
    run.spans.wrap(CompiledGraph, "seed_caps", "seed caps")
    run.spans.wrap(CompiledGraph, "render_window", "render windows")
    run.spans.wrap(State, "refresh", "refresh")
    run.sink = RecordingSink(run.spans)
    sr = st.config.settings.project_samplerate
    bl = st.config.settings.buffer_length
    run.player = Player(st, run.sink, sr, bl)
    run.prebuffer_frames = int(run.cell.traffic["prebuffer_blocks"]) * bl
    run.prebuffer_short = 0
    run.rng = np.random.default_rng([run.seed, 1])
    run.kinds = []
    for kind in range(4):            # warm-up: one cycle of each kind
        cycle(run, kind)


def cycle(run, kind: int | None = None):
    """Stop, one edit, refresh and play to the first queued audio; returns
    (seconds, captures of the refreshed graph)."""
    from benchmark.projects.lua import write_project

    run.player.stop()
    if kind is None:
        # every four edits hold one of each kind, in a seeded order, so
        # that every seed asks for the same work
        if not run.kinds:
            run.kinds = [int(k) for k in run.rng.permutation(4)]
        kind = run.kinds.pop()
    run.spec = edit(run.spec, kind, run.rng)
    write_project(run.spec, run.project_dir)
    st, pl = run.state, run.player
    run.sink.reset()
    t0 = time.perf_counter()
    st.refresh()
    if not st.loaded:
        raise RuntimeError(f"edit kind {kind} did not load")
    with run.spans.span("play"):
        pl.play()
    t = run.sink.time_at(run.prebuffer_frames)
    if t is None:
        run.prebuffer_short += 1
        t = time.perf_counter()
    return t - t0, st.compiled.captures


def window(run, seconds: float) -> None:
    lat: list[float] = []
    caps = 0
    run.prebuffer_short = 0
    mark = run.spans.mark()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        est = statistics.median(lat[-5:]) if lat else 0.0
        last = (time.perf_counter() + est >= deadline
                and run.tracer.last_allowed(i))
        run.tracer.before(i)
        dt, c = cycle(run)
        run.tracer.after(i)
        lat.append(dt)
        caps += c
        i += 1
        if last:
            break
    run.window_s = time.perf_counter() - t0
    run.attempted, run.failed = i, 0
    run.latencies = lat
    run.e2e["edit_to_audio_p90_ms"] = float(np.percentile(lat, 90)) * 1e3
    run.captures_in_window = caps
    run.refresh_s = run.spans.since(mark, "refresh")
    # the check: the last edit's Player plays on past its prebuffer
    pl, sink = run.player, run.sink
    bl = run.state.config.settings.buffer_length
    run.check_frames = run.prebuffer_frames + int(
        run.cell.traffic["check_blocks"]) * bl
    # pausing ends a tick's catch-up drain once the frames are in (a
    # device slower than real time, as the CPU, never catches up)
    sink.until = (run.check_frames, pl.pause)
    give_up = time.perf_counter() + CHECK_TIMEOUT_S
    while pl.playing and time.perf_counter() < give_up:
        if not pl.tick():
            time.sleep(0.002)
    run.heard = sink.audio()
    pl.stop()


def release(run) -> None:
    run.player = None
    run.state = None


def check(run) -> dict:
    from benchmark.harness.cell import limits
    from benchmark.reference import compare

    vals = compare.played(run.spec, run.project_dir, run.heard,
                          run.check_frames, run.prebuffer_frames)
    vals["prebuffer_short"] = run.prebuffer_short
    return compare.checked(vals, limits(run.cell.name))
