"""Live loop: a composer's generator streaming hits into the stream
workflow at a fixed rate, an open loop.

`run_stream_workflow` (the program's stream workflow: a reader thread on
an OS pipe, trim, append and cursor resync on each packet, the Player
paced to the wall clock with a 4-block lead) plays into a sink that
drains in real time. A generator thread writes packet i to the pipe at
its due time i / rate, whatever the engine is doing: one hit for stream
i mod n, at the song time it is due plus `lead_s`, its velocity from a
copy of the program's `stream_gen` 16th-note patterns (the stream's
pattern, step (i div n) mod 16). The session runs `warmup_s` before the
window (set-up) and ends TAIL_S after it.

* `stream_feed_p95_ms`: over every packet due in the window, the time
  from its due time to the end of its `append_streams` (its notes can
  sound once the cursor is resynced, which follows at once);
* `attempted`: blocks due to play in the window; `failed`: those that
  reached the sink after their play time (underruns).

The check compares all the audio the sink received with the reference's
render of every hit that was appended before the engine's cursor passed
its frame (a hit appended later can no longer sound: it is late, not
wrong)."""

from __future__ import annotations

import os
import threading
import time

import numpy as np

TRACED_UNITS = 1      # the traced stretch: the window's first TRACED_S
TRACED_S = 3.0
TAIL_S = 0.5          # packets sent past the window
IDLE_S = 0.5          # the session ends this long after the last packet

# a copy of the program's tools/stream_gen.py PATTERNS: notes, 16ths a bar
PATTERNS = {
    "kick": ([36], "x...x...x...x..."),
    "snare": ([38], "....x.......x..."),
    "hat": ([42], "x.x.x.x.x.x.x.x."),
    "hihat": ([42], "x.x.x.x.x.x.x.x."),
    "ride": ([51], "x...x...x...x..."),
    "bass": ([33, 36, 31, 38], "x.......x......."),
    "chords": ([60, 64, 67], "x..............."),
}


def packets(n_streams: int, rate: float, count: int, lead_s: float,
            seed: int) -> list:
    """[(due_s, stream, [1, 4] float32 row (seq, t_s, note, vel))]."""
    rng = np.random.default_rng([seed, 2])
    names = list(PATTERNS)
    out = []
    for i in range(count):
        s = i % n_streams
        notes, pat = PATTERNS[names[s % len(names)]]
        step = (i // n_streams) % 16
        vel = (rng.uniform(0.6, 1.0) if pat[step] == "x"
               else rng.uniform(0.2, 0.4))
        due = i / rate
        row = np.array([[i, due + lead_s, notes[step % len(notes)], vel]],
                       np.float32)
        out.append((due, f"s{s}", row))
    return out


def setup(run) -> None:
    from benchmark.harness.cell import project_module
    from benchmark.harness.program import RecordingSink, load
    from benchmark.projects import _files
    from termdaw_tpu_torch import native
    from termdaw_tpu_torch.banks.flowwbank import FlowwBank
    from termdaw_tpu_torch.engine.player import Player
    from termdaw_tpu_torch.graph.compile import CompiledGraph

    tr = run.cell.traffic
    cfg = dict(run.cell.config)
    d = run.workdir / "project"
    run.spec = spec = project_module(cfg["project"]).build(cfg, run.seed, d)
    spec["packets"] = b""          # the streams fill live
    spec["stream_events"] = {}
    run.project_dir = d
    run.state = st = load(run, d)
    native.get_lib()
    rate = float(tr["packet_rate_hz"])
    total = float(tr["warmup_s"]) + run.seconds + TAIL_S
    run.packets = packets(int(cfg["tracks"]), rate, int(total * rate) + 1,
                          float(tr["lead_s"]), run.seed)
    run.blobs = [_files.encode_events(name, row)
                 for _, name, row in run.packets]
    run.appended: dict = {}        # seq -> (time, graph frame)
    run.feed_pairs: list = []

    orig_append = FlowwBank.append_streams
    orig_trim = FlowwBank.trim_streams

    def trim(fb):
        t0 = time.perf_counter()
        with run.spans.span("feed"):
            orig_trim(fb)
        run._trim_s = time.perf_counter() - t0

    def append(fb, pkts):
        t0 = time.perf_counter()
        with run.spans.span("feed"):
            out = orig_append(fb, pkts)
        t1 = time.perf_counter()
        cur = run.state.compiled.get_time()
        for p in pkts:
            if p.events is not None and len(p.events):
                run.appended[int(p.events[0, 0])] = (t1, cur)
        run.feed_pairs.append(t1 - t0 + getattr(run, "_trim_s", 0.0))
        return out

    run.spans.patch(FlowwBank, "trim_streams", trim)
    run.spans.patch(FlowwBank, "append_streams", append)
    run.spans.wrap(CompiledGraph, "seed_caps", "seed caps")
    run.spans.wrap(CompiledGraph, "render_window", "render windows")

    # every window size the Player renders, once, before the session
    cg = st.compiled
    for nb in Player._WINDOWS:
        cg.render_window(st.fb, nb)
        cg.set_time(0)
        st.fb.set_time(0)
    run.tracer.prime()
    run.sink = RecordingSink(run.spans)
    run.pipe = os.pipe()
    run.session = threading.Thread(target=_session, args=(run,),
                                   daemon=True)
    run.t0 = time.perf_counter()
    run.gen = threading.Thread(target=_generate, args=(run,), daemon=True)
    run.gen.start()
    run.session.start()
    time.sleep(max(0.0, run.t0 + float(tr["warmup_s"]) - time.perf_counter()))


def _generate(run) -> None:
    r, w = run.pipe
    late = []
    try:
        for (due, _, _), blob in zip(run.packets, run.blobs):
            wait = run.t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - run.t0 - due)
            os.write(w, blob)
    finally:
        os.close(w)
        run.gen_late = late


def _session(run) -> None:
    from termdaw_tpu_torch.workflows.stream import run_stream_workflow

    st = run.state
    r, _ = run.pipe
    try:
        with os.fdopen(r, "rb", buffering=0) as f:
            run_stream_workflow(st.config.settings.project_samplerate,
                                st.config.settings.buffer_length, st,
                                run.sink, input_stream=f,
                                max_idle_s=IDLE_S)
    except BaseException as e:  # read by window()
        run.session_error = e


def window(run, seconds: float) -> None:
    from benchmark.harness.program import counters

    cg = run.state.compiled
    c0 = counters(cg)
    w0 = run.t0 + float(run.cell.traffic["warmup_s"])
    w1 = w0 + seconds
    mark = len(run.feed_pairs)
    # the traced stretch: the window's first TRACED_S seconds
    run.tracer.before(0)
    time.sleep(max(0.0, min(w0 + TRACED_S, w1) - time.perf_counter()))
    run.tracer.after(0)
    time.sleep(max(0.0, w1 - time.perf_counter()))
    c1 = counters(cg)
    feeds_end = len(run.feed_pairs)
    run.gen.join(timeout=TAIL_S + 60.0)
    run.session.join(timeout=IDLE_S + 60.0)
    if run.session.is_alive() or getattr(run, "session_error", None):
        raise RuntimeError(f"the stream session did not end cleanly: "
                           f"{getattr(run, 'session_error', 'still running')}")
    # packets due in the window, each from its due time to its append
    lat = []
    for i, (due, _, _) in enumerate(run.packets):
        t_due = run.t0 + due
        if not w0 <= t_due < w1:
            continue
        t_app = run.appended.get(i, (float("inf"), 0))[0]
        lat.append(t_app - t_due)
    run.e2e["stream_feed_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    run.latencies = lat
    # blocks due to play in the window, and those that came late
    sink = run.sink
    bl = run.state.config.settings.buffer_length
    sr = run.state.config.settings.project_samplerate
    arr_t = np.array([a[0] for a in sink.arrivals])
    arr_f = np.array([a[1] for a in sink.arrivals])
    first_block = int(np.ceil((w0 - sink.t_resume) * sr / bl))
    last_block = int(np.floor((w1 - sink.t_resume) * sr / bl))
    attempted = failed = 0
    for k in range(max(first_block, 0), last_block):
        due = sink.t_resume + k * bl / sr
        j = np.searchsorted(arr_f, (k + 1) * bl)     # the chunk holding k
        attempted += 1
        if j >= len(arr_t) or arr_t[j] > due:
            failed += 1
    run.attempted, run.failed = attempted, failed
    run.due_frames = max(last_block, 0) * bl   # every block due by w1
    run.window_counters = {k: c1[k] - c0[k] for k in c0}
    run.feed_s = run.feed_pairs[mark:feeds_end]
    run.gen_late_s = max(run.gen_late) if run.gen_late else 0.0
    run.heard = sink.audio()
    print(f"live: {len(run.packets)} packets, window counters "
          f"{run.window_counters}, generator late by at most "
          f"{run.gen_late_s * 1e3:.3f} ms")


def release(run) -> None:
    run.state = None


def check(run) -> dict:
    from benchmark.harness.cell import limits
    from benchmark.reference import compare
    from benchmark.reference.voices import F32

    sr = int(run.spec["sr"])
    per: dict = {}
    for i, (_, name, row) in enumerate(run.packets):
        if i not in run.appended:
            continue
        frame = int(F32(row[0, 1]) * F32(sr))
        if frame >= run.appended[i][1]:
            per.setdefault(name, []).append(row[0])
    run.spec["stream_events"] = {
        n: np.asarray(per.get(n, np.zeros((0, 4))), np.float32).reshape(-1, 4)
        for n in run.spec["streams"]}
    return compare.checked(
        compare.played(run.spec, run.project_dir, run.heard,
                       run.due_frames), limits(run.cell.name))
