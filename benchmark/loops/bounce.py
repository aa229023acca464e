"""Bounce loop: one user bouncing the song to WAV back to back with
`State.render()`, a closed loop.

Set-up writes the project, refreshes it, feeds a streamed project's
packets, then renders until a render captures no new window program
(the first bakes live and records the chains; a repeat render starts
from the carries the last one left, which can widen the bake tables
once). The window then bounces until `seconds` have passed: each bounce
writes its WAV to the null device, but the last, which is the bounce
that would end past the window, writes a file under the run's directory
that the check reads back. `bounce_xrt` is the seconds of audio the
WAV writer took over the window, at the render rate, over the window's
wall.

The check compares that WAV with the plain reference's render of the
same spec: every bounce after the first starts from the state the one
before it left, so the reference renders the song back to back as
often as the State did, up to three times (compare.bounce). It also
counts the window's bounces that wrote another number of frames than
the song has at the render rate, from the spec alone (`bounces_off`)."""

from __future__ import annotations

import os
import statistics
import time

# bounces traced in a --trace 1 run; warm-up renders at most
TRACED_UNITS = 3
WARMUP_RENDERS = 6


def setup(run) -> None:
    from benchmark.harness import work
    from benchmark.harness.cell import project_module
    from benchmark.harness.program import load
    from termdaw_tpu_torch.engine.state import State
    from termdaw_tpu_torch.fileio.wav import WavWriter
    from termdaw_tpu_torch.graph.compile import CompiledGraph

    d = run.workdir / "project"
    run.spec = project_module(run.cell.config["project"]).build(
        run.cell.config, run.seed, d)
    run.state = st = load(run, d)
    run.sample_frames = work.project_facts(run.spec, d)
    run.spans.wrap(WavWriter, "write_ints", "WAV write")
    run.written = [0]      # frames the WAV writer took, this bounce
    timed = WavWriter.write_ints

    def write_ints(self, ints):
        run.written[-1] += int(ints.size) // 2
        return timed(self, ints)

    run.spans.patch(WavWriter, "write_ints", write_ints)
    run.spans.wrap(State, "render_device", "render windows")
    run.spans.wrap(CompiledGraph, "seed_caps", "seed caps")
    st.output_file = os.devnull
    for i in range(WARMUP_RENDERS):
        before = st.compiled.captures
        st.render()
        if i >= 1 and st.compiled.captures == before:
            break
    run.renders = i + 1


def window(run, seconds: float) -> None:
    from benchmark.harness.program import counters

    st = run.state
    cg = st.compiled
    final = run.workdir / "last_bounce.wav"
    c0 = counters(cg)
    mark = run.spans.mark()
    walls: list[float] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        est = statistics.median(walls[-5:]) if walls else 0.0
        last = (time.perf_counter() + est >= deadline
                and run.tracer.last_allowed(i))
        st.output_file = str(final) if last else os.devnull
        run.tracer.before(i)
        run.written.append(0)
        b0 = time.perf_counter()
        with run.spans.span("bounce"):
            st.render()
        walls.append(time.perf_counter() - b0)
        run.tracer.after(i)
        i += 1
        if last:
            break
    wall = time.perf_counter() - t0
    run.attempted, run.failed = i, 0
    written = run.written[-i:]
    run.e2e["bounce_xrt"] = sum(written) / int(run.spec["render_sr"]) / wall
    run.counters = {k: v - c0[k] for k, v in counters(cg).items()}
    run.window_s = wall
    run.window_written = written
    run.wav_write_s = run.spans.since(mark, "WAV write")
    run.final_wav = final
    run.renders += i


def release(run) -> None:
    run.state = None


def check(run) -> dict:
    from benchmark.harness.cell import limits
    from benchmark.reference import compare, render

    vals = compare.bounce(run.spec, run.workdir / "project", run.final_wav,
                          run.renders)
    frames = render.song_frames(run.spec)
    vals["bounces_off"] = sum(w != frames for w in run.window_written)
    return compare.checked(vals, limits(run.cell.name))
