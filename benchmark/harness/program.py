"""What the loops share in driving the program: loading a project into a
State, reading its window-program counters, and a sink that keeps what
the Player queues and when."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np


def load(run, spec_dir: Path):
    """Refresh the project in spec_dir into a State on the run's device
    and feed the spec's packets."""
    from termdaw_tpu_torch.config import Config
    from termdaw_tpu_torch.engine.state import State
    from termdaw_tpu_torch.fileio.packets import PacketDecoder

    st = State(Config.read(spec_dir / "project.toml"), str(spec_dir),
               device=run.device)
    with run.spans.span("refresh"):
        st.refresh()
    if not st.loaded:
        raise RuntimeError(f"the project in {spec_dir} did not load")
    if run.spec.get("packets"):
        with run.spans.span("feed"):
            st.fb.append_streams(PacketDecoder().feed(run.spec["packets"]))
    return st


COUNTERS = ("served_windows", "live_bakes", "captures", "replays")


def counters(cg) -> dict:
    """The CompiledGraph's window counters (graph/compile.py)."""
    return {k: int(getattr(cg, k)) for k in COUNTERS}


class RecordingSink:
    """An audio sink (the program's engine/sink.py interface) that keeps
    every queued chunk with its arrival time and the frames queued so far,
    and the time of its first resume(): a device draining in real time
    from then plays frame f at t_resume + f / sr."""

    def __init__(self, spans) -> None:
        self.spans = spans
        self.reset()

    def reset(self) -> None:
        self.chunks: list = []
        self.arrivals: list = []      # (time, frames queued so far)
        self.frames = 0
        self.t_resume: float | None = None
        self.until = None             # (frames, called once they are in)

    def time_at(self, frames: int) -> float | None:
        """When the sink first held `frames` frames (None: not yet)."""
        for t, n in self.arrivals:
            if n >= frames:
                return t
        return None

    def queue_audio(self, interleaved: np.ndarray) -> None:
        with self.spans.span("sink"):
            a = np.asarray(interleaved, np.float32)
            self.chunks.append(a)
            self.frames += len(a) // 2
            self.arrivals.append((time.perf_counter(), self.frames))
        if self.until is not None and self.frames >= self.until[0]:
            self.until[1]()

    def audio(self) -> np.ndarray:
        """[frames, 2] of everything queued."""
        return np.concatenate(self.chunks).reshape(-1, 2)

    def resume(self) -> None:
        if self.t_resume is None:
            self.t_resume = time.perf_counter()

    def pause(self) -> None:
        pass

    def clear(self) -> None:
        pass

    def close(self) -> None:
        pass
