"""Wall-clock-paced playback: render blocks just ahead of real time.

Port of termdaw_tpu/engine/player.py (reference ui_workflow.rs:195-211),
with the same pacing, prebuffer, lead, catch-up windows and seek/stop
semantics, and `resync_fb_each_block` for the stream workflow. What
differs: the window audio lives on the render device, so it is copied to
the host (`.cpu().numpy()`) before the sink takes it, and the window size
comes from the port's engine/state.py.
"""

from __future__ import annotations

import time

from .state import render_chunk_blocks


class Player:
    def __init__(self, state, sink, proj_sr: int, buffer_len: int) -> None:
        self.state = state
        self.sink = sink
        self.proj_sr = proj_sr
        self.buffer_len = buffer_len
        self.playing = False
        self.since = time.monotonic()
        self.millis_generated = 0.0
        # the stream workflow turns this on: each tick window re-aligns the
        # floww cursor to the graph time, since a feed may have trimmed
        # and appended the streams under it (reference player.py:29)
        self.resync_fb_each_block = False

    # blocks rendered and queued before the wall clock starts: absorbs
    # per-window render latency spikes so the deficit stays bounded
    # (~341 ms of audio at 48k/1024)
    PREBUFFER_BLOCKS = 16
    # lead (in blocks) that tick() keeps while playing: the reference
    # paces to a 0.5 ms lead (ui_workflow.rs:200-201), which lets the
    # prebuffer erode to zero so that one slow render starves the sink
    LEAD_BLOCKS = 16
    # window sizes for catch-up batching: a deficit of many blocks renders
    # in one call
    _WINDOWS = (32, 16, 8, 4, 2, 1)

    def _render_queue(self, nb: int) -> None:
        """Render nb blocks at the graph time and queue them, interleaved,
        on the host."""
        audio = self.state.compiled.render_window(self.state.fb, nb)
        self.state.fb.advance_blocks(nb)
        self.sink.queue_audio(audio.cpu().numpy().reshape(-1))

    def play(self) -> None:
        if self.playing:
            return  # a second 'play' must not re-prebuffer / reset pacing
        cg = self.state.compiled
        if cg is not None and self.state.cs > 0:
            # pin bake-table caps to the full known schedule
            cg.seed_caps(self.state.fb, self.state.cs,
                         render_chunk_blocks(self.state.cs))
        self.playing = True
        self._restart_pacing()
        self.sink.resume()

    def _restart_pacing(self) -> None:
        """Reset the pacing epoch and queue the prebuffer lead."""
        self.millis_generated = 0.0
        if self.state.compiled is not None and self.PREBUFFER_BLOCKS > 0:
            nb = self.PREBUFFER_BLOCKS
            self._render_queue(nb)
            self.millis_generated = nb * self.buffer_len / self.proj_sr * 1e3
        self.since = time.monotonic()

    def pause(self) -> None:
        self.playing = False
        self.sink.pause()

    def stop(self) -> None:
        self.playing = False
        self.sink.pause()
        self.sink.clear()
        if self.state.compiled is not None:
            self.state.compiled.set_time(0)
        self.state.fb.set_time(0)

    def seek(self, t_frames: int) -> None:
        self.sink.clear()
        if self.state.compiled is not None:
            self.state.compiled.set_time(t_frames)
        self.state.fb.set_time(t_frames)
        if self.playing:
            # clear() discarded the queued lead: prebuffer again
            self._restart_pacing()

    def tick(self) -> int:
        """Render as many blocks as wall-clock pacing demands.
        Returns the number of blocks rendered (0 = idle)."""
        rendered = 0
        if not self.playing:
            return 0
        if not self.state.loaded:
            self.playing = False
            return 0
        block_ms = self.buffer_len / self.proj_sr * 1000.0
        while self.playing:  # stop()/pause() end a long catch-up drain
            elapsed_ms = (time.monotonic() - self.since) * 1000.0
            lead_ms = self.LEAD_BLOCKS * block_ms
            deficit_ms = elapsed_ms - (self.millis_generated - lead_ms)
            if deficit_ms <= 0:
                break
            want = max(1, int(deficit_ms / block_ms) + 1)
            nb = next(w for w in self._WINDOWS if w <= want)
            if self.resync_fb_each_block:
                self.state.fb.set_time(self.state.compiled.get_time())
            self._render_queue(nb)
            self.millis_generated += nb * block_ms
            rendered += nb
        return rendered
