"""Stream workflow: live floww packets from stdin drive the graph.

Port of termdaw_tpu/workflows/stream.py (reference
stream_workflow.rs:13-106). A reader thread decodes binary floww packets
(fileio/packets.py) from the raw input fd and queues them; the main
thread, which does all the rendering, trims the consumed stream prefixes,
appends the new events and re-aligns the floww cursor to the graph time
on each feed (stream_workflow.rs:63-71), and paces playback with the
Player on every loop iteration, re-aligning the cursor before each window
(`resync_fb_each_block`, stream_workflow.rs:93-95). A decode error prints
"could not decode" and ends the workflow (the reference exits the
process, stream_workflow.rs:33-36); EOF does not stop playback;
`max_idle_s` gives batch runs and tests a clean exit. The reader touches
no tensor.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time

from ..engine.player import Player
from ..fileio.packets import PacketDecoder, PacketError
from ..utils.term import DEFAULT, RED

# the live prebuffer and lead: an event lands behind this many blocks of
# queued audio (about 85 ms at 48 kHz / 1024)
STREAM_LEAD_BLOCKS = 4


def run_stream_workflow(
    proj_sr: int, buffer_len: int, state, sink, input_stream=None,
    max_idle_s: float | None = None,
) -> None:
    raw_in = input_stream if input_stream is not None else sys.stdin.buffer
    feed_queue: queue.Queue = queue.Queue()

    def reader() -> None:
        dec = PacketDecoder()
        # read through the raw fd where there is one: a daemon thread
        # blocked in a BufferedReader.read holds the buffer's lock and
        # aborts CPython at interpreter shutdown
        try:
            fd = raw_in.fileno()
        except Exception:  # BytesIO etc. raise UnsupportedOperation
            fd = None

        def read_chunk():
            if fd is not None:
                return os.read(fd, 4096)
            return raw_in.read(4096)

        try:
            while True:
                data = read_chunk()
                if not data:
                    break
                for pkt in dec.feed(data):
                    feed_queue.put(("feed", [pkt]))
        except PacketError:
            print(f"{RED}Error: could not decode std input.{DEFAULT}")
            feed_queue.put(("fatal", None))
            return
        except OSError:
            pass
        feed_queue.put(("eof", None))

    threading.Thread(target=reader, daemon=True).start()

    player = Player(state, sink, proj_sr, buffer_len)
    player.resync_fb_each_block = True
    player.PREBUFFER_BLOCKS = STREAM_LEAD_BLOCKS
    player.LEAD_BLOCKS = STREAM_LEAD_BLOCKS
    if state.loaded:
        player.play()
    else:
        print(f"{RED}State not loaded!{DEFAULT}")

    idle_since = time.monotonic()
    while True:
        try:
            kind, payload = feed_queue.get(timeout=0.01)
            idle_since = time.monotonic()
        except queue.Empty:
            player.tick()
            # EOF does not stop playback (the reference loops forever);
            # max_idle_s trips only with no packet pending
            if max_idle_s is not None and feed_queue.empty() and (
                time.monotonic() - idle_since > max_idle_s
            ):
                break
            continue
        if kind == "fatal":
            break
        if kind == "eof":
            continue
        if not state.loaded:
            print(f"{RED}State not loaded!{DEFAULT}")
            continue
        state.fb.trim_streams()
        msgs = state.fb.append_streams(payload)
        state.fb.set_time(state.compiled.get_time())
        if msgs:
            print(f"MSGs: {msgs}")
        # pace on every iteration: a dense packet stream would otherwise
        # keep the queue non-empty past the lead and starve the sink
        player.tick()
    sink.close()
