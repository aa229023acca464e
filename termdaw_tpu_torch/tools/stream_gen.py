"""Algorithmic floww-packet generator for the stream workflow (a copy of
tools/stream_gen.py that encodes through the port's fileio/packets).

The analog of the reference's `../music-gen --mode stream | cargo run`
integration (reference test_stream.sh:1-2): emits binary floww packets on
stdout in (approximately) real time, driving whatever streams the project
declares.

    python -m termdaw_tpu_torch.tools.stream_gen [--bpm 120] \
        [--duration 20] [--streams kick,snare,hat] [--burst] [--seed 0] \
      | TERMDAW_STREAM_IDLE=3 python -m termdaw_tpu_torch examples/stream

--burst writes everything at once (for piping into batch runs/tests);
without it, packets are paced to the musical clock like a live performer.
For the same arguments with --burst, the bytes equal tools/stream_gen.py's.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import numpy as np

from ..fileio.packets import encode_events, encode_text


PATTERNS = {
    # name -> (notes, 16th-note pattern over one bar)
    "kick": ([36], "x...x...x...x..."),
    "snare": ([38], "....x.......x..."),
    "hat": ([42], "x.x.x.x.x.x.x.x."),
    "hihat": ([42], "x.x.x.x.x.x.x.x."),
    "ride": ([51], "x...x...x...x..."),
    "bass": ([33, 36, 31, 38], "x.......x......."),
    "chords": ([60, 64, 67], "x..............."),
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m termdaw_tpu_torch.tools.stream_gen")
    ap.add_argument("--bpm", type=float, default=120.0)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--streams", default="kick,snare,hat")
    ap.add_argument("--burst", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rng = random.Random(args.seed)
    out = sys.stdout.buffer
    streams = [s.strip() for s in args.streams.split(",") if s.strip()]
    step = 60.0 / args.bpm / 4.0  # 16th note
    bar = step * 16

    out.write(encode_text(f"stream_gen: {args.bpm} bpm, {streams}"))
    out.flush()

    t_start = time.monotonic()
    t = 0.0
    bar_i = 0
    while t < args.duration:
        # emit one bar ahead for every stream
        for name in streams:
            notes, pat = PATTERNS.get(name, ([36], "x...x...x...x..."))
            rows = []
            for i, c in enumerate(pat):
                if c != "x" or rng.random() < 0.08:  # occasional dropouts
                    continue
                t_on = t + i * step
                note = float(notes[(bar_i + i) % len(notes)])
                vel = rng.uniform(0.6, 1.0)
                rows.append((0.0, t_on, note, vel))
                rows.append((0.0, t_on + step * 0.8, note, 0.0))
            if rows:
                ev = np.asarray(rows, np.float32)
                out.write(encode_events(name, ev))
        out.flush()
        t += bar
        bar_i += 1
        if not args.burst:
            # pace: stay one bar ahead of the wall clock
            ahead = t - (time.monotonic() - t_start)
            if ahead > bar:
                time.sleep(ahead - bar)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
