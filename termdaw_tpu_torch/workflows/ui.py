"""Manual workflow: interactive command loop + paced playback.

Carried over from termdaw_tpu/workflows/ui.py; it builds the port's
Player (engine/player.py) and the port's copy of the command palette
(workflows/palette.py).

The reference runs a `skim` fuzzy command palette on a UI thread and an
engine thread joined by mpsc channels (ui_workflow.rs:14-115). Here the
structure is the same two threads: an input thread reads lines from stdin
and resolves them against the command set with prefix/substring matching
(doc.md:40-42 — "you can type them (partially)"); the engine loop in the
main thread executes commands and paces playback (Player.tick, 10 ms poll).

Commands (reference ui_workflow.rs:35-77, doc.md:44-54):
    quit render refresh normalize play pause stop >skip <prev set get
    norm-vals
`set` takes the time in seconds on the same line ("set 12.5") or prompts.
Every command is gated on a loaded state (check_loaded,
ui_workflow.rs:101-109).
"""

from __future__ import annotations

import queue
import sys
import threading

from ..utils.term import DEFAULT, BLUE, RED, MAGENTA

from ..engine.player import Player

COMMANDS = [
    "quit", "render", "refresh", "normalize", "play", "pause", "stop",
    ">skip", "<prev", "set", "get", "norm-vals",
]


def match_command(text: str) -> str | None:
    """Resolve partial input: exact, unique prefix, then unique substring."""
    text = text.strip()
    if not text:
        return None
    word = text.split()[0].lower()
    if word in COMMANDS:
        return word
    pref = [c for c in COMMANDS if c.startswith(word)]
    if len(pref) == 1:
        return pref[0]
    sub = [c for c in COMMANDS if word in c]
    if len(sub) == 1:
        return sub[0]
    return None


def run_ui_workflow(
    proj_sr: int, buffer_len: int, state, sink, input_stream=None,
    output=None,
) -> None:
    inp = input_stream if input_stream is not None else sys.stdin
    cmd_queue: queue.Queue = queue.Queue()
    use_palette = (
        input_stream is None
        and hasattr(inp, "isatty")
        and inp.isatty()
    )

    pal = None
    if use_palette:
        # arrow-key fuzzy selector on the controlling TTY
        # (reference ui_workflow.rs:35-45, doc.md:40-42)
        from .palette import Palette

        pal = Palette(COMMANDS)

    def reader() -> None:
        if pal is not None:
            while True:
                try:
                    line = pal.read_command()
                except Exception as e:  # tty went away / palette bug
                    import traceback

                    print(
                        f"palette reader error ({type(e).__name__}: {e}); "
                        "falling back to EOF quit",
                        file=sys.stderr,
                    )
                    traceback.print_exc(file=sys.stderr)
                    break
                if line is None:
                    break
                cmd_queue.put(line)
                if match_command(line) == "quit":
                    break
        else:
            for line in inp:
                cmd_queue.put(line)
                if match_command(line) == "quit":
                    break
        cmd_queue.put(None)  # EOF

    t = threading.Thread(target=reader, daemon=True)
    t.start()

    player = Player(state, sink, proj_sr, buffer_len)
    try:
        _engine_loop(
            state, sink, player, cmd_queue, inp, proj_sr
        )
    except KeyboardInterrupt:
        # Ctrl-C = clean quit (the reference's process would just die;
        # here the palette may hold the TTY in cbreak/no-echo)
        print(f"\n{MAGENTA}---- quit (interrupt){DEFAULT}")
    finally:
        if pal is not None:
            # the reader is a daemon blocked in read(); its own finally
            # never runs on interpreter exit — restore the terminal here
            # (idempotent, thread-safe)
            pal.restore_terminal()
        sink.close()


def _engine_loop(state, sink, player, cmd_queue, inp, proj_sr) -> None:
    running = True
    while running:
        try:
            line = cmd_queue.get(timeout=0.01)
        except queue.Empty:
            player.tick()
            continue
        if line is None:
            break
        cmd = match_command(line)
        if cmd is None:
            print(f"{RED}TermDaw: command not found!{DEFAULT}")
            continue
        print(f"{MAGENTA}---- {cmd}{DEFAULT}")

        def check_loaded() -> bool:
            if not state.loaded:
                print(f"{RED}State not loaded!{DEFAULT}")
                return False
            return True

        if cmd == "quit":
            running = False
        elif cmd == "refresh":
            state.refresh()
            player.playing = False
            sink.clear()
            sink.pause()
        elif cmd == "render":
            if check_loaded():
                sink.clear()
                sink.pause()
                player.playing = False
                state.render()
        elif cmd == "normalize":
            if check_loaded():
                sink.clear()
                sink.pause()
                player.playing = False
                state.scan_exact()
        elif cmd == "play":
            if check_loaded():
                player.play()
        elif cmd == "pause":
            player.pause()
        elif cmd == "stop":
            if check_loaded():
                player.stop()
        elif cmd == ">skip":
            if check_loaded():
                sink.clear()
                new_t = state.compiled.change_time(5 * proj_sr, True)
                state.fb.set_time(new_t)
        elif cmd == "<prev":
            if check_loaded():
                sink.clear()
                new_t = state.compiled.change_time(5 * proj_sr, False)
                state.fb.set_time(new_t)
        elif cmd == "set":
            if check_loaded():
                parts = line.split()
                if len(parts) > 1:
                    raw = parts[1]
                elif getattr(inp, "isatty", lambda: False)():
                    # palette mode: the reader thread owns the TTY in
                    # cbreak, so a main-thread readline would race it
                    # char-for-char — take the time inline instead
                    print(f"{RED}Usage: set <seconds> (type it after "
                          f"the command, e.g. 'set 12.5').{DEFAULT}")
                    continue
                else:
                    # piped input: the reader thread iterates the stream
                    # with read-ahead, so a readline here would race it —
                    # the time line has already been (or will be)
                    # consumed and enqueued; take it from the queue
                    print("time (seconds): ", end="", flush=True)
                    try:
                        nxt = cmd_queue.get(timeout=5.0)
                        if nxt is None:
                            cmd_queue.put(None)  # re-post the EOF marker
                            raw = None
                        else:
                            raw = nxt.strip()
                    except queue.Empty:  # no time line arrived
                        raw = None
                try:
                    seconds = float(raw)
                except (TypeError, ValueError):
                    print(
                        f"{RED}Error: could not parse time, did not set "
                        f"time.{DEFAULT}"
                    )
                    continue
                if seconds < 0.0:
                    print(f"{RED}Error: time needs to be positive.{DEFAULT}")
                    continue
                player.seek(int(seconds * proj_sr))
        elif cmd == "get":
            if check_loaded():
                tt = state.compiled.get_time()
                tf = tt / proj_sr
                print(
                    f"{DEFAULT}Frame: {BLUE}{tt}{DEFAULT}, Time: "
                    f"{BLUE}{tf}{DEFAULT}"
                )
        elif cmd == "norm-vals":
            if check_loaded():
                for name, val in state.compiled.get_normalization_values():
                    print(f"{MAGENTA} {name}: {val}{DEFAULT}")
