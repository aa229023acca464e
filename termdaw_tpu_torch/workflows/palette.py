"""Carried over from termdaw_tpu/workflows/palette.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Interactive command palette: arrow-key selection over the command set.

The reference pops a `skim` fuzzy selector over its commands on the UI
thread (ui_workflow.rs:35-45; doc.md:40-42 "a selection menu pops up ...
you can select an option with the arrow keys"). This is the first-party
equivalent: a raw-mode line editor on the controlling TTY with

* live fuzzy filtering (rank: exact > prefix > substring > subsequence,
  the skim default match being a ranked subsequence),
* Up/Down (and Ctrl-P/Ctrl-N) selection over the filtered list,
* Tab to complete the query to the highlighted command,
* Enter to submit — the highlighted command plus any argument words typed
  after the first space (so `set 12.5` works exactly like line mode),
* Esc to clear the query, Ctrl-D on an empty query to quit (Ctrl-C
  raises KeyboardInterrupt in the engine thread, which quits cleanly
  and restores the terminal — see ui.run_ui_workflow).

It is used only when stdin is a real TTY; piped input (tests, stream
drives, `echo render | ...`) keeps the plain line reader in ui.py.
Engine-side prints from the main thread interleave above the prompt; the
palette repaints itself on every keystroke so the prompt self-heals.
"""

from __future__ import annotations

import sys

from ..utils.term import DEFAULT, BLUE, MAGENTA

MAX_ROWS = 12


def fuzzy_rank(query: str, cand: str) -> int | None:
    """Smaller is better; None = no match. Empty query matches all."""
    q = query.lower()
    c = cand.lower()
    if not q:
        return 3
    if q == c:
        return 0
    if c.startswith(q):
        return 1
    if q in c:
        return 2
    it = iter(c)
    if all(ch in it for ch in q):  # subsequence
        return 4
    return None


def filter_commands(commands: list[str], query: str) -> list[str]:
    ranked = []
    for i, c in enumerate(commands):
        r = fuzzy_rank(query, c)
        if r is not None:
            ranked.append((r, i, c))
    ranked.sort()
    return [c for _, _, c in ranked]


class Palette:
    """Raw-TTY fuzzy selector. `read_command()` blocks until the user
    submits a line (returned as text, e.g. "render" or "set 12.5"),
    or returns None on EOF (Ctrl-D with empty query)."""

    def __init__(self, commands: list[str], tty_in=None, tty_out=None):
        self.commands = commands
        self.inp = tty_in if tty_in is not None else sys.stdin
        self.out = tty_out if tty_out is not None else sys.stdout
        self.query = ""
        self.sel = 0
        self._drawn_rows = 0

    # -- drawing ----------------------------------------------------------

    def _clear(self) -> None:
        if self._drawn_rows:
            self.out.write(f"\x1b[{self._drawn_rows}A")
        self.out.write("\r\x1b[J")
        self._drawn_rows = 0

    def _draw(self) -> None:
        self._clear()
        items = filter_commands(self.commands, self._match_word())[:MAX_ROWS]
        self.sel = min(self.sel, max(0, len(items) - 1))
        lines = []
        for i, it in enumerate(items):
            cursor = f"{MAGENTA}>{DEFAULT}" if i == self.sel else " "
            name = f"{BLUE}{it}{DEFAULT}" if i == self.sel else it
            lines.append(f"  {cursor} {name}")
        body = "\r\n".join(lines)
        if body:
            self.out.write(body + "\r\n")
        self.out.write(f"{MAGENTA}~ {DEFAULT}{self.query}")
        self.out.flush()
        self._drawn_rows = len(lines)

    def _match_word(self) -> str:
        return self.query.split()[0] if self.query.split() else ""

    def _args(self) -> str:
        parts = self.query.split(None, 1)
        return " " + parts[1] if len(parts) > 1 else ""

    # -- input ------------------------------------------------------------

    def _selected(self) -> str | None:
        items = filter_commands(self.commands, self._match_word())
        if not items:
            return None
        return items[min(self.sel, len(items) - 1)]

    def restore_terminal(self) -> None:
        """Restore the TTY to the mode seen before the first read_command.
        Safe to call from any thread / multiple times — needed when the
        main thread exits (quit or KeyboardInterrupt) while the reader
        thread is still blocked inside read_command, whose own `finally`
        never runs for a daemon thread."""
        import termios

        saved = getattr(self, "_saved_termios", None)
        if saved is not None:
            try:
                termios.tcsetattr(self.inp.fileno(), termios.TCSANOW, saved)
            except (OSError, ValueError):
                pass

    def _read1(self, fd: int) -> str:
        """One keystroke, read UNBUFFERED from the fd (os.read, not the
        text layer): the Esc-vs-escape-sequence peek below selects on the
        raw fd, which only works if no bytes hide in a Python-side
        buffer. Multi-byte UTF-8 decodes to U+FFFD and is ignored by the
        printable check — commands are ASCII."""
        import os as _os

        b = _os.read(fd, 1)
        return b.decode("utf-8", "replace") if b else ""

    def read_command(self) -> str | None:
        import termios
        import tty

        fd = self.inp.fileno()
        old = termios.tcgetattr(fd)
        if getattr(self, "_saved_termios", None) is None:
            self._saved_termios = old
        try:
            tty.setcbreak(fd)
            self.query = ""
            self.sel = 0
            self._drawn_rows = 0
            self._draw()
            while True:
                ch = self._read1(fd)
                if ch == "":  # closed tty
                    self._finish("")
                    return None
                if ch == "\x04":  # Ctrl-D
                    if not self.query:
                        self._finish("")
                        return None
                    self.query = ""
                elif ch in ("\r", "\n"):
                    cmd = self._selected()
                    if cmd is None:
                        continue
                    text = cmd + self._args()
                    self._finish(text)
                    return text
                elif ch == "\t":
                    cmd = self._selected()
                    if cmd is not None:
                        self.query = cmd + self._args()
                elif ch in ("\x7f", "\x08"):  # backspace
                    self.query = self.query[:-1]
                elif ch == "\x03":
                    # only reachable if the caller disabled ISIG; normally
                    # Ctrl-C raises KeyboardInterrupt in the main thread,
                    # which ui.py turns into a clean quit + terminal restore
                    self.query = ""
                    self.sel = 0
                elif ch == "\x10":  # Ctrl-P
                    self.sel = max(0, self.sel - 1)
                elif ch == "\x0e":  # Ctrl-N
                    self.sel += 1
                elif ch == "\x1b":
                    # distinguish a bare Esc from an escape sequence by
                    # peeking: sequence bytes arrive together, so if
                    # nothing is pending shortly after the ESC it was a
                    # lone keypress (blocking read(1) here would swallow
                    # the user's next real character)
                    import select

                    r, _, _ = select.select([fd], [], [], 0.05)
                    if not r:  # bare Esc clears
                        self.query = ""
                        self.sel = 0
                    else:
                        seq = self._read1(fd)
                        if seq == "[":
                            code = self._read1(fd)
                            if code == "A":
                                self.sel = max(0, self.sel - 1)
                            elif code == "B":
                                self.sel += 1
                        else:
                            self.query = ""
                            self.sel = 0
                elif ch.isprintable():
                    self.query += ch
                    self.sel = 0
                self._draw()
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    def _finish(self, text: str) -> None:
        self._clear()
        if text:
            self.out.write(f"{MAGENTA}~ {DEFAULT}{text}\r\n")
        self.out.flush()
