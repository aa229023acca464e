"""Carried over from termdaw_tpu/utils/term.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

ANSI terminal colors and the logging conventions of the framework.

The reference uses the `zen-colour` crate with a consistent convention
(reference main.rs:48-55, state.rs:484-507, graph.rs:84-95):
    DEFAULT = status text, BLUE = highlighted values, YELLOW = warnings,
    RED = errors, GREEN = ok/success, MAGENTA = command echo / norm-vals.

We keep the same convention. Colors are disabled automatically when stdout
is not a TTY (or when NO_COLOR is set) so logs stay clean in pipes/tests.
"""

from __future__ import annotations

import os
import sys

_FORCE = os.environ.get("TERMDAW_COLOR", "")
if _FORCE == "1":
    _ENABLED = True
elif _FORCE == "0" or os.environ.get("NO_COLOR"):
    _ENABLED = False
else:
    _ENABLED = hasattr(sys.stdout, "isatty") and sys.stdout.isatty()

DEFAULT = "\x1b[0m" if _ENABLED else ""
BLUE = "\x1b[34m" if _ENABLED else ""
YELLOW = "\x1b[33m" if _ENABLED else ""
RED = "\x1b[31m" if _ENABLED else ""
GREEN = "\x1b[32m" if _ENABLED else ""
MAGENTA = "\x1b[35m" if _ENABLED else ""


def status(msg: str) -> None:
    """Plain status line (reference DEFAULT-colored `println!`s)."""
    print(f"{DEFAULT}{msg}{DEFAULT}")


def info(msg: str) -> None:
    print(f"{DEFAULT}{msg}{DEFAULT}")


def value(val: object) -> str:
    """Highlight a value inline, BLUE like the reference."""
    return f"{BLUE}{val}{DEFAULT}"


def warn(msg: str) -> None:
    print(f"{YELLOW}{msg}{DEFAULT}")


def error(msg: str) -> None:
    print(f"{RED}{msg}{DEFAULT}")


def ok(msg: str) -> None:
    print(f"{GREEN}{msg}{DEFAULT}")


def command_echo(msg: str) -> None:
    print(f"{MAGENTA}{msg}{DEFAULT}")
