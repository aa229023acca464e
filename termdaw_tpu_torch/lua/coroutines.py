"""Carried over from termdaw_tpu/lua/coroutines.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Lua coroutines on handoff threads.

The reference gets coroutines for free by embedding real Lua via mlua
(reference Cargo.toml:13); a tree-walking interpreter cannot suspend a
Python call stack, so each Lua coroutine runs on its own daemon thread
and `resume`/`yield` hand control back and forth through a pair of
1-slot queues. The GIL plus the strict handoff protocol (the resumer
blocks until the coroutine yields, returns, or errors; a suspended
coroutine blocks until resumed) mean exactly one thread executes Lua at
any moment — the interpreter's single-threaded semantics are preserved,
including across host-function frames (a Lua callback invoked from a
registered Python function can still yield, which a generator-based
design could not do).

Lifecycle matches Lua 5.3 (coroutine.* in the manual): statuses
suspended/running/normal/dead, `resume` returns `(true, ...)` or
`(false, message)`, `wrap` re-raises the error instead. Plus Lua 5.4's
`coroutine.close` (VERDICT r4 weak 6): kills a suspended coroutine's
parked thread and marks it dead.

Thread reclamation (VERDICT r4 weak 6): an abandoned suspended
coroutine must not park its daemon thread until process exit. The
parked thread deliberately holds NO strong reference to its Coroutine —
the thread target is a module function taking a weakref, `_current.co`
stores a weakref, and `co_yield` drops its local before parking — so
dropping the last user reference makes CPython call `Coroutine.__del__`
immediately, which injects a kill sentinel and the thread unwinds. (A
script that closes over its own coroutine object keeps it alive through
the thread's Lua frames — self-referential by construction, bounded by
the script's own choices, and still reclaimed by `coroutine.close`.)
"""

from __future__ import annotations

import queue
import threading
import weakref


class CoroutineError(RuntimeError):
    """Raised for misuse detected by the library itself (bad resume /
    yield outside a coroutine). Converted to LuaError by the stdlib
    wrappers in interp.py so pcall can trap it like any runtime error."""


class _Kill(BaseException):
    """Injected into a parked coroutine thread (close / GC) to unwind
    its Lua frames. BaseException so script-level pcall (which traps
    Exception-derived LuaError) cannot swallow it."""


_KILL = object()  # sentinel sent through _to_co instead of resume args

# which Coroutine the *current Python thread* is executing, as a WEAKREF
# (None on the interpreter's main thread) — a strong ref here would pin
# the Coroutine for the life of its parked thread
_current = threading.local()


def current_coroutine():
    wr = getattr(_current, "co", None)
    return wr() if wr is not None else None


def _co_body(wr, fn, to_co, from_co) -> None:
    """Thread body. Takes the queues and fn directly (strong refs to
    those are fine) and only a weakref to the Coroutine, so a parked
    thread never keeps an abandoned Coroutine alive."""
    _current.co = wr
    args = to_co.get()
    if args is _KILL:
        return
    try:
        res = fn(*args)
        if not isinstance(res, tuple):
            res = (res,) if res is not None else ()
        from_co.put(("return", res))
    except _Kill:
        pass  # closed while suspended; nobody is waiting on _from_co
    except BaseException as e:  # noqa: BLE001 — a dying thread must report
        # LuaError carries a script message; anything else (host bug,
        # _Break/_Goto escaping a frame) is surfaced as text so resume
        # returns (false, msg) instead of deadlocking the resumer
        from_co.put(("error", str(e) or type(e).__name__))


class Coroutine:
    """One Lua coroutine: a parked daemon thread plus two handoff slots.

    `_to_co` carries resume arguments into the coroutine; `_from_co`
    carries `(kind, payload)` out, where kind is "yield" (payload =
    tuple of yielded values), "return" (tuple of return values), or
    "error" (message string).
    """

    __slots__ = ("_fn", "status", "_to_co", "_from_co", "_thread",
                 "__weakref__")

    def __init__(self, fn):
        if not callable(fn):
            raise CoroutineError(
                "bad argument #1 to 'create' (function expected)"
            )
        self._fn = fn
        self.status = "suspended"
        self._to_co: queue.Queue = queue.Queue(maxsize=1)
        self._from_co: queue.Queue = queue.Queue(maxsize=1)
        self._thread: threading.Thread | None = None

    # -- the resumer side -----------------------------------------------------
    def resume(self, *args) -> tuple:
        if self.status == "dead":
            return (False, "cannot resume dead coroutine")
        if self.status != "suspended":
            return (False, f"cannot resume non-suspended coroutine "
                           f"(status: {self.status})")
        caller = current_coroutine()
        if caller is not None:
            caller.status = "normal"
        self.status = "running"
        if self._thread is None:
            self._thread = threading.Thread(
                target=_co_body,
                args=(weakref.ref(self), self._fn, self._to_co,
                      self._from_co),
                daemon=True, name="lua-coroutine",
            )
            self._thread.start()
        self._to_co.put(tuple(args))
        kind, payload = self._from_co.get()
        if caller is not None:
            caller.status = "running"
        if kind == "yield":
            self.status = "suspended"
            return (True, *payload)
        self.status = "dead"
        if kind == "return":
            return (True, *payload)
        return (False, payload)

    def close(self) -> tuple:
        """Lua 5.4 coroutine.close: kill a suspended (or dead) coroutine,
        reclaiming its parked thread. Errors on running/normal — a
        coroutine cannot close itself or its resumer."""
        if self.status == "dead":
            return (True,)
        if self.status != "suspended":
            raise CoroutineError(
                f"cannot close a {self.status} coroutine"
            )
        self.status = "dead"
        t = self._thread
        if t is not None and t.is_alive():
            self._to_co.put(_KILL)
            t.join(timeout=5.0)
        self._thread = None
        return (True,)

    def __del__(self):
        # GC reclamation of an abandoned suspended coroutine: the parked
        # thread holds no strong ref to us (see _co_body), so this runs
        # as soon as the script drops the object. put_nowait is safe:
        # suspended means the thread consumed the last resume args, so
        # the 1-slot queue is empty.
        try:
            t = self._thread
            if t is not None and t.is_alive() and self.status != "dead":
                self._to_co.put_nowait(_KILL)
        except Exception:  # pragma: no cover — interpreter teardown
            pass


def co_yield(*values) -> tuple:
    co = current_coroutine()
    if co is None:
        raise CoroutineError("attempt to yield from outside a coroutine")
    to_co, from_co = co._to_co, co._from_co
    from_co.put(("yield", tuple(values)))
    # drop the strong ref BEFORE parking: the suspended thread's stack
    # must not pin the Coroutine, or abandoning it could never reclaim
    # the thread (see module docstring)
    del co
    args = to_co.get()
    if args is _KILL:
        raise _Kill()
    return args
