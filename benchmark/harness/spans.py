"""Host ranges the benchmark puts around its calls into the program's
layers: each is a torch.profiler `record_function` range of that name
and a host timer (the per-layer metrics read the seconds of every call;
the traced run names the device's idle gaps by their start and end, on
whatever thread they ran)."""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict


class Spans:
    def __init__(self) -> None:
        self.seconds: dict[str, list[float]] = defaultdict(list)
        # (start, end, name) of every span, on the perf_counter clock,
        # from every thread: the traced run names idle gaps by them
        self.events: list[tuple] = []
        self._patched: list[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.autograd.profiler import record_function

        t0 = time.perf_counter()
        with record_function(name):
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.seconds[name].append(t1 - t0)
                self.events.append((t0, t1, name))

    def wrap(self, owner, attr: str, name: str) -> None:
        """Time every call of owner.attr (a function or method) as span
        `name`, until unwrap()."""
        orig = getattr(owner, attr)
        spans = self

        @functools.wraps(orig)
        def wrapper(*a, **kw):
            with spans.span(name):
                return orig(*a, **kw)

        self.patch(owner, attr, wrapper)

    def patch(self, owner, attr: str, new) -> None:
        """Put `new` in place of owner.attr until unwrap()."""
        self._patched.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def unwrap(self) -> None:
        for owner, attr, orig in reversed(self._patched):
            setattr(owner, attr, orig)
        self._patched.clear()

    def total(self, name: str) -> float:
        return float(sum(self.seconds.get(name, ())))

    def mark(self) -> dict[str, int]:
        """Call counts so far, to read the spans of a later stretch."""
        return {k: len(v) for k, v in self.seconds.items()}

    def since(self, mark: dict[str, int], name: str) -> list[float]:
        return self.seconds.get(name, [])[mark.get(name, 0):]
