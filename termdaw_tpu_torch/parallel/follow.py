"""The CLI under a launcher: rank 0 runs the workflow, the others follow.

Under a launcher that starts one process a rank (torchrun, or anything
that sets RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT), every rank builds
the same project's State on its own device. Rank 0 runs the workflow
(stdin, palette, sink) through a `Leader`, which tells the other ranks to
do the same before each State call that renders or rebuilds: `refresh`,
`render` and `scan_exact` (the normalization scan). Before a render or a
scan it also sends its graph time, numeric state and carries, so the
ranks start that sharded call from rank 0's state whatever happened on
rank 0 alone in between (seeks, playback: the Player and the stream
workflow never shard, as in the reference, termdaw_tpu/engine/player.py:68,
133). The other ranks run `follow` until rank 0 says "quit".

The commands travel on a gloo group of their own (host objects, list-form
`all_gather_object`), whatever carries the render's collectives; a rank
waits up to CONTROL_TIMEOUT for the next command.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

# how long a following rank waits for rank 0's next command (a user may
# leave the workflow idle)
CONTROL_TIMEOUT = timedelta(days=1)


def control_group():
    """The command channel: a gloo group over every rank (a collective
    call: every rank makes it, in the same order)."""
    return dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)


def _exchange(msg, group):
    """Rank 0's `msg`, on every rank (the others pass None)."""
    box = [None] * dist.get_world_size(group)
    dist.all_gather_object(box, msg, group=group)
    return box[0]


def _to_cpu(tree):
    """A numeric state tree (dicts, tuples, NamedTuples of tensors) with
    every tensor on the host, to pickle."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_to_cpu(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            tuple(vals)
    return tree


def _snapshot(state):
    cg = state.compiled
    return (cg.get_time(), _to_cpu(cg.num_state), dict(cg.carries))


class Leader:
    """Rank 0's State as the workflows see it: every attribute is the
    State's, and refresh, render and scan_exact first send the command
    (with rank 0's graph state for the two that render) to the ranks in
    `follow`."""

    def __init__(self, state, group) -> None:
        self._state = state
        self._group = group

    def __getattr__(self, name):
        return getattr(self._state, name)

    def refresh(self) -> None:
        _exchange(("refresh", None), self._group)
        self._state.refresh()

    def render(self) -> None:
        _exchange(("render", _snapshot(self._state)), self._group)
        self._state.render()

    def scan_exact(self) -> None:
        _exchange(("scan", _snapshot(self._state)), self._group)
        self._state.scan_exact()

    def close(self) -> None:
        """Let the following ranks leave `follow`."""
        _exchange(("quit", None), self._group)


def follow(state, group) -> None:
    """Run rank 0's commands on this rank's State until it sends quit."""
    while True:
        op, snap = _exchange(None, group)
        if op == "quit":
            return
        if op == "refresh":
            state.refresh()
            continue
        t, num_state, carries = snap
        state.compiled.load_reference_state(num_state, carries, t)
        if op == "render":
            state.render()
        elif op == "scan":
            state.scan_exact()
        else:
            raise RuntimeError(f"follow: unknown command {op!r}")
