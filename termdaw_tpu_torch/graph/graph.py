"""Carried over from termdaw_tpu/graph/graph.py, which cannot be imported
without jax (its package imports compile.py); the code is unchanged.

Audio DAG: vertices, edges, validity checks, time cursor.

Host-side structure mirroring the reference Graph (graph.rs:12-237):
reverse adjacency (in_edges[b] = inputs of b in connect order), name->index
map, cycle rejection at connect time, output designation, reachability
check with warnings, and the global frame cursor. Unlike the reference,
this graph holds only *declarations* — all DSP lives in the window program
(graph/compile.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..utils.term import YELLOW, BLUE, RED, DEFAULT

# vertex kinds (reference VertexExt variants, extensions.rs:15-80)
SUM = "sum"
NORMALIZE = "normalize"
SAMPLELOOP = "sampleloop"
SAMPLEMULTI = "samplemulti"
SAMPLELERP = "samplelerp"
DEBUGSINE = "debugsine"
SYNTH = "synth"
SAMPSYN = "sampsyn"
PLUGINFX = "pluginfx"  # the reference's Lv2fx, backed by native effects here
ADSR = "adsr"
BANDPASS = "bandpass"

HAS_INPUT = {
    SUM: True, NORMALIZE: True, SAMPLELOOP: False, SAMPLEMULTI: False,
    SAMPLELERP: False, DEBUGSINE: False, SYNTH: False, SAMPSYN: False,
    PLUGINFX: True, ADSR: True, BANDPASS: True,
}  # reference extensions.rs:266-281


@dataclass
class VertexDecl:
    name: str
    kind: str
    gain: float = 1.0
    angle: float = 0.0  # clamped to [-90, 90] (reference graph.rs:255)
    wet: float = 0.0    # clamped to [0, 1] (reference graph.rs:256)
    params: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.angle = min(max(self.angle, -90.0), 90.0)
        self.wet = min(max(self.wet, 0.0), 1.0)

    @property
    def has_input(self) -> bool:
        return HAS_INPUT[self.kind]


class Graph:
    def __init__(self, max_buffer_len: int, sr: int) -> None:
        self.vertices: list[VertexDecl] = []
        self.in_edges: list[list[int]] = []
        self.name_map: dict[str, int] = {}
        self.names: list[str] = []
        self.output_vertex: int | None = None
        self.max_buffer_len = max_buffer_len
        self.sr = sr
        self.t = 0

    def reset(self) -> None:
        self.vertices.clear()
        self.in_edges.clear()
        self.name_map.clear()
        self.names.clear()
        self.output_vertex = None
        self.t = 0

    def add(self, decl: VertexDecl) -> None:
        self.vertices.append(decl)
        self.in_edges.append([])
        n = len(self.vertices) - 1
        self.name_map[decl.name] = n
        self.names.append(decl.name)

    def _connect_internal(self, a: int, b: int) -> bool:
        # reference graph.rs:58-78
        if a == b:
            return False
        n = len(self.vertices)
        if a >= n or b >= n:
            return False
        if not self.vertices[b].has_input:
            return False

        # iterative DFS with a visited set: the reference's recursion
        # (graph.rs:66-72) is native Rust and exponential on diamonds;
        # a Python recursion would RecursionError on ~300-deep chains
        # (same accept/reject answer, so behavior matches)
        stack = [a]
        seen = set()
        found = False
        while stack:
            x = stack.pop()
            if x == b:
                found = True
                break
            if x in seen:
                continue
            seen.add(x)
            stack.extend(self.in_edges[x])
        if found:
            return False
        self.in_edges[b].append(a)
        return True

    def connect(self, a: str, b: str) -> bool:
        # reference graph.rs:80-96 (warnings for unknown names)
        ia = self.name_map.get(a)
        ib = self.name_map.get(b)
        if ia is None:
            print(
                f'{YELLOW}TermDaw: warning: vertex {BLUE}"{a}"{YELLOW} cannot '
                f"be found and thus can't be connected.{DEFAULT}"
            )
            return False
        if ib is None:
            print(
                f'{YELLOW}TermDaw: warning: vertex {BLUE}"{b}"{YELLOW} cannot '
                f"be found and thus can't be connected to.{DEFAULT}"
            )
            return False
        return self._connect_internal(ia, ib)

    def set_output(self, name: str) -> bool:
        idx = self.name_map.get(name)
        if idx is None:
            return False
        self.output_vertex = idx
        return True

    def check_graph(self) -> bool:
        # reference graph.rs:150-174
        if self.output_vertex is None:
            print(f"{RED}TermDaw: error: output vertex not found.{DEFAULT}")
            return False
        out = self.output_vertex
        if not self.in_edges[out] and self.vertices[out].has_input:
            print(f"{RED}TermDaw: error: output receives no inputs.{DEFAULT}")
            return False
        reach = self.reachable_set()
        for i, name in enumerate(self.names):
            if i not in reach:
                print(
                    f'{YELLOW}TermDaw: warning: vertex {BLUE}"{name}"{YELLOW} '
                    f"does not reach output.{DEFAULT}"
                )
        return True

    def reachable_set(self) -> set[int]:
        if self.output_vertex is None:
            return set()
        seen: set[int] = set()
        stack = [self.output_vertex]
        while stack:  # iterative: deep chains must not RecursionError
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            stack.extend(self.in_edges[x])
        return seen

    def topo_order(self) -> list[int]:
        """Post-order DFS from the output — the reference's run_vertex
        recursion order (graph.rs:98-121), so input summation order
        matches. Iterative (explicit stack) so a ~1000-vertex chain
        cannot hit Python's recursion limit; emission order is identical
        to the recursive form: children first, in in_edges order."""
        if self.output_vertex is None:
            return []
        order: list[int] = []
        seen: set[int] = set()
        # (vertex, next-child-index) frames — exactly the recursion
        stack: list[list[int]] = [[self.output_vertex, 0]]
        seen.add(self.output_vertex)
        while stack:
            frame = stack[-1]
            x, ci = frame
            kids = self.in_edges[x]
            while ci < len(kids) and kids[ci] in seen:
                ci += 1
            frame[1] = ci + 1
            if ci < len(kids):
                seen.add(kids[ci])
                stack.append([kids[ci], 0])
            else:
                order.append(x)
                stack.pop()
        return order

    # -- time cursor (reference graph.rs:123-139) ---------------------------
    def set_time(self, time: int) -> None:
        self.t = time

    def change_time(self, delta: int, plus: bool) -> int:
        if plus:
            self.t = self.t + delta
        else:
            self.t = self.t - min(delta, self.t)
        return self.t

    def get_time(self) -> int:
        return self.t
