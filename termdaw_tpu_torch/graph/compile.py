"""CompiledGraph: a refreshed DAG as a window program of tensor ops.

Port of termdaw_tpu/graph/compile.py. The host logic is carried over
unchanged: bake-table packing and sticky caps (`_pack_bakes`,
`_caps_from_table`, `_merge_caps`, `_CAP_HWM` scoped by `cap_scope`),
TERMDAW_VOICE_CAP's oldest-voice steal, the carry classes and their
freshness index (`_FRESH_CARRIES`, `_unfresh`), `seed_caps` with its
chain-storing pass 2, the prebaked and recorded chains
(`_prebake_take`, `_record_window`, `release_chains`), the SampleMulti
bake with fused groups (`_bake_all`, `_group_pool`, `_bake_fused_group`,
`_fused_member_vecs`, `_merge_group`), time control and the normalize
resets. The device side runs eagerly in PyTorch on an explicit device
instead of as a jitted XLA program:

* each sample is uploaded once at build and padded (and, for a fused
  group over several samples, concatenated) on the device; each window's
  bake tables are two uploads (one int32, one float32 buffer) that
  `_unpack_bakes` slices;
* a chain window keeps those two uploaded buffers, its layout and its
  sparse carry delta: serving it is `_unpack_bakes` over the stored
  tensors, with no host bake and no upload, so a served render is
  bit-identical to a live one. TERMDAW_PREBAKE (default 1) and
  TERMDAW_PREBAKE_MB (default 256, counted in device bytes) are read at
  build. The port always fuses, so the reference's per-chain `fused` key
  is dropped. Pass 2 keeps a window only if its bytes fit the budget
  (the reference keeps the window that crosses it);
* `_program` has an arm for every vertex kind and reads device inputs
  only (reference `packed`, compile.py:1589-1598): the bake buffers, the
  window's first frame `t0` (a Python int or a 0-d int64 tensor), the
  time table, the traced effect params and the numeric state, which it
  writes back in place at its end (`num_state`'s tensors are allocated
  once; every reset, seek and hand-over writes into them). The PLUGINFX
  arm (the native effects, ops/fx.py) takes its traced params as 0-d
  views of one persistent f32 vector that `_pack_fx` refreshes in place
  at each PluginHost change, its device constants (the eq3's biquad
  coefficients) from build, and its wet gate from the host: with wet <
  1e-4 the input passes and the `.fx` state is left as it was, without
  running the effect (the reference's `jnp.where` leaf by leaf gives the
  same values);
* the window-program cache (reference compile.py:124-175, 1197-1225,
  1584-1604): a bounded LRU `_PROGRAM_CACHE` of `_WindowProgram`s, capped
  by TERMDAW_PROGRAM_CACHE (max(8, int(env or 128)), read at import),
  keyed by (graph serial, nb, is_scan, bake layout, time-table length),
  and a sharded window's by (graph serial, "sharded", nb_total, is_scan,
  world size, this rank's bake layout, time-table length). On
  CUDA an entry is one captured `torch.cuda.CUDAGraph` of `_program` with
  its static inputs (the bake buffers at the layout's sizes and `t0`) and
  its static output: every single-device window, live or served, copies
  its bake into those buffers, writes `t0`, replays and clones the audio
  out. A graph's programs capture into one memory pool, since their
  replays are serialized on one stream. A capture that fails raises,
  naming the vertex it was in; nothing falls back to eager. Graphs may
  render from several threads at once: one lock (`_PROGRAM_LOCK`) covers
  the cache's reads and writes and each warm-up and capture, which run on
  the card's one capture stream; other threads' uploads and replays go on
  beside a capture. On the CPU an
  entry runs the eager program over the same buffers. Deviation: the
  reference keys by a spec that compares equal across refreshes; here the
  graph's serial number stands for it, so entries never outlive their
  CompiledGraph (`release_chains`, called at refresh, drops them; a
  capture costs milliseconds where an XLA compile costs seconds), and a
  longer time table drops the entries keyed to the shorter one.
  A sharded entry over NCCL captures the window's collectives with its
  kernels, as the reference caches its jitted shard_map programs; over
  gloo (the CPU, or ranks sharing a card) it runs the eager program over
  its buffers, since a gloo collective is a host call no graph can hold.
  `render_window(..., eager=True)` and `render_window_sharded(...,
  eager=True)` run the eager program directly, for measurement;
* TERMDAW_EXACT_BIQUAD=1 is read once at build, as the reference does,
  and every window renders (and captures) under
  `filters.exact_biquad_scope` of that value, so the biquads run the
  exact sequential lane (`filters.biquad_apply_sequential`) or the
  parallel one;
* the frame -> seconds table (`time_table`, a correctly rounded f32
  division on the host) is uploaded once per size on the graph's device,
  at least as long as the render `seed_caps` was given (the reference's
  `_ttab_min_frames`), and gathered at the window's frames, for the
  synths' `time2d` and every envelope's in-block offsets `ib`;
* `render_window_sharded` (compile.py:1145-1247) renders a window with
  its block range split across the ranks of a mesh (parallel/mesh.py):
  every rank bakes the whole window on its host, live, slices the
  row-sharded bake fields (`_ROW_SHARDED`, compile.py:1175-1178) to its
  own block rows, copies only those into its cached program's inputs and
  runs `_program` on them at its
  global frame offset t0 + rank*T (`frames`, `time2d`, the SampleLoop
  slice, the SampleMulti begins); the Normalize, the band-pass and the
  effects take the mesh, so the numeric state after the window is the
  global stream's, equal on every rank. It stores no chain and returns
  this rank's audio.

Fused groups (every SampleMulti whose only consumer is the same vertex,
two or more per consumer) are formed on every device, so the CPU path
bakes the same tables as the card. A group mixes in one
`ops.voices.voice_mix_stereo` call, with each member's pan/gain folded
into its voices' amps; a lone SampleMulti makes the same call with equal
channel amps (compile.py:1709-1723 on the TPU).
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import functools
import gc
import itertools
import os
import threading
import time
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ..banks.flowwbank import FlowwBank

from . import bake as B
from . import graph as G
from ..ops import envelope, filters, fx, mix, sampler, scan, synthv, voices
from ..ops.filters import BandPassState
from ..utils import prof
from ..utils.prof import span
from ..utils.term import BLUE, DEFAULT

# kinds whose window kernels read absolute frames / the time table
_FRAME_KINDS = (G.SAMPLELERP, G.DEBUGSINE, G.SYNTH, G.SAMPSYN, G.ADSR)
_TIME_KINDS = (G.DEBUGSINE, G.SYNTH, G.SAMPSYN, G.ADSR)

# window programs: a bounded LRU, since each entry pins its CompiledGraph
# (samples, wavetables, state) and, on CUDA, its graph's memory pool
# (reference compile.py:124-175)
_PROGRAM_CACHE: dict = {}
_PROGRAM_CACHE_CAP = max(
    8, int(os.environ.get("TERMDAW_PROGRAM_CACHE", "128") or "128")
)
_GRAPH_SERIALS = itertools.count()
# held over every read-modify-write of the cache and over each capture
# (its warm-up included): graphs render from several threads, the cache
# is shared, and a card has one capture stream
_PROGRAM_LOCK = threading.RLock()


def _cache_get(key):
    with _PROGRAM_LOCK:
        fn = _PROGRAM_CACHE.get(key)
        if fn is not None:
            _PROGRAM_CACHE[key] = _PROGRAM_CACHE.pop(key)  # LRU: move to end
        return fn


def _cache_put(key, fn):
    with _PROGRAM_LOCK:
        _PROGRAM_CACHE[key] = fn
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_CAP:
            _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))


def _kernel_counts() -> dict[str, int]:
    """Each hand-written kernel's wrapper launch count."""
    return {"voice_mix": voices.launches, "affine_scan": scan.launches,
            "max_decay_scan": scan.max_decay_launches,
            "complex_scan": scan.complex_launches,
            "biquad_seq": filters.biquad_seq_launches,
            "sampsyn": synthv.sampsyn_launches, "eq3": fx.eq3_launches,
            "synth": synthv.synth_launches}


_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}
@functools.lru_cache(maxsize=1)
def _libcuda() -> ctypes.CDLL:
    """libcuda, CUDA's low-level API (a CUgraph is the runtime's
    cudaGraph_t)."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def _graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """The nodes of a captured graph, the kernels, copies and sets one
    replay launches, read once from its cudaGraph_t (kept by
    `keep_graph=True`) through libcuda's cuGraphGetNodes."""
    n = ctypes.c_size_t(0)
    rc = _libcuda().cuGraphGetNodes(graph.raw_cuda_graph(), None,
                                    ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"reading the captured graph's nodes: CUresult "
                           f"{rc}")
    return int(n.value)


def _arms(cg: "CompiledGraph") -> dict[str, int]:
    """The window program's vertex arms by kind (an effect's by its
    effect kind, "pluginfx.<kind>"; one under its wet gate as
    "pluginfx.skip"); a fused SampleMulti is mixed in its consumer's arm."""
    out: dict[str, int] = {}
    for vi in cg.order:
        if vi in cg._fused_members:
            continue
        st = cg.statics[vi]
        kind = st.kind
        if kind == G.PLUGINFX:
            kind = f"pluginfx.{'skip' if st.fx_skip else st.fx_kind}"
        out[kind] = out.get(kind, 0) + 1
    return dict(sorted(out.items()))


def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    """One side stream a card for captures (the legacy default stream
    cannot capture)."""
    s = _CAPTURE_STREAMS.get(dev.index)
    if s is None:
        s = _CAPTURE_STREAMS[dev.index] = torch.cuda.Stream(dev)
    return s


class _WindowProgram:
    """One cached window program: static inputs (the packed bake buffers
    at the layout's sizes and `t0`) and, on CUDA, the graph of
    CompiledGraph._program over them, captured at the first call (from
    the first window's inputs) into the CompiledGraph's memory pool, with
    its static output; on the CPU the
    eager program over the same buffers. Calling it runs the window with
    what was written into the inputs; a replay's audio is cloned out of
    the static output, which the next replay overwrites.

    Under a mesh it is this rank's part of a sharded window, and its
    collectives are part of the program: over NCCL they are captured with
    the kernels (the warm-up runs each once first, so NCCL's communicator
    is set up outside the capture). A gloo collective is a host call that
    no CUDA graph can hold, so over gloo the entry runs the eager program
    over its buffers, as on the CPU; `captured` says which, decided here
    from the backend. `collectives` is what one run issues: a replay adds
    it to the mesh's `collective_calls`."""

    def __init__(self, cg: "CompiledGraph", nb: int, is_scan: bool,
                 layout: tuple, mesh=None) -> None:
        dev = cg.device
        n_i, n_f = _layout_sizes(layout)
        self.cg = cg
        self.mesh = mesh
        self.captured = dev.type == "cuda" and (
            mesh is None or mesh.backend == "nccl")
        self.ints = torch.zeros(n_i, dtype=torch.int32, device=dev)
        self.floats = torch.zeros(n_f, dtype=torch.float32, device=dev)
        self.t0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.replays = 0
        self.collectives = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: torch.Tensor | None = None
        self.warmup_ms = self.capture_ms = 0.0
        self.pool_bytes = 0  # what its capture added to the graph's pool
        self.kernels: dict[str, int] = {}  # kernel launches captured
        # what one replay launches (the captured graph's nodes) and the
        # vertex arms it holds, read at capture
        self.nodes = 0
        self.arms: dict[str, int] = {}

        ints, floats, t0 = self.ints, self.floats, self.t0

        # no reference back to the program: a dropped program (and its
        # CUDAGraph) is freed at once, not by the cyclic collector at
        # some later moment, which could be inside another capture
        def run(write_state: bool = True) -> torch.Tensor:
            bakes = _unpack_bakes(ints, floats, layout)
            with filters.exact_biquad_scope(cg.exact_biquad):
                return cg._program(bakes, t0, nb, is_scan, mesh,
                                   write_state=write_state)

        self._run = run

    def _capture(self, dev: torch.device) -> None:
        """A warm-up of the program on the inputs written for the first
        window that leaves the state as it was (lazy initialisation, NCCL's
        communicator included, happens outside the capture), then the
        capture. A failure raises with the vertex the program was at. The
        warm-up's collectives ran and stay counted; the capture's did not
        run: they are taken off the mesh's counts and kept as
        `collectives`. The caller holds _PROGRAM_LOCK: captures share the
        card's capture stream and switch the collector, so they never
        overlap. The captured graph's `nodes` (read from the graph once)
        and `arms` are recorded here, and
        TERMDAW_TIMING prints them; no replay counts anything."""
        from .. import kernels

        kernels.load_all(dev)  # nothing may be built or loaded in capture
        stream, cur = _capture_stream(dev), torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        cg = self.cg
        if not any(p.graph is not None for p in cg.programs()):
            # a pool outlives its last graph only until its blocks are
            # freed, and cannot take another capture: a new pool
            cg._graph_pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(stream):
            t = time.perf_counter()
            self._run(write_state=False)
            stream.synchronize()
            self.warmup_ms = (time.perf_counter() - t) * 1e3
            reserved = torch.cuda.memory_reserved(dev)
            counts = _kernel_counts()
            mesh = self.mesh
            if mesh is not None:
                calls, calls_s = mesh.collective_calls, mesh.collective_s
            # kept until instantiated below, so its nodes can be read
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            # a CUDAGraph freed while a stream captures destroys its
            # executable, which voids the capture: no collection of
            # garbage (from any thread) may run until the capture ends
            collector_on = gc.isenabled()
            gc.disable()
            t = time.perf_counter()
            try:
                graph.capture_begin(pool=cg._graph_pool)
                try:
                    out = self._run()
                except BaseException as e:
                    try:
                        graph.capture_end()
                    except Exception:
                        pass  # the capture is void; its first error is raised
                    if not isinstance(e, Exception):
                        raise
                    vi, kind = cg._vertex_at
                    where = (f"vertex {cg.graph.names[vi]!r} ({kind})"
                             if vi is not None else kind)
                    raise RuntimeError(
                        f"capturing the window program failed in {where}: "
                        f"{e}") from e
                graph.capture_end()
                self.nodes = _graph_nodes(graph)
                graph.instantiate()
            finally:
                if collector_on:
                    gc.enable()
            self.capture_ms = (time.perf_counter() - t) * 1e3
            if mesh is not None:
                self.collectives = mesh.collective_calls - calls
                mesh.collective_calls, mesh.collective_s = calls, calls_s
        cur.wait_stream(stream)
        after = _kernel_counts()
        self.kernels = {k: after[k] - n for k, n in counts.items()
                        if after[k] > n}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        cg.pool_bytes += self.pool_bytes
        self.graph, self.out = graph, out
        self.arms = _arms(cg)
        if prof.TIMING:
            print(f"{DEFAULT}timing: window.capture = {BLUE}"
                  f"{self.capture_ms:.1f} ms{DEFAULT}, {BLUE}{self.nodes}"
                  f"{DEFAULT} nodes, arms {self.arms}")

    def __call__(self) -> torch.Tensor:
        mesh = self.mesh
        if not self.captured:
            calls = mesh.collective_calls if mesh is not None else 0
            out = self._run()
            if mesh is not None:
                self.collectives = mesh.collective_calls - calls
        else:
            if self.graph is None:
                with _PROGRAM_LOCK, span("window.capture") as sp:
                    self._capture(self.ints.device)
                    sp.attr("nodes", self.nodes)
                    sp.attr("arms", self.arms)
            self.graph.replay()
            if mesh is not None:
                mesh.collective_calls += self.collectives
            out = self.out.clone()
        self.replays += 1
        return out


def _layout_sizes(layout: tuple) -> tuple[int, int]:
    """The int32 and float32 buffer lengths `_pack_bakes` gives a layout
    (1 for an empty buffer)."""
    n = {"i": 1, "f": 1}
    for _vkey, _field, kind, off, shape in layout:
        n[kind] = max(n[kind], off + (int(np.prod(shape)) if shape else 1))
    return n["i"], n["f"]


def _state_pairs(dst, src, out: list) -> None:
    """(persistent leaf, new value) pairs of one state tree (a tensor, or
    dicts and tuples of them), walked along dst's structure."""
    if isinstance(dst, dict):
        if set(src) != set(dst):
            raise ValueError(f"state keys {sorted(src)} do not match "
                             f"{sorted(dst)}")
        for k in dst:
            _state_pairs(dst[k], src[k], out)
    elif isinstance(dst, tuple):
        if len(src) != len(dst):
            raise ValueError(f"{len(src)} state entries, expected "
                             f"{len(dst)}")
        for d, s in zip(dst, src):
            _state_pairs(d, s, out)
    elif src is not dst:
        if src.shape != dst.shape:
            raise ValueError(f"state shape {tuple(src.shape)}, expected "
                             f"{tuple(dst.shape)}")
        out.append((dst, src))


def _write_pairs(pairs: list) -> None:
    """Copy each new value into its persistent leaf. A value that shares
    storage with a leaf being written is cloned first, so no copy reads
    what an earlier one overwrote."""
    written = {d.untyped_storage().data_ptr() for d, _ in pairs}
    srcs = [s.clone() if s.untyped_storage().data_ptr() in written else s
            for _, s in pairs]
    for (d, _), s in zip(pairs, srcs):
        d.copy_(s)


def time_table(sr: int, n_frames: int) -> np.ndarray:
    """f32(i) / f32(sr) for i < n2, n2 the power of two >= n_frames (at
    least 4096): the reference's time = (t+i) as f32 / sr as f32, a TRUE
    f32 division (numpy's is correctly rounded), built on the host as the
    reference builds it (termdaw_tpu/graph/compile.py:187-198)."""
    n2 = 1 << max(12, (int(n_frames) - 1).bit_length())
    f = np.arange(n2, dtype=np.int64).astype(np.float32)
    return f / np.float32(sr)


def _pack_bakes(bakes: dict[str, dict[str, np.ndarray]]):
    """Pack every bake array into one int32 + one float32 buffer, so a
    window's tables are two host->device copies; the layout
    (offsets/shapes) says how to slice them back."""
    ints: list[np.ndarray] = []
    floats: list[np.ndarray] = []
    layout: list[tuple] = []
    i_off = f_off = 0
    for vkey in sorted(bakes):
        for field in sorted(bakes[vkey]):
            a = np.asarray(bakes[vkey][field])
            if a.dtype in (np.int32, np.dtype(np.int32)):
                layout.append((vkey, field, "i", i_off, a.shape))
                ints.append(a.reshape(-1))
                i_off += a.size
            else:
                layout.append((vkey, field, "f", f_off, a.shape))
                floats.append(a.reshape(-1).astype(np.float32))
                f_off += a.size
    ints_buf = np.concatenate(ints) if ints else np.zeros(1, np.int32)
    floats_buf = np.concatenate(floats) if floats else np.zeros(1, np.float32)
    return ints_buf, floats_buf, tuple(layout)


def _unpack_bakes(ints_buf: torch.Tensor, floats_buf: torch.Tensor, layout):
    """Views into the two uploaded buffers, one per (vertex, field)."""
    bakes: dict[str, dict[str, torch.Tensor]] = {}
    for vkey, field, kind, off, shape in layout:
        size = int(np.prod(shape)) if shape else 1
        buf = ints_buf if kind == "i" else floats_buf
        bakes.setdefault(vkey, {})[field] = buf[off:off + size].reshape(shape)
    return bakes


# bake fields with one row a block: a sharded window uploads only its own
# block rows of these; every other field (instances, segments) replicates
_ROW_SHARDED = frozenset({
    "idx", "begins", "vel", "member", "env_ads0", "env_rel0", "p_t0", "g_t0",
})


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _note_fill(bakes: dict[str, dict[str, np.ndarray]]) -> tuple[int, int]:
    """(slots, voices) of a window's polyphonic instance tables (the
    [nb, P] `idx` of SampleMulti, DebugSine, Synth and SampSyn bakes): nb
    x P each, and the entries that hold an instance (idx >= 0). A fused
    SampleMulti group's voice table is not an instance table."""
    slots = voices = 0
    for tbl in bakes.values():
        idx = tbl.get("idx")
        if idx is not None:
            slots += int(idx.size)
            voices += int(np.count_nonzero(idx >= 0))
    return slots, voices


# which vertex kinds carry host-side bake state, and their carry class
_CARRY_CLASSES: dict[str, type] = {
    G.SAMPLEMULTI: B.MultiCarry,
    G.SAMPLELERP: B.LerpCarry,
    G.DEBUGSINE: B.SineCarry,
    G.SYNTH: B.NotesCarry,
    G.SAMPSYN: B.NotesCarry,
    G.ADSR: B.AdsrCarry,
}

# each kind's fresh carry, compared against and never handed out; a carry
# of a kind missing here classifies unfresh forever (fail closed: no chain
# serves it)
_FRESH_CARRIES = {k: cls() for k, cls in _CARRY_CLASSES.items()}

# sticky bake-table caps across refreshes, keyed by (cap scope, vertex
# name, kind): a refresh that keeps a vertex keeps its table layouts
_CAP_HWM: dict[tuple, dict[str, int]] = {}


def _copy_carry(c):
    """A stored chain's own copy of a carry (carries are immutable values:
    every engine change rebinds, so this is defence in depth); unknown
    kinds are deep-copied."""
    if isinstance(c, B.MultiCarry):
        return B.MultiCarry(list(c.voices))
    if isinstance(c, B.SineCarry):
        return B.SineCarry(list(c.notes))
    if isinstance(c, B.NotesCarry):
        return B.NotesCarry([replace(n) for n in c.notes])
    if isinstance(c, (B.LerpCarry, B.AdsrCarry)):
        return replace(c)
    return copy.deepcopy(c)


def _caps_from_table(kind: str, tbl: dict) -> dict[str, int]:
    """Observed layout sizes of one baked table (the cap fields)."""
    if kind in (G.SAMPLEMULTI, G.DEBUGSINE, G.SYNTH, G.SAMPSYN):
        return {"p": int(tbl["idx"].shape[1]),
                "n": int(tbl["vels"].shape[0])}
    if kind == G.SAMPLELERP:
        return {"e": int(tbl["p_starts"].shape[0]),
                "b": int(tbl["bounds"].shape[0])}
    if kind == G.ADSR:
        return {"e": int(tbl["p_vel"].shape[0]),
                "b": int(tbl["bounds"].shape[0])}
    if kind == "fused":
        return {"pf": int(tbl["begins"].shape[1])}
    return {}


def _merge_caps(into: dict[str, int], new: dict[str, int]) -> None:
    for k, v in new.items():
        into[k] = max(into.get(k, 0), v)


def _port_value(v):
    """A value from the reference's bake carries rebuilt with the port's
    classes of the same name (graph/bake.py), recursively."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        cls = getattr(B, type(v).__name__)
        return cls(**{f.name: _port_value(getattr(v, f.name))
                      for f in dataclasses.fields(v)})
    if isinstance(v, list):
        return [_port_value(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_port_value(x) for x in v)
    return copy.deepcopy(v)


def _tree_to_device(v, like, dev: torch.device, where: str):
    """A reference effect state (dicts and tuples of arrays) as the port's
    tensors on `dev`, checked against the port's own state `like` for the
    same effect (keys, lengths, shapes)."""
    if isinstance(like, dict):
        if not isinstance(v, dict) or set(v) != set(like):
            raise ValueError(f"{where}: state keys {sorted(v)} do not match "
                             f"{sorted(like)}")
        return {k: _tree_to_device(v[k], like[k], dev, f"{where}.{k}")
                for k in like}
    if isinstance(like, tuple):
        if len(v) != len(like):
            raise ValueError(f"{where}: {len(v)} entries, expected "
                             f"{len(like)}")
        return tuple(_tree_to_device(a, b, dev, f"{where}[{i}]")
                     for i, (a, b) in enumerate(zip(v, like)))
    t = torch.tensor(np.asarray(v, np.float32), device=dev)
    if t.shape != like.shape:
        raise ValueError(f"{where}: shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    return t


@dataclass(frozen=True)
class _VertexStatic:
    """Per-vertex configuration resolved at build."""

    kind: str
    sample_pos: int | None = None      # position in self.samples
    sample_len: int = 0
    floww_index: int | None = None
    note: int | None = None
    lerp_len: int = 0
    confs: tuple = ()                  # AdsrConf tuple(s)
    osc_static: tuple = ()             # synth osc (vol, z) pairs
    use_off: bool = False
    use_max: bool = False
    pass_mode: bool = False
    lgamma: float = 0.0
    hgamma: float = 0.0
    wt_pos: int | None = None          # position in self.wavetables
    release_sec: float = 0.0           # synth-family note retention
    fx_kind: str = ""                  # key into ops.fx.EFFECTS
    fx_plugin_index: int = 0
    fx_static: tuple = ()              # ((name, value), ...) bound at build
    fx_skip: bool = False              # f32(wet) < 1e-4: the effect is off


class CompiledGraph:
    def __init__(
        self,
        graph: G.Graph,
        sample_bank,
        bl: int,
        *,
        device: torch.device,
        wavetables: dict[int, Any] | None = None,  # vertex -> WaveTable
        plugin_host=None,  # engine.plugins.PluginHost, for effect vertices
        cap_scope: str = "",
    ) -> None:
        self.graph = graph
        self.bl = bl
        self.sr = sr = graph.sr
        self.device = torch.device(device)
        # caps stay sticky across refreshes of one project (its working
        # dir), not across unrelated projects built in one process
        self.cap_scope = cap_scope
        self.order = graph.topo_order()
        self.in_edges = [list(e) for e in graph.in_edges]
        self.output = graph.output_vertex
        self.t = graph.t
        self.plugin_host = plugin_host
        dev = self.device

        # device-resident constants (one upload each)
        self.samples: list[torch.Tensor] = []
        self.samples_padded: dict = {}  # pos | ("fused", c) -> [2, Lpad]
        self.wavetables: list[tuple[torch.Tensor, torch.Tensor]] = []
        sample_pos: dict[int, int] = {}
        self.statics: dict[int, _VertexStatic] = {}
        for vi in self.order:
            v = graph.vertices[vi]
            kw: dict[str, Any] = {"kind": v.kind}
            p = v.params
            if v.kind in (G.SAMPLELOOP, G.SAMPLEMULTI, G.SAMPLELERP):
                si = p["sample_index"]
                sample = sample_bank.get_sample(si)
                if si not in sample_pos:
                    sample_pos[si] = len(self.samples)
                    self.samples.append(
                        torch.from_numpy(sample.as_array()).to(dev)
                    )
                kw["sample_pos"] = sample_pos[si]
                kw["sample_len"] = len(sample)
                if v.kind == G.SAMPLEMULTI and kw["sample_pos"] not in (
                    self.samples_padded
                ):
                    self.samples_padded[kw["sample_pos"]] = (
                        voices.make_padded_sample(
                            self.samples[kw["sample_pos"]], bl
                        )
                    )
            if v.kind in (
                G.SAMPLEMULTI, G.SAMPLELERP, G.DEBUGSINE, G.SYNTH,
                G.SAMPSYN, G.ADSR,
            ):
                kw["floww_index"] = p["floww_index"]
                kw["note"] = p.get("note")
            if v.kind == G.SAMPLELERP:
                kw["lerp_len"] = p["lerp_len"]
            if v.kind == G.SYNTH:
                kw["osc_static"] = (
                    (p["sq_vol"], p["sq_z"]),
                    (p["tf_vol"], p["tf_z"]),
                    (p["tr_vol"], 0.0),
                )
                kw["confs"] = (p["sq_conf"], p["tf_conf"], p["tr_conf"])
                # effective release (extensions.rs:469-477): max release_sec
                # over oscillators with volume > 0
                rel = 0.0
                if p["sq_vol"] > 0.0:
                    rel = p["sq_conf"].release_sec
                if p["tf_vol"] > 0.0:
                    rel = max(rel, p["tf_conf"].release_sec)
                if p["tr_vol"] > 0.0:
                    rel = max(rel, p["tr_conf"].release_sec)
                kw["release_sec"] = rel
            if v.kind == G.SAMPSYN:
                kw["confs"] = (p["conf"],)
                kw["release_sec"] = p["conf"].release_sec
                wt = wavetables[vi]
                kw["wt_pos"] = len(self.wavetables)
                self.wavetables.append((
                    torch.from_numpy(np.asarray(wt.times, np.float32)).to(dev),
                    torch.from_numpy(
                        np.ascontiguousarray(wt.waves, np.float32)
                    ).to(dev),
                ))
            if v.kind == G.ADSR:
                kw["confs"] = (p["conf"],)
                kw["use_off"] = p["use_off"]
                kw["use_max"] = p["use_max"]
            if v.kind == G.BANDPASS:
                kw["pass_mode"] = p["pass_mode"]
                kw["lgamma"] = filters.gamma_from_cutoff(p["cut_low"], sr)
                kw["hgamma"] = filters.gamma_from_cutoff(p["cut_high"], sr)
            if v.kind == G.PLUGINFX:
                plug = plugin_host.get(p["plugin_index"])
                kw["fx_plugin_index"] = p["plugin_index"]
                kw["fx_kind"] = plug.effect.kind
                kw["fx_skip"] = bool(np.float32(v.wet) < np.float32(1e-4))
                # static params (delay-line lengths, biquad coefs) bind
                # here; changing one takes a rebuild at refresh
                kw["fx_static"] = tuple(sorted(fx.static_values(
                    plug.effect, plugin_host.param_values(p["plugin_index"])
                ).items()))
            self.statics[vi] = _VertexStatic(**kw)
        # read once at build (reference compile.py:297); every window
        # renders under exact_biquad_scope of it
        self.exact_biquad = filters.exact_biquad_env()
        kinds = {st.kind for st in self.statics.values()}
        self._uses_frames = bool(kinds.intersection(_FRAME_KINDS))
        self._uses_time = bool(kinds.intersection(_TIME_KINDS))
        self._ttab: torch.Tensor | None = None  # see _time_table
        self._ttab_min_frames = 0  # the longest render seed_caps was given
        # device constants the window program reads, built here: inside a
        # capture nothing may be uploaded (band-pass gammas; each effect's
        # static values with its device constants, fx.bind_static)
        self._bp_gammas = {
            vi: filters.band_pass_gammas(st.lgamma, st.hgamma, dev)
            for vi, st in self.statics.items() if st.kind == G.BANDPASS}
        self._fx_static = {
            vi: fx.bind_static(fx.EFFECTS[st.fx_kind], sr,
                               dict(st.fx_static), dev)
            for vi, st in self.statics.items()
            if st.kind == G.PLUGINFX and not st.fx_skip}
        # the traced effect params: one persistent f32 vector in a layout
        # fixed per graph, (vertex key, name, position) sorted by name,
        # static params left out (reference compile.py:1113-1142)
        slots = []
        for vi in self.order:
            st = self.statics[vi]
            if st.kind == G.PLUGINFX:
                skip = fx.EFFECTS[st.fx_kind].static_params
                for name in sorted(plugin_host.param_values(
                        st.fx_plugin_index)):
                    if name not in skip:
                        slots.append((vi, st.fx_plugin_index, name))
        self._fx_layout = tuple((str(vi), name, i)
                                for i, (vi, _, name) in enumerate(slots))
        self._fx_slots = tuple((idx, name) for _, idx, name in slots)
        self._fx_vec = torch.zeros(len(slots), dtype=torch.float32,
                                   device=dev)
        self._fx_params: dict[str, dict[str, torch.Tensor]] = {}
        for vkey, name, i in self._fx_layout:
            self._fx_params.setdefault(vkey, {})[name] = self._fx_vec[i]
        self._fx_version: int | None = None  # PluginHost.version packed

        # fused SampleMulti groups: all SAMPLEMULTI vertices whose ONLY
        # consumer is the same vertex mix in one voice-mix call at that
        # consumer (extensions.rs:343-381 semantics; the order of the
        # input sum inside a group commutes up to f32 rounding)
        consumers: dict[int, list[int]] = {vi: [] for vi in self.order}
        for vi in self.order:
            for j in self.in_edges[vi]:
                consumers[j].append(vi)
        cand: dict[int, list[int]] = {}
        for vi in self.order:
            if (
                self.statics[vi].kind == G.SAMPLEMULTI
                and vi != self.output
                and len(consumers[vi]) == 1
            ):
                cand.setdefault(consumers[vi][0], []).append(vi)
        self.fused_groups: dict[int, tuple[int, ...]] = {
            c: tuple(ms) for c, ms in cand.items() if len(ms) >= 2
        }
        self._fused_members = frozenset(
            m for ms in self.fused_groups.values() for m in ms
        )
        # per-group concat-buffer layout: unique sample positions in member
        # order, each segment's base offset within the concatenated buffer
        self._fused_layout: dict[int, tuple[tuple[int, ...], dict[int, int]]] = {}
        self._fused_ids: dict[int, torch.Tensor] = {}
        for c, ms in self.fused_groups.items():
            poses: list[int] = []
            for m in ms:
                p = self.statics[m].sample_pos
                if p not in poses:
                    poses.append(p)
            bases, off = {}, 0
            for p in poses:
                bases[p] = off
                off += int(self.samples_padded[p].shape[1])
            self._fused_layout[c] = (tuple(poses), bases)
            self._fused_ids[c] = torch.tensor(ms, dtype=torch.long, device=dev)
            if len(poses) > 1:
                self.samples_padded[("fused", c)] = torch.cat(
                    [self.samples_padded[p] for p in poses], dim=1
                )

        # per-vertex gain/angle/wet, indexed by vertex id
        self._gains = torch.tensor(
            [v.gain for v in graph.vertices], dtype=torch.float32, device=dev
        )
        self._angles = torch.tensor(
            [v.angle for v in graph.vertices], dtype=torch.float32, device=dev
        )
        self._wets = torch.tensor(
            [v.wet for v in graph.vertices], dtype=torch.float32, device=dev
        )

        # leads the program-cache key in place of the reference's spec
        # (compile.py:429-439): the programs read this graph's tensors, so
        # they are never shared with another graph
        self.serial = next(_GRAPH_SERIALS)
        # the memory pool this graph's programs capture into (on CUDA, made
        # at a capture when none of its cached programs holds a graph)
        self._graph_pool = None
        # the vertex the program is at, for a failed capture's message
        self._vertex_at: tuple = (None, "the window's set-up")

        # numeric device state + host bake carries
        self.num_state: dict[str, torch.Tensor] = {}
        self.carries: dict[int, Any] = {}
        for vi in self.order:
            st = self.statics[vi]
            if st.kind == G.NORMALIZE:
                self.num_state[f"{vi}.max"] = self._scalar(0.0)
                self.num_state[f"{vi}.scan_max"] = self._scalar(0.0)
            elif st.kind == G.BANDPASS:
                self.num_state[f"{vi}.bp"] = BandPassState.init(dev)
            elif st.kind == G.PLUGINFX:
                self.num_state[f"{vi}.fx"] = fx.EFFECTS[st.fx_kind].init_state(
                    sr, dict(st.fx_static), dev
                )
            elif st.kind in _CARRY_CLASSES:
                self.carries[vi] = _CARRY_CLASSES[st.kind]()
        # freshness index: vi is in _unfresh iff carries[vi] differs from
        # its kind's fresh carry; kept exact at every carry assignment
        self._unfresh: set[int] = set()
        self._rebuild_unfresh()
        self._lerp_vis = tuple(vi for vi in self.order
                               if self.statics[vi].kind == G.SAMPLELERP)

        # per-vertex bake-table caps: tables pad to these, seeded from
        # _CAP_HWM, raised by seed_caps()'s walk of the full schedule and
        # on overflow. TERMDAW_VOICE_CAP=n instead hard-caps per-block
        # polyphony with oldest-voice steal (reference compile.py:494-513)
        vc = os.environ.get("TERMDAW_VOICE_CAP", "")
        self.voice_cap = int(vc) if vc.isdigit() and int(vc) > 0 else None
        self.bake_caps: dict[str, dict[str, int]] = {}
        for vi in self.order:
            hw = _CAP_HWM.get((cap_scope, graph.names[vi],
                               self.statics[vi].kind))
            if hw:
                self.bake_caps[str(vi)] = dict(hw)
        for c in self.fused_groups:
            hw = _CAP_HWM.get((cap_scope, graph.names[c], "fused"))
            if hw:
                self.bake_caps[f"fused{c}"] = dict(hw)
        self._seeded_sigs: set[tuple] = set()

        # the prebaked chain (seed_caps pass 2) and recorded chains, served
        # by render_window for an unchanged schedule and carry lineage
        self._prebake_on = os.environ.get("TERMDAW_PREBAKE", "1") == "1"
        self._prebake_budget = float(
            os.environ.get("TERMDAW_PREBAKE_MB", "256")) * 1e6
        self._prebaked: dict | None = None
        self._recorded: list[dict] = []
        self._rec_active: dict | None = None
        self._prebake_used = 0
        # counts for measurement: windows served from a chain, host bakes
        # of render windows (seed_caps' walks are not counted), windows
        # rendered sharded across ranks, window programs made for the cache
        # (a capture on CUDA) and windows run through a cached program (a
        # replay on CUDA), with the device nodes those replays launched
        # (each program's `nodes`, counted at its capture); the bytes the
        # captures added to the graph's pool; the slots of the windows'
        # polyphonic instance tables and the voices that filled them
        # (`_note_fill`, counted at the bake, kept with a chain's window)
        self.served_windows = 0
        self.live_bakes = 0
        self.sharded_windows = 0
        self.captures = 0
        self.replays = 0
        self.replayed_nodes = 0
        self.pool_bytes = 0
        self.note_slots = 0
        self.note_voices = 0
        # per-fused-group pooled event arrays, keyed by FlowwBank version
        self._pool_cache: dict[int, tuple] = {}
        # per-(consumer, member) processed event arrays, keyed by the
        # member's events array identity (see _group_pool)
        self._member_pool_cache: dict[tuple[int, int], tuple] = {}
        # per-consumer sample_len/base vectors (see _fused_member_vecs)
        self._fused_vecs: dict[int, tuple] = {}

    def _scalar(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def _time_table(self, n_frames: int) -> torch.Tensor:
        """The device copy of time_table(sr, n), n the larger of n_frames
        and the render seed_caps was given, uploaded once per size (a
        longer table has the shorter one as its prefix). A longer table
        drops this graph's programs that read the shorter one: their key
        is never looked up again."""
        n_frames = max(n_frames, self._ttab_min_frames)
        if self._ttab is None or self._ttab.shape[0] < n_frames:
            self._ttab = torch.from_numpy(
                time_table(self.sr, n_frames)
            ).to(self.device)
            # single-device and sharded keys both end in the length
            self._drop_programs(lambda key: key[-1] != 0)
        return self._ttab

    def _record_caps(self, key: str, name_key: tuple, kind: str,
                     tbl) -> None:
        caps = self.bake_caps.setdefault(key, {})
        _merge_caps(caps, _caps_from_table(kind, tbl))
        if self.voice_cap is not None and "p" in caps:
            caps["p"] = min(caps["p"], self.voice_cap)
        _CAP_HWM[name_key] = dict(caps)

    def _upload(self, bakes):
        """The packed bake buffers of a window, uploaded to the graph's
        device: (ints, floats, layout)."""
        ints_buf, floats_buf, layout = _pack_bakes(bakes)
        return (*self._upload_packed(ints_buf, floats_buf), layout)

    def _upload_packed(self, ints_buf: np.ndarray, floats_buf: np.ndarray):
        return (torch.from_numpy(ints_buf).to(self.device),
                torch.from_numpy(floats_buf).to(self.device))

    def seed_caps(self, fb: FlowwBank, total_blocks: int, step: int,
                  prebake: bool | None = None) -> None:
        """Pre-bake the full known event schedule over the render window
        grid and pin every bake-table cap at the observed maxima, so every
        window of the render gets one table layout (pass 1). Pass 2 (unless
        TERMDAW_PREBAKE=0 or `prebake=False`) bakes the same grid again
        with the pinned caps and stores each window's uploaded buffers and
        carry delta as the prebaked chain that render_window serves, as
        far as the byte budget reaches. `prebake=False` is for a render
        that takes the sharded path, which bakes live: its chain could
        never be served (reference compile.py:584-619). Host numpy,
        proportional to event count; idempotent; leaves graph and floww
        state untouched. Also sizes the time table to the whole render,
        whose length is part of the program key (reference
        compile.py:600-608)."""
        with span("seed caps"):
            if total_blocks > 0:
                self._ttab_min_frames = max(self._ttab_min_frames,
                                            total_blocks * self.bl)
            if total_blocks <= 0 or not self.carries:
                return
            do_prebake = self._prebake_on and prebake is not False
            # do_prebake rides the sig: a schedule first seeded for the sharded
            # path must still build its chain when a single-device render
            # asks for one
            sig = (fb.uid, fb.version, total_blocks, step, do_prebake)
            if sig in self._seeded_sigs:
                return  # schedule unchanged since the last seed
            saved_frame = fb.frame
            fb.set_time(0)
            try:
                carries = {vi: _CARRY_CLASSES[self.statics[vi].kind]()
                           for vi in self.carries}
                t, left = 0, total_blocks
                while left > 0:
                    nb = min(left, step)
                    _, nc = self._bake_all(fb, t, nb, carries=carries)
                    carries.update(nc)
                    fb.advance_blocks(nb)
                    t += nb * self.bl
                    left -= nb
                if do_prebake:
                    self._prebake_chain(fb, total_blocks, step)
            finally:
                # an interrupt mid-seed must not leave the bank's cursor
                # desynced from graph time
                fb.set_time(saved_frame)
            self._seeded_sigs.add(sig)

    def _prebake_chain(self, fb: FlowwBank, total_blocks: int,
                       step: int) -> None:
        """seed_caps pass 2 (reference compile.py:641-694): from fresh
        carries, bake the grid with the pinned caps and keep each window's
        uploaded buffers, layout and sparse carry delta. A window is kept,
        and its bytes counted, only if they fit the budget shared with the
        recorded chains; the first that does not fit ends the chain."""
        fb.set_time(0)
        carries = {vi: _CARRY_CLASSES[self.statics[vi].kind]()
                   for vi in self.carries}
        # release the old seed chain's share before building its successor
        if self._prebaked is not None:
            self._prebake_used -= self._prebaked["bytes"]
            self._prebaked = None
        index: dict[tuple, int] = {}
        wins: list[tuple] = []
        t, left, used = 0, total_blocks, 0
        while left > 0:
            nb = min(left, step)
            bakes, nc = self._bake_all(fb, t, nb, carries=carries)
            ints, floats, layout = self._upload(bakes)
            nbytes = _nbytes(ints, floats)
            if self._prebake_used + used + nbytes > self._prebake_budget:
                break
            used += nbytes
            index[(t, fb.frame, nb)] = len(wins)
            # the carry delta against the window's start state: lineage
            # guarantees the live carries equal that state at serve time
            delta = {vi: c for vi, c in nc.items() if c != carries.get(vi)}
            wins.append((ints, floats, layout, delta,
                         *self._classify_delta(delta), _note_fill(bakes)))
            carries = dict(carries)
            carries.update(nc)
            fb.advance_blocks(nb)
            t += nb * self.bl
            left -= nb
        self._prebake_used += used
        self._prebaked = {"bank": (fb.uid, fb.version), "index": index,
                          "wins": wins, "expect": None, "bytes": used}

    # -- the freshness index and the chains (reference compile.py:702-913)
    def _classify_carry(self, vi: int, c) -> None:
        """Keep _unfresh exact at an assignment of carries[vi]; a kind
        missing from _FRESH_CARRIES classifies unfresh forever."""
        f = _FRESH_CARRIES.get(self.statics[vi].kind)
        if f is None or c != f:
            self._unfresh.add(vi)
        else:
            self._unfresh.discard(vi)

    def _rebuild_unfresh(self) -> None:
        self._unfresh.clear()
        for vi, c in self.carries.items():
            self._classify_carry(vi, c)

    def _classify_delta(self, delta: dict) -> tuple:
        """A stored carry delta's (fresh set, unfresh set, copy-on-serve
        set), computed when the chain is built so serving applies it with
        set operations."""
        fresh, unfresh, copies = set(), set(), set()
        for vi, c in delta.items():
            f = _FRESH_CARRIES.get(self.statics[vi].kind)
            if f is not None and c == f:
                fresh.add(vi)
            else:
                unfresh.add(vi)
            if not isinstance(c, (B.MultiCarry, B.SineCarry, B.LerpCarry,
                                  B.AdsrCarry, B.NotesCarry)):
                copies.add(vi)  # unknown kinds only
        return frozenset(fresh), frozenset(unfresh), frozenset(copies)

    def _apply_carries(self, new_carries: dict) -> None:
        """Bind new carries and keep the freshness index exact."""
        for vi, c in new_carries.items():
            self.carries[vi] = c
            self._classify_carry(vi, c)

    def _carries_fresh(self) -> bool:
        return not self._unfresh

    def _carries_equal(self, snapshot: dict,
                       snap_unfresh: frozenset) -> bool:
        """Live carries == snapshot: with the snapshot's unfresh set only
        the unfresh entries need comparing (an entry fresh on both sides
        is equal)."""
        if self._unfresh != snap_unfresh:
            return False
        return all(self.carries[vi] == snapshot[vi] for vi in self._unfresh)

    def _prebake_take(self, fb: FlowwBank, t0: int, nb: int):
        """A window served from the prebaked or a recorded chain when the
        schedule (bank uid and version), the window's grid position and
        the carry lineage all match, else None. Lineage: the previous
        window was served from the same chain, or this is the chain's
        window 0 and the live carries equal its start state (fresh for
        the seed chain, a snapshot for a recorded one)."""
        if not self._prebake_on:
            return None
        bank = (fb.uid, fb.version)
        key = (t0, fb.frame, nb)
        chains = [self._prebaked] if self._prebaked is not None else []
        chains += list(reversed(self._recorded))  # newest first
        for ch in chains:
            if ch["bank"] != bank:
                continue
            i = ch["index"].get(key)
            if i is None:
                continue
            if ch["expect"] != i:
                if i != 0:
                    continue
                start = ch.get("start")
                ok = (self._carries_fresh() if start is None else
                      self._carries_equal(start, ch["start_unfresh"]))
                if not ok:
                    continue
            ints, floats, layout, delta, fresh_d, unfresh_d, copy_vis, \
                fill = ch["wins"][i]
            ch["expect"] = i + 1
            if copy_vis:
                delta = {vi: (_copy_carry(c) if vi in copy_vis else c)
                         for vi, c in delta.items()}
            return ints, floats, layout, delta, fresh_d, unfresh_d, fill
        return None

    _REC_MAX = 4       # recorded chains kept (LRU)
    _REC_MIN_NB = 64   # only render-scale windows are worth recording

    def _record_window(self, fb: FlowwBank, t0: int, nb: int,
                       ints: np.ndarray, floats: np.ndarray, layout,
                       new_carries, fill: tuple[int, int]) -> None:
        """Record one live-baked window (its packed host buffers, uploaded
        here if kept, and its `_note_fill`) into the active recording
        chain, started with a snapshot of the carries before the window.
        Called before self.carries is updated."""
        if not self._prebake_on or nb < self._REC_MIN_NB:
            return
        used = ints.nbytes + floats.nbytes  # int32 / float32 on the device
        if self._prebake_used + used > self._prebake_budget:
            self._rec_finish()
            return
        bank = (fb.uid, fb.version)
        rec = self._rec_active
        if (rec is None or rec["bank"] != bank
                or rec["next"] != (t0, fb.frame)):
            self._rec_finish()
            # a version bump never reverts: chains of older bank versions
            # can never serve again, so they stop holding device memory
            for r in [r for r in self._recorded if r["bank"] != bank]:
                self._recorded.remove(r)
                self._prebake_used -= r["bytes"]
            rec = self._rec_active = {
                "bank": bank,
                "start": {vi: _copy_carry(c)
                          for vi, c in self.carries.items()},
                "start_unfresh": frozenset(self._unfresh),
                "index": {}, "wins": [], "expect": None, "bytes": 0,
            }
        delta = {vi: _copy_carry(c) for vi, c in new_carries.items()
                 if c != self.carries.get(vi)}
        rec["index"][(t0, fb.frame, nb)] = len(rec["wins"])
        rec["wins"].append((*self._upload_packed(ints, floats), layout,
                            delta, *self._classify_delta(delta), fill))
        rec["next"] = (t0 + nb * self.bl, fb.frame + nb * self.bl)
        rec["bytes"] += used
        self._prebake_used += used

    def _rec_finish(self) -> None:
        """Archive the active recording, if it captured anything."""
        rec = self._rec_active
        self._rec_active = None
        if rec and rec["wins"]:
            rec.pop("next", None)
            self._recorded.append(rec)
            while len(self._recorded) > self._REC_MAX:
                self._prebake_used -= self._recorded.pop(0)["bytes"]

    def _reset_chain_expects(self) -> None:
        """A live-baked window left every chain's lineage: only a window-0
        re-entry may serve now."""
        if self._prebaked is not None:
            self._prebaked["expect"] = None
        for rec in self._recorded:
            rec["expect"] = None

    def _break_prebake_chain(self) -> None:
        """An external state change (a seek): reset chain lineage and
        close the active recording."""
        self._reset_chain_expects()
        self._rec_finish()

    def release_chains(self) -> None:
        """Drop every prebaked and recorded chain, their device buffers
        included, and this graph's window programs (called on the graph a
        refresh replaces)."""
        self._prebaked = None
        self._recorded.clear()
        self._rec_active = None
        self._prebake_used = 0
        self._seeded_sigs.clear()  # a future seed must rebuild
        self._drop_programs(lambda key: True)
        self._graph_pool = None
        self.pool_bytes = 0

    def _drop_programs(self, which) -> None:
        """Drop this graph's program-cache entries whose key `which`
        selects."""
        with _PROGRAM_LOCK:
            for key in [k for k, p in _PROGRAM_CACHE.items()
                        if p.cg is self and which(k)]:
                del _PROGRAM_CACHE[key]

    def programs(self) -> list[_WindowProgram]:
        """This graph's entries of the program cache, oldest use first."""
        with _PROGRAM_LOCK:
            return [p for p in _PROGRAM_CACHE.values() if p.cg is self]

    def load_reference_state(
        self, num_state: dict[str, np.ndarray], carries: dict, t: int
    ) -> None:
        """Take over a render mid-timeline from the JAX reference: its
        CompiledGraph's `num_state` (arrays, a BandPassState per band-pass
        and an effect state pytree per effect), its carries and its time.
        Both graphs must come from the same project."""
        if set(num_state) != set(self.num_state):
            raise ValueError(
                f"num_state keys {sorted(num_state)} do not match this "
                f"graph's {sorted(self.num_state)}"
            )
        if set(carries) != set(self.carries):
            raise ValueError(
                f"carried vertices {sorted(carries)} do not match this "
                f"graph's {sorted(self.carries)}"
            )
        dev = self.device
        pairs: list = []
        for k, v in num_state.items():
            if k.endswith(".bp"):
                new = BandPassState(
                    prevs=torch.tensor(np.asarray(v.prevs, np.float32),
                                       device=dev),
                    first=torch.tensor(bool(np.asarray(v.first)),
                                       device=dev),
                )
            elif k.endswith(".fx"):
                new = _tree_to_device(v, self.num_state[k], dev, k)
            else:
                new = torch.tensor(np.asarray(v, np.float32), device=dev)
            _state_pairs(self.num_state[k], new, pairs)
        _write_pairs(pairs)  # into the persistent buffers
        for vi, c in carries.items():
            cls = _CARRY_CLASSES[self.statics[vi].kind]
            port = _port_value(c)
            if not isinstance(port, cls):
                raise ValueError(f"vertex {vi}: carry {type(c).__name__} is "
                                 f"not a {cls.__name__}")
            self.carries[vi] = port
        self._rebuild_unfresh()
        self.t = t
        self.graph.t = t
        self._break_prebake_chain()

    def _pack_fx(self) -> dict[str, dict[str, torch.Tensor]]:
        """Traced effect parameters as the per-vertex dicts of 0-d views
        of the graph's one f32 vector that the effects take. At each
        PluginHost.version the current values are copied into the vector
        (one upload), so every program reading it sees them; the layout is
        fixed per graph (reference compile.py:1113-1142)."""
        ver = self.plugin_host.version if self._fx_slots else None
        if ver != self._fx_version:
            pv = {}
            vals = []
            for idx, name in self._fx_slots:
                if idx not in pv:
                    pv[idx] = self.plugin_host.param_values(idx)
                vals.append(float(pv[idx][name]))
            self._fx_vec.copy_(torch.tensor(vals, dtype=torch.float32))
            self._fx_version = ver
        return self._fx_params

    # -- normalization controls (reference graph.rs:195-220) ---------------
    def _normalize_vis(self):
        return [vi for vi in self.order
                if self.statics[vi].kind == G.NORMALIZE]

    def reset_normalize_vertices(self) -> None:
        for vi in self._normalize_vis():
            self.num_state[f"{vi}.max"].fill_(1e-6)

    def reset_scan_normalize_vertices(self) -> None:
        for vi in self._normalize_vis():
            self.num_state[f"{vi}.scan_max"].fill_(0.0)

    def apply_scan_normalize_vertices(self) -> None:
        for vi in self._normalize_vis():
            self.num_state[f"{vi}.max"].copy_(self.num_state[f"{vi}.scan_max"])

    def get_normalization_values(self) -> list[tuple[str, float]]:
        return [
            (self.graph.names[vi], float(self.num_state[f"{vi}.max"]))
            for vi in self._normalize_vis()
        ]

    # -- time control -------------------------------------------------------
    def set_time(self, t: int) -> None:
        """Reference extensions.rs:196-204 partial reset: clear DebugSine
        and Synth notes, re-prime BandPass; SampleMulti/SampleLerp/SampSyn
        voice clocks keep their elapsed time (absolute frames remapped).
        Adsr cell clocks are time-relative values and carry through. Every
        branch is a no-op on a fresh carry but the SampleLerp remap, so
        only unfresh carries and SampleLerps are visited; each change
        rebinds (carries are immutable values) and keeps _unfresh exact.
        Breaks every chain's lineage."""
        dt = t - self.t
        for vi in self._unfresh.union(self._lerp_vis):
            carry = self.carries[vi]
            kind = self.statics[vi].kind
            if kind in (G.DEBUGSINE, G.SYNTH):
                if carry.notes:
                    self.carries[vi] = type(carry)()
                    self._unfresh.discard(vi)
            elif kind == G.SAMPLEMULTI:
                if carry.voices:  # stays unfresh (still non-empty)
                    self.carries[vi] = B.MultiCarry(
                        [(s + dt, v) for s, v in carry.voices]
                    )
            elif kind == G.SAMPLELERP:
                c = replace(
                    carry,
                    primary_start=carry.primary_start + dt,
                    ghost_start=carry.ghost_start + dt,
                )
                self.carries[vi] = c
                self._classify_carry(vi, c)
            elif kind == G.SAMPSYN and carry.notes:
                self.carries[vi] = B.NotesCarry([
                    replace(
                        n,
                        on_f=n.on_f + dt,
                        off_f=None if n.off_f is None else n.off_f + dt,
                        dead_f=(n.dead_f + dt if n.dead_f < B.INF_FRAME
                                else n.dead_f),
                    )
                    for n in carry.notes
                ])
        for vi in self.order:
            if self.statics[vi].kind == G.BANDPASS:
                bp = self.num_state[f"{vi}.bp"]
                bp.prevs.zero_()
                bp.first.fill_(True)
        self.t = t
        self.graph.t = t
        self._break_prebake_chain()

    def change_time(self, delta: int, plus: bool) -> int:
        new_t = self.t + delta if plus else self.t - min(delta, self.t)
        self.set_time(new_t)
        return new_t

    def get_time(self) -> int:
        return self.t

    # -- rendering ----------------------------------------------------------
    def render_window(
        self, fb: FlowwBank, nb: int, is_scan: bool = False,
        eager: bool = False,
    ) -> torch.Tensor:
        """Render `nb` blocks starting at the current graph time. The floww
        bank cursor must already sit at the same frame (the engine aligns
        them). Advances graph time and all carried state. Returns device
        audio [nb*bl, 2].

        A window on a chain's grid with the chain's schedule and carry
        lineage is served from it (its stored device buffers, no bake and
        no upload); any other is baked live, and recorded when it is
        render-sized. Either way its buffers are copied into the inputs of
        the window program `_get_fn` finds, which runs it (reference
        compile.py:1016-1071). `eager` runs the eager program on them
        instead, outside the cache: for measurement, and for profiles that
        synchronize inside the program."""
        with span("window") as sp:
            t0 = self.t
            served = self._prebake_take(fb, t0, nb)
            sp.attr("nb", nb)
            sp.attr("served", served is not None)
            if served is not None:
                ints, floats, layout, new_carries, fresh_d, unfresh_d, \
                    fill = served
                self.served_windows += 1
            else:
                with span("window.bake"):
                    self._reset_chain_expects()
                    bakes, new_carries = self._bake_all(fb, t0, nb)
                    ints, floats, layout = _pack_bakes(bakes)
                    fill = _note_fill(bakes)
                    self.live_bakes += 1
                    self._record_window(fb, t0, nb, ints, floats, layout,
                                        new_carries, fill)
                    ints = torch.from_numpy(ints)
                    floats = torch.from_numpy(floats)
            self.note_slots += fill[0]
            self.note_voices += fill[1]
            self._pack_fx()
            ttab_len = int(self._time_table(t0 + nb * self.bl).shape[0]) \
                if self._uses_time else 0
            if eager:
                audio = self._run_eager(ints, floats, layout, t0, nb, is_scan)
            else:
                audio = self._run_cached(
                    self._get_fn(nb, is_scan, layout, ttab_len), ints,
                    floats, t0)
            if served is None:
                self._apply_carries(new_carries)
            else:
                # the served delta's classification was computed at build
                self.carries.update(new_carries)
                self._unfresh.difference_update(fresh_d)
                self._unfresh.update(unfresh_d)
            self.t = t0 + nb * self.bl
            self.graph.t = self.t
            return audio

    def window_cost(self, fb: FlowwBank, nb: int,
                    is_scan: bool = False) -> dict:
        """The work of the window program `render_window(fb, nb, is_scan)`
        would run at the current time, counted op by op
        (utils/roofline.count_work; reference compile.py:1073-1111, which
        read XLA's cost analysis): {"flops", "bytes accessed", "_mem":
        {arg_bytes, out_bytes, temp_bytes[, peak_bytes]}, "ops" (per aten
        op or kernel: [calls, flops, bytes]), "source"}. The window is
        baked live and its eager program run once over uploaded buffers
        with `write_state=False`, so the state it would write back is not
        in `out_bytes`. `peak_bytes`, on the card only: the captured
        program of the window's key, its pool bytes and static inputs.

        Advances neither the graph's time nor the floww bank's, and leaves
        the numeric state, the carries, the chains, the bake caps, the
        counters and the program cache as they were: a time table longer
        than the graph's is made for this count alone."""
        from ..utils.roofline import count_work

        t0 = self.t
        caps = {k: dict(v) for k, v in self.bake_caps.items()}
        hwm = dict(_CAP_HWM)
        try:
            bakes, _ = self._bake_all(fb, t0, nb)
        finally:
            self.bake_caps.clear()
            self.bake_caps.update(caps)
            _CAP_HWM.clear()
            _CAP_HWM.update(hwm)
        ints, floats, layout = _pack_bakes(bakes)
        ints, floats = self._upload_packed(ints, floats)
        self._pack_fx()
        ttab = self._ttab
        ttab_len = 0
        if self._uses_time:
            need = max(t0 + nb * self.bl, self._ttab_min_frames)
            if ttab is None or ttab.shape[0] < need:
                self._ttab = torch.from_numpy(
                    time_table(self.sr, need)).to(self.device)
            ttab_len = int(self._ttab.shape[0])
        t0_dev = torch.full((), t0, dtype=torch.int64, device=self.device)
        try:
            with filters.exact_biquad_scope(self.exact_biquad), \
                    count_work() as work:
                audio = self._program(_unpack_bakes(ints, floats, layout),
                                      t0_dev, nb, is_scan, write_state=False)
        finally:
            self._ttab = ttab
        mem = work.memory(audio)
        p = _PROGRAM_CACHE.get((self.serial, nb, is_scan, layout, ttab_len))
        if p is not None and p.graph is not None:
            mem["peak_bytes"] = p.pool_bytes + _nbytes(p.ints, p.floats,
                                                       p.t0)
        return {"flops": work.flops, "bytes accessed": work.bytes,
                "_mem": mem, "ops": work.ops,
                "source": "torch_dispatch_count"}

    def render_window_sharded(self, fb: FlowwBank, nb_total: int, mesh,
                              is_scan: bool = False,
                              eager: bool = False) -> torch.Tensor:
        """Render `nb_total` blocks from the current graph time with the
        block range split across the ranks of `mesh` (nb_total a multiple
        of the world size): this rank renders its nb_total/n blocks and
        returns their audio [nb_total/n*bl, 2]. Every rank bakes the whole
        window live (the same carries follow on every rank) and copies its
        own rows of the row-sharded fields and all of the others into the
        inputs of the program `_get_fn` finds for this rank's layout, which
        runs it (reference compile.py:1197-1225; every rank reaches a key's
        first window at the same window, so the ranks capture in
        lockstep). `eager` runs the eager program on them instead, outside
        the cache. Advances graph time and all carried state; breaks every
        chain's lineage."""
        n = mesh.size
        if nb_total % n != 0:
            raise ValueError(f"render_window_sharded: nb_total {nb_total} "
                             f"not divisible by {n} ranks")
        nb = nb_total // n
        t0 = self.t
        bakes, new_carries = self._bake_all(fb, t0, nb_total)
        self.live_bakes += 1
        lo, hi = mesh.rank * nb, (mesh.rank + 1) * nb
        mine = {vkey: {f: (a[lo:hi] if f in _ROW_SHARDED else a)
                       for f, a in tbl.items()}
                for vkey, tbl in bakes.items()}
        ints, floats, layout = _pack_bakes(mine)
        slots, voices_ = _note_fill(mine)
        self.note_slots += slots
        self.note_voices += voices_
        ints, floats = torch.from_numpy(ints), torch.from_numpy(floats)
        self._pack_fx()
        ttab_len = int(self._time_table(t0 + nb_total * self.bl).shape[0]) \
            if self._uses_time else 0
        if eager:
            audio = self._run_eager(ints, floats, layout, t0, nb, is_scan,
                                    mesh)
        else:
            audio = self._run_cached(
                self._get_fn(nb, is_scan, layout, ttab_len, mesh), ints,
                floats, t0)
        self._apply_carries(new_carries)
        self.t = t0 + nb_total * self.bl
        self.graph.t = self.t
        self._break_prebake_chain()  # sharded windows bake live
        self.sharded_windows += 1
        return audio

    def _bake_all(
        self, fb: FlowwBank, t0: int, nb: int,
        carries: dict[int, Any] | None = None,
    ):
        """Host-side event baking for a window. Each fused group's
        per-vertex voices merge into one COMPACT voice table (only voices
        that intersect each block), so the kernel's work is proportional
        to live voices. Table shapes pad to the sticky `bake_caps`
        (raised here on overflow). Under TERMDAW_VOICE_CAP the voice
        tables' `p` is clamped to the cap and overflow steals the oldest
        voices (reference compile.py:1263-1296)."""
        carries = self.carries if carries is None else carries
        bakes: dict[str, dict[str, np.ndarray]] = {}
        new_carries: dict[int, Any] = {}
        steal = self.voice_cap is not None
        names = self.graph.names
        t1 = t0 + nb * self.bl
        for vi, carry in carries.items():
            if vi in self._fused_members:
                continue  # baked per GROUP below
            st = self.statics[vi]
            key = str(vi)
            caps = self.bake_caps.get(key)
            if steal:
                caps = dict(caps or {})
                caps["p"] = min(caps.get("p", self.voice_cap),
                                self.voice_cap)
            tbl, nc = self._bake_vertex(fb, st, carry, t0, nb, caps, steal)
            bakes[key] = tbl
            new_carries[vi] = nc
            self._record_caps(key, (self.cap_scope, names[vi], st.kind),
                              st.kind, tbl)
        for consumer, members in self.fused_groups.items():
            voices_, group_carries = self._bake_fused_group(
                fb, consumer, members, t0, t1, carries
            )
            new_carries.update(group_carries)
            tbl = self._merge_group(voices_, consumer, members, t0, nb)
            bakes[f"fused{consumer}"] = tbl
            self._record_caps(f"fused{consumer}",
                              (self.cap_scope, names[consumer], "fused"),
                              "fused", tbl)
        return bakes, new_carries

    def _bake_vertex(self, fb: FlowwBank, st: _VertexStatic, carry,
                     t0: int, nb: int, caps, steal: bool):
        """One event vertex's window table and end carry (graph/bake.py)."""
        bl, sr = self.bl, self.sr
        if st.kind in (G.DEBUGSINE, G.SYNTH, G.SAMPSYN) or (
            st.kind == G.ADSR and st.use_off
        ):
            simple = fb.bake_simple(st.floww_index, nb)
            if st.kind == G.DEBUGSINE:
                return B.bake_debug_sine(simple, carry, t0, nb, bl, caps,
                                         steal)
            if st.kind == G.ADSR:
                return B.bake_adsr_off(simple, carry, st.confs[0], sr, t0,
                                       nb, bl, st.note, caps)
            return B.bake_notes(simple, carry, t0, nb, bl, sr,
                                st.release_sec, caps, steal)
        drum = fb.bake_drum(st.floww_index, nb).filter_note(st.note)
        if st.kind == G.SAMPLEMULTI:
            return B.bake_sample_multi(drum, carry, t0, nb, bl,
                                       st.sample_len, caps, steal)
        if st.kind == G.SAMPLELERP:
            return B.bake_sample_lerp(drum, carry, t0, nb, bl, st.lerp_len,
                                      caps)
        return B.bake_adsr_drum(drum, carry, t0, nb, bl, sr, caps)

    def _group_pool(self, fb: FlowwBank, consumer: int, members):
        """Frame-sorted pooled event arrays (frames, vels, member-id) for a
        fused group, cached per FlowwBank content version.

        Valid only when every member floww is time-sorted: then the drum
        cursor semantics reduce to "events with frame in the window"
        (banks/flowwbank.bake_drum's sorted fast path), so one pooled
        searchsorted replaces per-member replays. Per-member quirks bake
        into the pool: ON filtering, first-ON-per-frame dedupe (BEFORE the
        note filter — a same-frame other-note hit swallows the slot,
        reference floww.rs:99-121 + extensions.rs:353-356), then the
        consumer's note filter."""
        cached = self._pool_cache.get(consumer)
        if cached is not None and cached[0] == (fb.uid, fb.version):
            return cached[1]
        fl, vl, ml = [], [], []
        for mi, m in enumerate(members):
            st = self.statics[m]
            i = st.floww_index
            if i >= len(fb.flowws):
                continue
            if not fb._frames_sorted(i):
                self._pool_cache[consumer] = ((fb.uid, fb.version), None)
                return None
            ev = fb.flowws[i]
            # per-member memo keyed on the events array IDENTITY: a live
            # feed replaces only the fed streams' arrays
            memo = self._member_pool_cache.get((consumer, mi))
            if memo is not None and memo[0] is ev:
                f, v = memo[1], memo[2]
            else:
                f = fb._event_frames(i)
                on = ev[:, 3] > 0.001
                f, n, v = f[on], ev[on, 2], ev[on, 3]
                keep = np.ones(len(f), bool)
                if len(f) > 1:
                    keep[1:] = f[1:] != f[:-1]
                f, n, v = f[keep], n[keep], v[keep]
                if st.note is not None:
                    nf = np.abs(n - np.float32(st.note)) < 0.01
                    f, v = f[nf], v[nf]
                v = v.astype(np.float32)
                self._member_pool_cache[(consumer, mi)] = (ev, f, v)
            fl.append(f)
            vl.append(v)
            ml.append(np.full(len(f), mi, np.int32))
        if fl:
            f = np.concatenate(fl)
            order = np.argsort(f, kind="stable")
            pool = (
                f[order],
                np.concatenate(vl)[order],
                np.concatenate(ml)[order],
            )
        else:
            pool = (
                np.zeros(0, np.int64), np.zeros(0, np.float32),
                np.zeros(0, np.int32),
            )
        self._pool_cache[consumer] = ((fb.uid, fb.version), pool)
        return pool

    def _bake_fused_group(
        self, fb: FlowwBank, consumer: int, members, t0: int, t1: int,
        carries,
    ):
        """Window voice arrays (starts, vels, member-id) + new carries for
        one fused group, in member-major order (each member: carry voices
        then window events chronologically — the same slot order as the
        per-vertex formulation)."""
        pool = self._group_pool(fb, consumer, members)
        if pool is not None:
            # drum windows anchor at the floww cursor (the engine keeps it
            # aligned with graph time t0)
            pf, pv, pm = pool
            lo = int(np.searchsorted(pf, fb.frame, "left"))
            hi = int(np.searchsorted(pf, fb.frame + (t1 - t0), "left"))
            wf, wv, wm = pf[lo:hi], pv[lo:hi], pm[lo:hi]
            order = np.argsort(wm, kind="stable")  # member-major
            wf, wv, wm = wf[order], wv[order], wm[order]
        else:  # unsorted floww(s): per-member replay fallback
            fl, vl, ml = [], [], []
            for mi, m in enumerate(members):
                st = self.statics[m]
                drum = fb.bake_drum(
                    st.floww_index, (t1 - t0) // self.bl
                ).filter_note(st.note)
                fl.append(drum.frames)
                vl.append(drum.vels.astype(np.float32))
                ml.append(np.full(len(drum.frames), mi, np.int32))
            wf = np.concatenate(fl) if fl else np.zeros(0, np.int64)
            wv = np.concatenate(vl) if vl else np.zeros(0, np.float32)
            wm = np.concatenate(ml) if ml else np.zeros(0, np.int32)
        # prepend each member's carry voices (list order) ahead of its
        # window events: a stable argsort by member id on [all carries |
        # all window events] keeps every member's carries before its window
        # events and preserves intra-segment order
        carry_f: list[np.ndarray] = []
        carry_v: list[np.ndarray] = []
        carry_m: list[np.ndarray] = []
        for mi, m in enumerate(members):
            cvs = carries[m].voices
            if cvs:
                carry_f.append(np.asarray([x[0] for x in cvs], np.int64))
                carry_v.append(np.asarray([x[1] for x in cvs], np.float32))
                carry_m.append(np.full(len(cvs), mi, np.int32))
        wf = wf.astype(np.int64, copy=False)
        wm = wm.astype(np.int32, copy=False)
        if carry_f:
            af = np.concatenate(carry_f + [wf])
            av = np.concatenate(carry_v + [wv])
            am = np.concatenate(carry_m + [wm])
            order = np.argsort(am, kind="stable")
            af, av, am = af[order], av[order], am[order]
        else:
            af, av, am = wf, wv, wm
        slen_vec, _ = self._fused_member_vecs(consumer, members)
        new_carries: dict[int, Any] = {m: B.MultiCarry() for m in members}
        alive = np.nonzero(af + slen_vec[am] > t1)[0]
        if len(alive):
            am_a, af_a, av_a = am[alive], af[alive], av[alive]
            uniq, first = np.unique(am_a, return_index=True)
            bounds = np.append(first, len(am_a))
            for j, u in enumerate(uniq):
                sl = slice(int(bounds[j]), int(bounds[j + 1]))
                new_carries[members[int(u)]] = B.MultiCarry([
                    (int(s), float(v))
                    for s, v in zip(af_a[sl], av_a[sl])
                ])
        return (af, av, am), new_carries

    def _fused_member_vecs(self, consumer: int, members):
        """Per-member sample_len / concat-buffer base offsets as vectors,
        built once per group."""
        v = self._fused_vecs.get(consumer)
        if v is None:
            _, bases = self._fused_layout[consumer]
            v = (
                np.asarray(
                    [self.statics[m].sample_len for m in members], np.int64
                ),
                np.asarray(
                    [bases[self.statics[m].sample_pos] for m in members],
                    np.int64,
                ),
            )
            self._fused_vecs[consumer] = v
        return v

    def _merge_group(self, voices_, consumer: int, members, t0: int, nb: int):
        """Compact merged voice table for one fused group (host numpy).

        Emits begins [nb, Pf] in concat-buffer coords, vel [nb, Pf] and
        member [nb, Pf] (index into `members`), keeping only voices whose
        sample span intersects the block; Pf is the cap-pinned max live
        count. Exact: dropped slots read zeros / have vel 0. Slot order per
        block = member order, then trigger order within a member."""
        bl = self.bl
        caps = self.bake_caps.get(f"fused{consumer}") or {}
        starts, vels, mid = voices_

        def empty():
            w = max(caps.get("pf", 1), 1)
            return {
                "begins": np.zeros((nb, w), np.int32),
                "vel": np.zeros((nb, w), np.float32),
                "member": np.zeros((nb, w), np.int32),
            }

        V = len(starts)
        if V == 0:
            return empty()
        slen_vec, base_vec = self._fused_member_vecs(consumer, members)
        slen = slen_vec[mid]
        base = base_vec[mid]
        block_starts = t0 + np.arange(nb, dtype=np.int64) * bl
        # active blocks per voice as segmented ranges, O(active pairs).
        # Voice p is live in block k iff
        # starts[p] < b0 + bl and b0 < starts[p] + slen[p], b0 = t0+k*bl.
        starts = starts.astype(np.int64, copy=False)
        k0 = np.maximum(0, -(-(starts - bl + 1 - t0) // bl))
        k1 = np.minimum(nb - 1, (starts + slen - 1 - t0) // bl)
        cnt = np.clip(k1 - k0 + 1, 0, None)
        total = int(cnt.sum())
        if not total:
            return empty()
        pp = np.repeat(np.arange(V), cnt)
        seg0 = np.cumsum(cnt) - cnt
        kk = k0[pp] + (np.arange(total, dtype=np.int64)
                       - np.repeat(seg0, cnt))
        # block-major order with voice order preserved within a block
        order = np.argsort(kk, kind="stable")
        kk, pp = kk[order], pp[order]
        if self.voice_cap is not None:
            # TERMDAW_VOICE_CAP applies per member vertex, as the block
            # table's oldest-voice steal: within each (block, member) only
            # the newest voice_cap voices stay. (kk, pp) is block-major
            # with pp in member-major trigger order, so the (block, member)
            # key is sorted and the newest sit last
            gkey = kk * len(members) + mid[pp].astype(np.int64)
            first = np.searchsorted(gkey, gkey, "left")
            last = np.searchsorted(gkey, gkey, "right")
            keep = np.arange(len(kk)) - first >= (last - first) - \
                self.voice_cap
            kk, pp = kk[keep], pp[keep]
        b = np.clip(
            block_starts[kk] - starts[pp] + bl, 0, slen[pp] + bl
        ) + base[pp]
        counts = np.bincount(kk, minlength=nb)
        pf = B._capped(int(counts.max()), caps.get("pf"))
        pos = np.arange(len(kk)) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        begins = np.zeros((nb, pf), np.int32)
        vel = np.zeros((nb, pf), np.float32)
        member = np.zeros((nb, pf), np.int32)
        begins[kk, pos] = b
        vel[kk, pos] = vels[pp]
        member[kk, pos] = mid[pp]
        return {"begins": begins, "vel": vel, "member": member}

    # -- the window program ---------------------------------------------------
    def _get_fn(self, nb: int, is_scan: bool, layout: tuple, ttab_len: int,
                mesh=None) -> _WindowProgram:
        """The cached program of this window shape, made (captured on
        CUDA) on first use (reference compile.py:1584-1604); under a mesh,
        this rank's program of a sharded window of nb * mesh.size blocks,
        keyed by the layout of its own rows (reference compile.py:1207).
        Every key ends in the time table's length (`_time_table`'s drop
        reads key[-1])."""
        # the effect-parameter layout and the biquad lane, in the
        # reference's key, are fixed per graph here
        if mesh is None:
            key = (self.serial, nb, is_scan, layout, ttab_len)
        else:
            key = (self.serial, "sharded", nb * mesh.size, is_scan,
                   mesh.size, layout, ttab_len)
        with _PROGRAM_LOCK:
            fn = _cache_get(key)
            if fn is None:
                fn = _WindowProgram(self, nb, is_scan, layout, mesh)
                _cache_put(key, fn)
                self.captures += 1
        return fn

    def _run_eager(self, ints: torch.Tensor, floats: torch.Tensor, layout,
                   t0: int, nb: int, is_scan: bool,
                   mesh=None) -> torch.Tensor:
        """The eager program on a window's bake buffers, outside the
        cache."""
        with filters.exact_biquad_scope(self.exact_biquad):
            return self._program(_unpack_bakes(
                ints.to(self.device), floats.to(self.device), layout), t0,
                nb, is_scan, mesh)

    def _run_cached(self, fn: _WindowProgram, ints: torch.Tensor,
                    floats: torch.Tensor, t0: int) -> torch.Tensor:
        """Copy a window's bake buffers and first frame into a program's
        inputs and run it."""
        fn.ints.copy_(ints)
        fn.floats.copy_(floats)
        fn.t0.fill_(t0)
        audio = fn()
        self.replays += 1
        self.replayed_nodes += fn.nodes
        return audio

    def _fused_mix(self, consumer: int, bakes, nb: int) -> torch.Tensor:
        """One voice-mix call for a whole SampleMulti group: per-vertex
        pan/gain folds into per-voice channel amps; members over different
        samples read one concatenated padded buffer."""
        poses, _bases = self._fused_layout[consumer]
        buf = self.samples_padded[
            poses[0] if len(poses) == 1 else ("fused", consumer)
        ]
        tbl = bakes[f"fused{consumer}"]
        ids = self._fused_ids[consumer]
        amps = mix.post_amps(self._angles[ids], self._gains[ids])  # [V, 2]
        member = tbl["member"].long()
        return voices.voice_mix_stereo(
            buf,
            tbl["begins"],
            tbl["vel"] * amps[member, 0],
            tbl["vel"] * amps[member, 1],
            nb, self.bl,
        )

    def _program(self, bakes, t0, nb: int, is_scan: bool, mesh=None,
                 write_state: bool = True) -> torch.Tensor:
        """The window program over nb blocks from graph time t0 (a Python
        int or a 0-d int64 tensor); under a mesh, this rank's nb blocks of
        the window, from the global frame t0 + rank*nb*bl
        (compile.py:1641-1656). Reads only device inputs: the time table
        must already cover the window (`_time_table`) and the effect
        params be packed (`_pack_fx`). Writes the new numeric state into
        `num_state`'s tensors at its end, unless `write_state` is False
        (a capture's warm-up)."""
        bl = self.bl
        T = nb * bl
        self._vertex_at = (None, "the window's set-up")
        tf = t0 if mesh is None else t0 + mesh.rank * T  # first frame
        bufs: dict[int, torch.Tensor] = {}
        ns = dict(self.num_state)
        fx_params = self._fx_params
        if self._uses_frames:
            frames = tf + torch.arange(T, dtype=torch.int64,
                                       device=self.device)
        if self._uses_time:
            # gathered at the window's frames: the same values as a slice
            # at a host offset, with the offset on the device
            time2d = self._ttab[frames].reshape(nb, bl)
            ib = self._ttab[:bl]  # f32(i)/f32(sr), i in block
        for vi in self.order:
            st = self.statics[vi]
            kind = st.kind
            if vi in self._fused_members:
                continue  # mixed at the consumer
            self._vertex_at = (vi, kind)
            ins = []
            for j in self.in_edges[vi]:
                if j in self._fused_members:
                    if j == self.fused_groups[vi][0]:
                        ins.append(self._fused_mix(vi, bakes, nb))
                    continue
                ins.append(bufs[j])
            if G.HAS_INPUT[kind]:
                x = mix.sum_inputs(ins) if ins else torch.zeros(
                    (T, 2), dtype=torch.float32, device=self.device
                )
            key = str(vi)

            if kind == G.SUM:
                out = x
            elif kind == G.NORMALIZE:
                xr = x.reshape(nb, bl, 2)
                if is_scan:
                    outr, ns[f"{vi}.scan_max"] = mix.normalize_scan(
                        xr, ns[f"{vi}.max"], ns[f"{vi}.scan_max"], mesh
                    )
                else:
                    outr, ns[f"{vi}.max"] = mix.normalize_live(
                        xr, ns[f"{vi}.max"], mesh
                    )
                out = outr.reshape(T, 2)
            elif kind == G.SAMPLELOOP:
                out = sampler.sample_loop(self.samples[st.sample_pos], tf, T)
            elif kind == G.SAMPLEMULTI:
                begins, vels = voices.compute_begin_vel(
                    bakes[key], tf, nb, bl, st.sample_len
                )
                out = voices.voice_mix_stereo(
                    self.samples_padded[st.sample_pos], begins, vels, vels,
                    nb, bl,
                )
            elif kind == G.SAMPLELERP:
                out = sampler.sample_lerp(
                    self.samples[st.sample_pos], bakes[key], frames,
                    st.lerp_len,
                )
            elif kind == G.DEBUGSINE:
                out = synthv.debug_sine(bakes[key], frames, nb, bl, time2d)
            elif kind == G.SYNTH:
                (sqv, sqz), (tfv, tfz), (trv, _) = st.osc_static
                sqc, tfc, trc = st.confs
                out = synthv.synth(
                    bakes[key], frames, nb, bl, sqv, sqz, sqc, tfv, tfz, tfc,
                    trv, trc, time2d, ib,
                )
            elif kind == G.SAMPSYN:
                times, waves = self.wavetables[st.wt_pos]
                out = synthv.sampsyn(bakes[key], frames, nb, bl, st.confs[0],
                                     times, waves, ib)
            elif kind == G.ADSR:
                out = envelope.adsr_apply(
                    x, bakes[key], frames, st.confs[0], st.use_off,
                    st.use_max, self._wets[vi], ib,
                )
            elif kind == G.BANDPASS:
                out, ns[f"{vi}.bp"] = filters.band_pass_timeline(
                    x, ns[f"{vi}.bp"], st.lgamma, st.hgamma, st.pass_mode,
                    self._wets[vi], mesh, g=self._bp_gammas[vi],
                )
            elif st.fx_skip:  # G.PLUGINFX with wet < 1e-4
                out = x  # the input passes, the state stays as it was
            else:  # G.PLUGINFX
                y, ns[f"{vi}.fx"] = fx.EFFECTS[st.fx_kind].process(
                    x, ns[f"{vi}.fx"], fx_params.get(key, {}), self.sr,
                    self._fx_static[vi], mesh,
                )
                out = x + self._wets[vi] * (y - x)
            bufs[vi] = mix.post(out, self._angles[vi], self._gains[vi])
        self._vertex_at = (None, "the state write-back")
        if write_state:
            pairs: list = []
            for k, leaf in self.num_state.items():
                _state_pairs(leaf, ns[k], pairs)
            _write_pairs(pairs)
        return bufs[self.output]
