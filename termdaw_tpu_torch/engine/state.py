"""Session State: the Lua -> engine bridge, refresh/diff, render, scan.

Port of termdaw_tpu/engine/state.py (reference state.rs:27-577). The Lua
glue (`_refresh_inner`: the ~23 project-API globals, resource diffs,
graph rebuild) is carried over unchanged; what differs:

* `State(config, wdir, device=...)` renders on an explicit torch.device;
  nothing falls back to another device;
* the compile step builds the port's CompiledGraph, which renders every
  vertex kind, the native effects (engine/plugins.py, ops/fx.py) among
  them; the replaced graph's chains are released first and caps stay
  sticky per project dir (`cap_scope`), as in the reference;
* there is no backend guard: renders run on the State's device, in
  windows of `render_chunk_blocks(cs)` blocks, traced into
  TERMDAW_PROFILE's dir when it is set (utils/prof.device_trace);
* `render_device` returns device int tensors, which `render` copies to
  the host for the WAV writer;
* timeline sharding (state.py:527-593, 670-693): a State handed a Mesh
  of more than one rank (parallel/mesh.py: one process a rank, each with
  a State of the same project on its own device) splits each window's
  block range of a render or a normalization scan across the ranks,
  unless TERMDAW_MESH=0. The reference finds its devices itself; here
  the caller (the CLI under a launcher, or a `launch`ed function) owns
  the process group and passes its Mesh, so no State shards just
  because a group exists (`_mesh_plan`, `_pick_nb`, `_render_window_auto`;
  windows of max(n, 512 - 512 % n) blocks, no chain stored). The window
  left over at the end is rendered by every rank alone, so the states
  stay equal. Rank 0 gathers the audio, resamples and quantizes it once
  and writes the WAV; the other ranks return no chunks.

Documented deviations of the reference kept here: render aligns the
floww cursor to the graph time at start; a resource/graph build failure
aborts the refresh with a message; render down-sampling is the exact
polyphase resampler (ops/resample.py); relative asset/output paths
resolve against the project dir.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..fileio.wav import WavWriter
from ..fileio.wavetable import WaveTable, parse_wavetable_from_buffer
from ..lua import LuaRuntime, LuaError, LuaTable
from ..utils.prof import device_trace, span
from ..utils.term import DEFAULT, BLUE, YELLOW, RED, GREEN

from ..banks import SampleBank, FlowwBank, BufferBank, SampleLoadMethod
from ..device import resolve_device
from ..graph import Graph, VertexDecl, CompiledGraph
from ..graph import graph as G
from ..ops.adsr import build_adsr_conf
from ..ops.quantize import quantize_interleave_many
from ..ops.resample import StreamingResampler
from ..parallel.mesh import Mesh, gather
from .plugins import PluginHost, AddPluginError

# blocks per window when rendering long timelines (bounds peak memory;
# windows chain exactly through carried state)
RENDER_WINDOW_BLOCKS = 512
_MIN_EQUAL_CHUNK = 256


def render_chunk_blocks(cs: int) -> int:
    """Window size (in blocks) for chunked renders: the largest divisor of
    `cs` in [_MIN_EQUAL_CHUNK, RENDER_WINDOW_BLOCKS] (equal windows, one
    table layout), else RENDER_WINDOW_BLOCKS with a ragged last window.
    Chunk boundaries are invisible in the output."""
    for d in range(min(cs, RENDER_WINDOW_BLOCKS), _MIN_EQUAL_CHUNK - 1, -1):
        if cs % d == 0:
            return d
    return RENDER_WINDOW_BLOCKS


def _floats(v) -> list[float]:
    """Lua {…} table -> float list (ADSR configs, doc.md:91-94)."""
    if isinstance(v, LuaTable):
        return [float(x) for x in v.array_items()]
    if v is None:
        return []
    return [float(x) for x in v]


class RefreshAbort(Exception):
    pass


class State:
    def __init__(self, config: Config, wdir: str,
                 device: str | torch.device, mesh: Mesh | None = None) -> None:
        psr = config.settings.project_samplerate
        bl = config.settings.buffer_length
        self.device = resolve_device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"State on {self.device}, its mesh's rank "
                             f"renders on {mesh.device}")
        # this rank's view of the ranks a render shards over (None: one
        # device)
        self.mesh = mesh
        self.config = config
        self.wdir = wdir
        self.lua = LuaRuntime()
        self.sb = SampleBank(psr)
        self.g = Graph(bl, psr)
        self.host = PluginHost()
        self.fb = FlowwBank(psr, bl)
        self.bb = BufferBank()
        self.contents = ""
        self.loaded = False
        self.cs = 0
        self.render_sr = 48000       # defaults per reference main.rs:89-92
        self.bd = 16
        self.output_vertex = ""
        self.output_file = "outp.wav"
        self.cur_samples: list[tuple] = []
        self.cur_resources: list[tuple] = []
        self.cur_lv2plugins: list[tuple] = []
        self.cur_lv2params: list[tuple] = []
        self.compiled: CompiledGraph | None = None

    def _resolve(self, file: str) -> str:
        """Project-dir-relative path resolution (documented deviation)."""
        p = Path(file)
        return str(p) if p.is_absolute() else str(Path(self.wdir) / p)

    # ------------------------------------------------------------------ refresh
    def refresh(self) -> None:
        self.loaded = False
        try:
            with span("refresh"):
                self._refresh_inner()
        except RefreshAbort:
            return

    def _refresh_inner(self) -> None:
        psr = self.config.settings.project_samplerate
        bl = self.config.settings.buffer_length

        main_path = Path(self.wdir) / self.config.settings.main
        try:
            self.contents = main_path.read_text()
        except OSError as e:
            print(f"{RED}Can't open main lua file!{DEFAULT}\n\t{e}")
            raise RefreshAbort from None

        new_samples: list[tuple] = []
        new_resources: list[tuple] = []
        new_lv2plugins: list[tuple] = []
        new_lv2params: list[tuple] = []
        midis: list[tuple] = []
        inline_flowws: list[tuple] = []
        streams: list[str] = []
        sums: list[tuple] = []
        norms: list[tuple] = []
        sampleloops: list[tuple] = []
        samplemultis: list[tuple] = []
        samplelerps: list[tuple] = []
        debugsines: list[tuple] = []
        synths: list[tuple] = []
        sampsyns: list[tuple] = []
        lv2fxs: list[tuple] = []
        adsrs: list[tuple] = []
        bandpasses: list[tuple] = []
        edges: list[tuple] = []
        scalars = {
            "cs": self.cs, "render_sr": self.render_sr, "bd": self.bd,
            "output_file": self.output_file,
            "output_vertex": self.output_vertex,
        }

        # ---- project API globals (reference state.rs:83-159) -----------
        lua = self.lua

        def seed(name, vec, conv=lambda a: a):
            def handler(*a, _name=name, _vec=vec, _conv=conv):
                try:
                    item = _conv(a)
                except (TypeError, ValueError, IndexError) as e:
                    # name the failing API call instead of surfacing a
                    # bare "IndexError: tuple index out of range"
                    raise LuaError(
                        f"bad arguments to '{_name}' ({e})"
                    ) from None
                _vec.append(item)

            lua.set_global(name, handler)

        lua.set_global(
            "set_length",
            lambda seconds: scalars.__setitem__(
                "cs", int(np.ceil(psr * float(seconds) / bl))
            ),
        )
        lua.set_global(
            "set_render_samplerate",
            lambda sr: scalars.__setitem__("render_sr", int(sr)),
        )
        lua.set_global(
            "set_render_bitdepth",
            lambda b: scalars.__setitem__("bd", int(b)),
        )
        lua.set_global(
            "set_output_file",
            lambda f: scalars.__setitem__("output_file", str(f)),
        )
        seed("load_sample", new_samples,
             lambda a: (str(a[0]), str(a[1]), str(a[2])))
        seed("load_resource", new_resources, lambda a: (str(a[0]), str(a[1])))
        seed("load_midi_floww", midis, lambda a: (str(a[0]), str(a[1])))

        def _inline_floww(a):
            # extension beyond the reference API (its flowws come only
            # from MIDI files or streams, state.rs:240-250): declare an
            # event pattern directly from Lua as { {t_sec, note, vel01},
            # ... } (optional 4th element = channel), enabling generative
            # scores with no external files. vel 0 is a note-off, like
            # the MIDI path (fileio/midi.py read_floww_from_midi).
            name, tbl = str(a[0]), a[1]
            rows = []
            for item in tbl.array_items():
                vals = item.array_items()
                ch = float(vals[3]) if len(vals) > 3 else 0.0
                rows.append(
                    (ch, float(vals[0]), float(vals[1]), float(vals[2]))
                )
            rows.sort(key=lambda r: r[1])  # bank fast paths want t sorted
            events = np.asarray(rows, np.float32).reshape(-1, 4)
            return (name, events)

        seed("declare_floww", inline_flowws, _inline_floww)
        lua.set_global("declare_stream", lambda name: streams.append(str(name)))
        seed("load_lv2", new_lv2plugins, lambda a: (str(a[0]), str(a[1])))
        seed("parameter", new_lv2params,
             lambda a: (str(a[0]), str(a[1]), float(a[2])))
        seed("add_sum", sums, lambda a: (str(a[0]), float(a[1]), float(a[2])))
        seed("add_normalize", norms,
             lambda a: (str(a[0]), float(a[1]), float(a[2])))
        seed("add_sampleloop", sampleloops,
             lambda a: (str(a[0]), float(a[1]), float(a[2]), str(a[3])))
        seed("add_sample_multi", samplemultis,
             lambda a: (str(a[0]), float(a[1]), float(a[2]), str(a[3]),
                        str(a[4]), int(a[5])))
        seed("add_sample_lerp", samplelerps,
             lambda a: (str(a[0]), float(a[1]), float(a[2]), str(a[3]),
                        str(a[4]), int(a[5]), int(a[6])))
        seed("add_debug_sine", debugsines,
             lambda a: (str(a[0]), float(a[1]), float(a[2]), str(a[3])))
        seed("add_synth", synths,
             lambda a: (str(a[0]), float(a[1]), float(a[2]), str(a[3]),
                        float(a[4]), float(a[5]), _floats(a[6]),
                        float(a[7]), float(a[8]), _floats(a[9]),
                        float(a[10]), _floats(a[11])))
        seed("add_sampsyn", sampsyns,
             lambda a: (str(a[0]), float(a[1]), float(a[2]), str(a[3]),
                        _floats(a[4]), str(a[5])))
        seed("add_lv2fx", lv2fxs,
             lambda a: (str(a[0]), float(a[1]), float(a[2]), float(a[3]),
                        str(a[4])))
        seed("add_adsr", adsrs,
             lambda a: (str(a[0]), float(a[1]), float(a[2]), float(a[3]),
                        str(a[4]), bool(a[5]), bool(a[6]), int(a[7]),
                        _floats(a[8])))
        seed("add_bandpass", bandpasses,
             lambda a: (str(a[0]), float(a[1]), float(a[2]), float(a[3]),
                        float(a[4]), float(a[5]), bool(a[6])))
        seed("connect", edges, lambda a: (str(a[0]), str(a[1])))
        lua.set_global(
            "set_output",
            lambda out: scalars.__setitem__("output_vertex", str(out)),
        )

        try:
            lua.execute(self.contents)
        except LuaError as e:
            print(f"{RED}Could not execute lua code!{DEFAULT}\n\t{e}")
            raise RefreshAbort from None

        self.cs = scalars["cs"]
        self.bd = scalars["bd"]
        self.render_sr = scalars["render_sr"]
        self.output_file = scalars["output_file"]
        self.output_vertex = scalars["output_vertex"]

        def diff(old: list, new: list) -> tuple[list, list]:
            adds = [t for t in new if t not in old]
            removes = [t for t in old if t not in new]
            return adds, removes

        # ---- samples (state.rs:202-219) ----------------------------------
        pos, neg = diff(self.cur_samples, new_samples)
        for name, _, _ in neg:
            print(
                f'{DEFAULT}Info: sample {BLUE}"{name}"{DEFAULT} will be '
                f"removed from the sample bank.{DEFAULT}"
            )
            self.sb.mark_dead(name)
        print(f"{DEFAULT}Status: refreshing sample bank.{DEFAULT}")
        self.sb.refresh()
        excluded = []
        for name, file, method in pos:
            print(
                f'{DEFAULT}Status: adding sample {BLUE}"{name}"{DEFAULT} to '
                f"the sample bank.{DEFAULT}"
            )
            try:
                self.sb.add(
                    name, self._resolve(file), SampleLoadMethod.from_str(method)
                )
            except ValueError as e:
                print(f"{RED}{e}{DEFAULT}")
                excluded.append(name)
        # do_excluding semantics (state.rs:188-199): prune failures into the
        # committed list, then abort the refresh
        self.cur_samples = [s for s in new_samples if s[0] not in excluded]
        if excluded:
            raise RefreshAbort

        # ---- resources (state.rs:222-237) ---------------------------------
        pos, neg = diff(self.cur_resources, new_resources)
        for name, _ in neg:
            print(
                f'{DEFAULT}Info: resource {BLUE}"{name}"{DEFAULT} will be '
                f"removed.{DEFAULT}"
            )
            self.bb.mark_dead(name)
        print(f"{DEFAULT}Status: refreshing resources.{DEFAULT}")
        self.bb.refresh()
        excluded = []
        for name, file in pos:
            try:
                self.bb.add(name, self._resolve(file))
            except ValueError as e:
                print(f"{RED}{e}{DEFAULT}")
                excluded.append(name)
        self.cur_resources = [r for r in new_resources if r[0] not in excluded]
        if excluded:
            raise RefreshAbort

        # ---- midi + streams: always fully reloaded (state.rs:240-250) -----
        self.fb.reset()
        for name, file in midis:
            try:
                self.fb.add_floww(name, self._resolve(file))
            except ValueError as e:
                print(f"{RED}{e}{DEFAULT}")
                raise RefreshAbort from None
        for name, events in inline_flowws:
            self.fb.declare_floww(name, events)
        for name in streams:
            self.fb.declare_stream(name)

        # ---- plugins (state.rs:254-323) ------------------------------------
        pos, neg = diff(self.cur_lv2plugins, new_lv2plugins)
        for name, _ in neg:
            self.host.remove_plugin(name)
        excluded = []
        for name, uri in pos:
            try:
                self.host.add_plugin(uri, name)
                print(
                    f"{DEFAULT}Info: added plugin {BLUE}{name}{DEFAULT} with "
                    f"uri {BLUE}{uri}{DEFAULT}.{DEFAULT}"
                )
            except AddPluginError as e:
                print(
                    f'{RED}Couldn\'t load plugin with name: {BLUE}"{name}"'
                    f'{RED} and uri: {BLUE}"{uri}"{RED}.{DEFAULT}\n\t{e}'
                )
                excluded.append(name)
        self.cur_lv2plugins = [
            p for p in new_lv2plugins if p[0] not in excluded
        ]
        if excluded:
            raise RefreshAbort
        pos, neg = diff(self.cur_lv2params, new_lv2params)
        for plugin, name, _ in neg:
            self.host.reset_value(plugin, name)
        for plugin, name, value in pos:
            self.host.set_value(plugin, name, value)
        self.cur_lv2params = new_lv2params

        # ---- graph rebuild (state.rs:327-459) -------------------------------
        print(f"{DEFAULT}Status: rebuilding graph.{DEFAULT}")
        self.g.reset()

        def get_index(bank, arg, name, category):
            idx = bank.get_index(arg)
            if idx is None:
                print(
                    f"{RED}Could not get {category} index for vertex "
                    f'{BLUE}"{name}"{DEFAULT}.'
                )
                raise RefreshAbort
            return idx

        def adsr_conf(arr, name):
            conf = build_adsr_conf(arr)
            if conf is None:
                print(
                    f"{RED}ADSR config must have 0, 6 or 9 elements (vertex "
                    f'{BLUE}"{name}"{RED}).{DEFAULT}'
                )
                raise RefreshAbort
            return conf

        for name, gain, angle in sums:
            self.g.add(VertexDecl(name, G.SUM, gain, angle))
        for name, gain, angle in norms:
            self.g.add(VertexDecl(name, G.NORMALIZE, gain, angle))
        for name, gain, angle, sample in sampleloops:
            si = get_index(self.sb, sample, name, "sample")
            self.g.add(VertexDecl(
                name, G.SAMPLELOOP, gain, angle, params={"sample_index": si}
            ))
        for name, gain, angle, sample, floww, note in samplemultis:
            si = get_index(self.sb, sample, name, "sample")
            fi = get_index(self.fb, floww, name, "floww")
            self.g.add(VertexDecl(
                name, G.SAMPLEMULTI, gain, angle,
                params={
                    "sample_index": si, "floww_index": fi,
                    "note": None if note < 0 else note,
                },
            ))
        for name, gain, angle, sample, floww, note, lerp_len in samplelerps:
            si = get_index(self.sb, sample, name, "sample")
            fi = get_index(self.fb, floww, name, "floww")
            self.g.add(VertexDecl(
                name, G.SAMPLELERP, gain, angle,
                params={
                    "sample_index": si, "floww_index": fi,
                    "note": None if note < 0 else note,
                    "lerp_len": max(lerp_len, 0),
                },
            ))
        for name, gain, angle, floww in debugsines:
            fi = get_index(self.fb, floww, name, "floww")
            self.g.add(VertexDecl(
                name, G.DEBUGSINE, gain, angle, params={"floww_index": fi}
            ))
        for (name, gain, angle, floww, sq_vol, sq_z, sq_arr,
             tf_vol, tf_z, tf_arr, tr_vol, tr_arr) in synths:
            fi = get_index(self.fb, floww, name, "floww")
            self.g.add(VertexDecl(
                name, G.SYNTH, gain, angle,
                params={
                    "floww_index": fi,
                    "sq_vol": sq_vol, "sq_z": max(sq_z, 0.0001),
                    "sq_conf": adsr_conf(sq_arr, name),
                    "tf_vol": tf_vol, "tf_z": tf_z,
                    "tf_conf": adsr_conf(tf_arr, name),
                    "tr_vol": tr_vol, "tr_conf": adsr_conf(tr_arr, name),
                },
            ))
        wavetables: dict[int, WaveTable] = {}
        for name, gain, angle, floww, conf_arr, resource in sampsyns:
            fi = get_index(self.fb, floww, name, "floww")
            conf = adsr_conf(conf_arr, name)
            bi = self.bb.get_index(resource)
            if bi is None:
                print(
                    f'{RED}Could not find resource named {BLUE}"{resource}"'
                    f"{RED}!{DEFAULT}"
                )
                raise RefreshAbort
            table = parse_wavetable_from_buffer(self.bb.get_buffer(bi))
            if table is None:
                print(
                    f"{DEFAULT}Could not parse wavetable from resource "
                    f'{BLUE}"{resource}"{DEFAULT}, using default table!'
                )
                table = WaveTable.default()
            decl = VertexDecl(
                name, G.SAMPSYN, gain, angle,
                params={"floww_index": fi, "conf": conf},
            )
            self.g.add(decl)
            wavetables[len(self.g.vertices) - 1] = table
        for name, gain, angle, wet, plugin in lv2fxs:
            pi = get_index(self.host, plugin, name, "plugin")
            self.g.add(VertexDecl(
                name, G.PLUGINFX, gain, angle, wet,
                params={"plugin_index": pi},
            ))
        for (name, gain, angle, wet, floww, use_off, use_max, note,
             conf_arr) in adsrs:
            fi = get_index(self.fb, floww, name, "floww")
            self.g.add(VertexDecl(
                name, G.ADSR, gain, angle, wet,
                params={
                    "floww_index": fi, "use_off": use_off, "use_max": use_max,
                    "note": None if note < 0 else note,
                    "conf": adsr_conf(conf_arr, name),
                },
            ))
        for name, gain, angle, wet, cut_low, cut_high, pass_mode in bandpasses:
            self.g.add(VertexDecl(
                name, G.BANDPASS, gain, angle, wet,
                params={
                    "cut_low": cut_low, "cut_high": cut_high,
                    "pass_mode": pass_mode,
                },
            ))

        for a, b in edges:
            self.g.connect(a, b)
        self.g.set_output(self.output_vertex)
        if not self.g.check_graph():
            print(f"{RED}TermDaw: graph check failed!{DEFAULT}")
            raise RefreshAbort

        # ---- build the window program ---------------------------------------
        # the replaced graph's chains are pure cache: they must not keep
        # holding device memory
        if self.compiled is not None:
            self.compiled.release_chains()
        self.compiled = CompiledGraph(
            self.g, self.sb, bl, device=self.device,
            wavetables=wavetables, plugin_host=self.host,
            cap_scope=str(self.wdir),
        )
        self.compiled.reset_normalize_vertices()
        print(f"{GREEN}Ok: refreshed.{DEFAULT}")
        self.loaded = True

    # ------------------------------------------------------------------ mesh
    def _mesh_plan(self) -> tuple[Mesh | None, int, int]:
        """(mesh | None, n, step): with a mesh of more than one rank,
        unless TERMDAW_MESH=0, windows shard over its ranks and take
        `step` = max(n, 512 - 512 % n) blocks (divisibility first; the
        indivisible tail renders on every rank alone)."""
        mesh = self.mesh
        if mesh is None or mesh.size < 2 or \
                os.environ.get("TERMDAW_MESH", "1") == "0":
            return None, 1, render_chunk_blocks(self.cs)
        n = mesh.size
        return mesh, n, max(n, RENDER_WINDOW_BLOCKS - RENDER_WINDOW_BLOCKS % n)

    @staticmethod
    def _pick_nb(left: int, step: int, n: int) -> int:
        """This window's blocks: at most `step`, rounded down to a multiple
        of n when sharding (the tail renders alone next)."""
        nb = min(left, step)
        if n > 1 and nb > n:
            nb -= nb % n
        return nb

    def _render_window_auto(self, cg, nb: int, mesh: Mesh | None, n: int,
                            is_scan: bool = False) -> torch.Tensor | None:
        """The window's audio: when it shards, the whole window gathered
        on rank 0 (None on the other ranks, and this rank's slice for a
        scan, whose audio nobody reads), else this rank's own render of
        it."""
        if mesh is not None and nb % n == 0:
            local = cg.render_window_sharded(self.fb, nb, mesh,
                                             is_scan=is_scan)
            if is_scan:
                return local
            whole = gather(local, mesh)
            return None if whole is None else whole.reshape(-1, 2)
        return cg.render_window(self.fb, nb, is_scan=is_scan)

    # ------------------------------------------------------------------ scan
    def scan_exact(self) -> None:
        """2-pass normalization scan (reference graph.rs:222-237)."""
        cg = self.compiled
        if cg is None or cg.output is None:
            return
        cg.reset_scan_normalize_vertices()
        cg.set_time(0)
        self.fb.set_time(0)
        mesh, n, step = self._mesh_plan()
        # sharded windows bake live: a stored chain would be waste
        cg.seed_caps(self.fb, self.cs, step, prebake=(n == 1))
        left = self.cs
        while left > 0:
            nb = self._pick_nb(left, step, n)
            self._render_window_auto(cg, nb, mesh, n, is_scan=True)
            self.fb.advance_blocks(nb)
            left -= nb
        cg.apply_scan_normalize_vertices()
        cg.set_time(0)
        self.fb.set_time(0)

    # ------------------------------------------------------------------ render
    def render(self) -> None:
        print(f"{DEFAULT}Status: started rendering{DEFAULT}")
        mesh, n, _ = self._mesh_plan()
        # rank 0 of a sharded render (or the only rank) writes the WAV
        leads = mesh is None or mesh.rank == 0
        if mesh is not None and leads:
            print(f"{DEFAULT}Status: rendering on {BLUE}{n}{DEFAULT} ranks "
                  f"({mesh.backend}).{DEFAULT}")
        psr = self.config.settings.project_samplerate
        msr, mbd = self.sb.get_max_sr_bd()
        if psr > self.render_sr:
            print(
                f"{YELLOW}TermDaw: warning: render will down sample from "
                f"{BLUE}{psr}{YELLOW}(project s.r.) to "
                f"{BLUE}{self.render_sr}{YELLOW}.{DEFAULT}"
            )
        if msr > self.render_sr:
            print(
                f"{YELLOW}TermDaw: warning: render will down sample from "
                f"peak input quality({BLUE}{msr}{YELLOW}) to "
                f"{BLUE}{self.render_sr}{YELLOW}.{DEFAULT}"
            )
        if self.bd not in (8, 16, 24, 32):
            print(
                f"{RED}Bitdepth of {BLUE}{self.bd}{RED} not supported: "
                f"choose bitdepth in {{8, 16, 24, 32}}.{DEFAULT}"
            )
            return
        if mbd > self.bd:
            print(
                f"{YELLOW}TermDaw: warning: render will lose bitdepth from "
                f"peak input quality({BLUE}{mbd}{YELLOW} bits) to "
                f"{BLUE}{self.bd}{YELLOW} bits{DEFAULT}"
            )
        cg = self.compiled
        if cg is None:
            raise RuntimeError("State.render: no compiled graph (refresh "
                               "did not load)")
        # deviation (documented): align event cursor with graph time so
        # repeated renders behave identically
        self.fb.set_time(cg.get_time())

        with span("render windows"), device_trace("render"):
            chunks = self.render_device()

        if leads:
            writer = WavWriter(
                self._resolve(self.output_file), 2, self.render_sr, self.bd
            )
            with span("render fetch+write"):
                for ints in chunks:
                    writer.write_ints(ints.cpu().numpy())
            writer.close()
        cg.set_time(0)
        print(f"{GREEN}Ok: done rendering.{DEFAULT}")

    def render_device(self) -> list[torch.Tensor]:
        """The device side of a render: window-by-window graph evaluation,
        then ONE polyphase resample (when the project rate is above the
        render rate) and ONE quantize over the whole signal. Returns the
        device int chunks (one, or none for an empty render; none on a
        rank other than 0 of a sharded render); graph time is advanced,
        not reset."""
        psr = self.config.settings.project_samplerate
        cg = self.compiled
        mesh, n, step = self._mesh_plan()
        # pin bake-table caps from the full known schedule so every window
        # below produces the same table layout; only a single-device render
        # stores a chain (sharded windows bake live)
        cg.seed_caps(self.fb, self.cs, step, prebake=(n == 1))
        leads = mesh is None or mesh.rank == 0
        wins: list[torch.Tensor] = []
        left = self.cs
        while left > 0:
            nb = self._pick_nb(left, step, n)
            win = self._render_window_auto(cg, nb, mesh, n)
            if leads:
                wins.append(win)
            self.fb.advance_blocks(nb)
            left -= nb
        if not wins:
            return []
        if psr > self.render_sr:
            wins = [StreamingResampler(psr, self.render_sr, self.device)
                    .render_whole(wins)]
        if sum(int(w.shape[0]) for w in wins) == 0:
            return []
        return [quantize_interleave_many(wins, self.bd)]
