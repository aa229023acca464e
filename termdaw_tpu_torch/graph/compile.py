"""CompiledGraph: a refreshed DAG as a window program of tensor ops.

Port of termdaw_tpu/graph/compile.py. The host logic is carried over
unchanged: bake-table packing and sticky caps (`_pack_bakes`,
`_caps_from_table`, `_merge_caps`), the carry classes, `seed_caps` pass 1,
the SampleMulti bake with fused groups (`_bake_all`, `_group_pool`,
`_bake_fused_group`, `_fused_member_vecs`, `_merge_group`), time control
and the normalize resets. The device side runs eagerly in PyTorch on an
explicit device instead of as a jitted XLA program:

* each sample is uploaded once at build and padded (and, for a fused
  group over several samples, concatenated) on the device; each window's
  bake tables are two uploads (one int32, one float32 buffer) that
  `_unpack_bakes` slices;
* `render_window` live-bakes every window (the reference's
  TERMDAW_PREBAKE=0 semantics: no prebaked or recorded chains);
* `_program` has an arm for every vertex kind. The PLUGINFX arm (the
  native effects, ops/fx.py) takes its traced params from `_pack_fx`
  (one f32 upload per PluginHost change) and its wet gate from the host:
  with wet < 1e-4 the input passes and the `.fx` state is left as it was,
  without running the effect (the reference's `jnp.where` leaf by leaf
  gives the same values);
* TERMDAW_EXACT_BIQUAD=1, read once at build as the reference does, makes
  the build of a graph with a biquad effect raise NotImplementedError:
  the exact sequential biquad lane is not ported, and the parallel lane
  is never substituted for it;
* the frame -> seconds table (`time_table`, a correctly rounded f32
  division on the host) is uploaded once per size on the graph's device
  and sliced per window, for the synths' `time2d` and every envelope's
  in-block offsets `ib`.

Fused groups (every SampleMulti whose only consumer is the same vertex,
two or more per consumer) are formed on every device, so the CPU path
bakes the same tables as the card. A group mixes in one
`ops.voices.voice_mix_stereo` call, with each member's pan/gain folded
into its voices' amps; a lone SampleMulti makes the same call with equal
channel amps (compile.py:1709-1723 on the TPU).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from termdaw_tpu.banks.flowwbank import FlowwBank

from . import bake as B
from . import graph as G
from ..ops import envelope, filters, fx, mix, sampler, synthv, voices
from ..ops.filters import BandPassState

# kinds whose window kernels read absolute frames / the time table
_FRAME_KINDS = (G.SAMPLELERP, G.DEBUGSINE, G.SYNTH, G.SAMPSYN, G.ADSR)
_TIME_KINDS = (G.DEBUGSINE, G.SYNTH, G.SAMPSYN, G.ADSR)


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


# which vertex kinds carry host-side bake state, and their carry class
_CARRY_CLASSES: dict[str, type] = {
    G.SAMPLEMULTI: B.MultiCarry,
    G.SAMPLELERP: B.LerpCarry,
    G.DEBUGSINE: B.SineCarry,
    G.SYNTH: B.NotesCarry,
    G.SAMPSYN: B.NotesCarry,
    G.ADSR: B.AdsrCarry,
}


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
    ) -> None:
        self.graph = graph
        self.bl = bl
        self.sr = sr = graph.sr
        self.device = torch.device(device)
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
        # read once at build (reference compile.py:297)
        if filters.exact_biquad_env():
            for vi in self.order:
                if self.statics[vi].fx_kind in fx.BIQUAD_EFFECTS:
                    raise NotImplementedError(
                        f'vertex "{graph.names[vi]}": the exact biquad lane '
                        f"(TERMDAW_EXACT_BIQUAD=1) is not yet ported to "
                        f"termdaw_tpu_torch; unset it to render "
                        f"{self.statics[vi].fx_kind} with the parallel lane"
                    )
        kinds = {st.kind for st in self.statics.values()}
        self._has_fx = G.PLUGINFX in kinds
        self._uses_frames = bool(kinds.intersection(_FRAME_KINDS))
        self._uses_time = bool(kinds.intersection(_TIME_KINDS))
        self._ttab: torch.Tensor | None = None  # see _time_table

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

        # per-vertex bake-table caps: tables pad to these, raised by
        # seed_caps()'s walk of the full schedule and on overflow
        self.bake_caps: dict[str, dict[str, int]] = {}
        self._seeded_sigs: set[tuple] = set()
        # per-fused-group pooled event arrays, keyed by FlowwBank version
        self._pool_cache: dict[int, tuple] = {}
        # per-(consumer, member) processed event arrays, keyed by the
        # member's events array identity (see _group_pool)
        self._member_pool_cache: dict[tuple[int, int], tuple] = {}
        # per-consumer sample_len/base vectors (see _fused_member_vecs)
        self._fused_vecs: dict[int, tuple] = {}
        # (PluginHost.version, packed traced effect params; see _pack_fx)
        self._fx_cache: tuple | None = None

    def _scalar(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def _time_table(self, n_frames: int) -> torch.Tensor:
        """The device copy of time_table(sr, n_frames), uploaded once per
        size (a longer table has the shorter one as its prefix)."""
        if self._ttab is None or self._ttab.shape[0] < n_frames:
            self._ttab = torch.from_numpy(
                time_table(self.sr, n_frames)
            ).to(self.device)
        return self._ttab

    def _record_caps(self, key: str, kind: str, tbl) -> None:
        _merge_caps(self.bake_caps.setdefault(key, {}),
                    _caps_from_table(kind, tbl))

    def seed_caps(self, fb: FlowwBank, total_blocks: int, step: int) -> None:
        """Pre-bake the full known event schedule over the render window
        grid and pin every bake-table cap at the observed maxima, so every
        window of the render gets one table layout (the reference's
        seed_caps pass 1). Host numpy, proportional to event count;
        idempotent; leaves graph and floww state untouched."""
        if total_blocks <= 0 or not self.carries:
            return
        sig = (fb.uid, fb.version, total_blocks, step)
        if sig in self._seeded_sigs:
            return  # schedule unchanged since the last seed
        saved_frame = fb.frame
        fb.set_time(0)
        try:
            carries = {
                vi: _CARRY_CLASSES[self.statics[vi].kind]()
                for vi in self.carries
            }
            t, left = 0, total_blocks
            while left > 0:
                nb = min(left, step)
                _, nc = self._bake_all(fb, t, nb, carries=carries)
                carries.update(nc)
                fb.advance_blocks(nb)
                t += nb * self.bl
                left -= nb
        finally:
            # an interrupt mid-seed must not leave the bank's cursor
            # desynced from graph time
            fb.set_time(saved_frame)
        self._seeded_sigs.add(sig)

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
        for k, v in num_state.items():
            if k.endswith(".bp"):
                self.num_state[k] = BandPassState(
                    prevs=torch.tensor(np.asarray(v.prevs, np.float32),
                                       device=dev),
                    first=torch.tensor(bool(np.asarray(v.first)),
                                       device=dev),
                )
            elif k.endswith(".fx"):
                self.num_state[k] = _tree_to_device(v, self.num_state[k], dev,
                                                    k)
            else:
                self.num_state[k] = torch.tensor(np.asarray(v, np.float32),
                                                 device=dev)
        for vi, c in carries.items():
            cls = _CARRY_CLASSES[self.statics[vi].kind]
            port = _port_value(c)
            if not isinstance(port, cls):
                raise ValueError(f"vertex {vi}: carry {type(c).__name__} is "
                                 f"not a {cls.__name__}")
            self.carries[vi] = port
        self.t = t
        self.graph.t = t

    def _pack_fx(self) -> dict[str, dict[str, torch.Tensor]]:
        """Traced effect parameters, uploaded as one f32 vector, as the
        per-vertex dicts of 0-d views of it that the effects take. Names
        are sorted; static params (EffectDef.static_params) are left out,
        they were bound into _VertexStatic.fx_static at build. Memoized on
        PluginHost.version: the layout is fixed per graph and the values
        change only through the host's mutators (reference
        compile.py:1113-1142)."""
        ver = self.plugin_host.version
        if self._fx_cache is not None and self._fx_cache[0] == ver:
            return self._fx_cache[1]
        keys: list[tuple[str, str]] = []
        vals: list[float] = []
        for vi in self.order:
            st = self.statics[vi]
            if st.kind != G.PLUGINFX:
                continue
            pv = self.plugin_host.param_values(st.fx_plugin_index)
            skip = fx.EFFECTS[st.fx_kind].static_params
            for name in sorted(pv):
                if name not in skip:
                    keys.append((str(vi), name))
                    vals.append(float(pv[name]))
        vec = torch.tensor(vals, dtype=torch.float32, device=self.device)
        params: dict[str, dict[str, torch.Tensor]] = {}
        for (vkey, name), v in zip(keys, vec):
            params.setdefault(vkey, {})[name] = v
        self._fx_cache = (ver, params)
        return params

    # -- normalization controls (reference graph.rs:195-220) ---------------
    def _normalize_vis(self):
        return [vi for vi in self.order
                if self.statics[vi].kind == G.NORMALIZE]

    def reset_normalize_vertices(self) -> None:
        for vi in self._normalize_vis():
            self.num_state[f"{vi}.max"] = self._scalar(1e-6)

    def reset_scan_normalize_vertices(self) -> None:
        for vi in self._normalize_vis():
            self.num_state[f"{vi}.scan_max"] = self._scalar(0.0)

    def apply_scan_normalize_vertices(self) -> None:
        for vi in self._normalize_vis():
            self.num_state[f"{vi}.max"] = self.num_state[f"{vi}.scan_max"]

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
        Adsr cell clocks are time-relative values and carry through."""
        dt = t - self.t
        for vi, carry in self.carries.items():
            kind = self.statics[vi].kind
            if kind in (G.DEBUGSINE, G.SYNTH):
                if carry.notes:
                    self.carries[vi] = type(carry)()
            elif kind == G.SAMPLEMULTI:
                if carry.voices:
                    self.carries[vi] = B.MultiCarry(
                        [(s + dt, v) for s, v in carry.voices]
                    )
            elif kind == G.SAMPLELERP:
                self.carries[vi] = replace(
                    carry,
                    primary_start=carry.primary_start + dt,
                    ghost_start=carry.ghost_start + dt,
                )
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
                self.num_state[f"{vi}.bp"] = BandPassState.init(self.device)
        self.t = t
        self.graph.t = t

    def change_time(self, delta: int, plus: bool) -> int:
        new_t = self.t + delta if plus else self.t - min(delta, self.t)
        self.set_time(new_t)
        return new_t

    def get_time(self) -> int:
        return self.t

    # -- rendering ----------------------------------------------------------
    def render_window(
        self, fb: FlowwBank, nb: int, is_scan: bool = False
    ) -> torch.Tensor:
        """Render `nb` blocks starting at the current graph time. The floww
        bank cursor must already sit at the same frame (the engine aligns
        them). Advances graph time and all carried state. Returns device
        audio [nb*bl, 2]."""
        t0 = self.t
        bakes, new_carries = self._bake_all(fb, t0, nb)
        ints_buf, floats_buf, layout = _pack_bakes(bakes)
        dev_bakes = _unpack_bakes(
            torch.from_numpy(ints_buf).to(self.device),
            torch.from_numpy(floats_buf).to(self.device),
            layout,
        )
        audio = self._program(dev_bakes, t0, nb, is_scan)
        self.carries.update(new_carries)
        self.t = t0 + nb * self.bl
        self.graph.t = self.t
        return audio

    def _bake_all(
        self, fb: FlowwBank, t0: int, nb: int,
        carries: dict[int, Any] | None = None,
    ):
        """Host-side event baking for a window. Each fused group's
        per-vertex voices merge into one COMPACT voice table (only voices
        that intersect each block), so the kernel's work is proportional
        to live voices. Table shapes pad to the sticky `bake_caps`
        (raised here on overflow)."""
        carries = self.carries if carries is None else carries
        bakes: dict[str, dict[str, np.ndarray]] = {}
        new_carries: dict[int, Any] = {}
        t1 = t0 + nb * self.bl
        for vi, carry in carries.items():
            if vi in self._fused_members:
                continue  # baked per GROUP below
            st = self.statics[vi]
            key = str(vi)
            tbl, nc = self._bake_vertex(fb, st, carry, t0, nb,
                                        self.bake_caps.get(key))
            bakes[key] = tbl
            new_carries[vi] = nc
            self._record_caps(key, st.kind, tbl)
        for consumer, members in self.fused_groups.items():
            voices_, group_carries = self._bake_fused_group(
                fb, consumer, members, t0, t1, carries
            )
            new_carries.update(group_carries)
            tbl = self._merge_group(voices_, consumer, members, t0, nb)
            bakes[f"fused{consumer}"] = tbl
            self._record_caps(f"fused{consumer}", "fused", tbl)
        return bakes, new_carries

    def _bake_vertex(self, fb: FlowwBank, st: _VertexStatic, carry,
                     t0: int, nb: int, caps):
        """One event vertex's window table and end carry (graph/bake.py)."""
        bl, sr = self.bl, self.sr
        if st.kind in (G.DEBUGSINE, G.SYNTH, G.SAMPSYN) or (
            st.kind == G.ADSR and st.use_off
        ):
            simple = fb.bake_simple(st.floww_index, nb)
            if st.kind == G.DEBUGSINE:
                return B.bake_debug_sine(simple, carry, t0, nb, bl, caps)
            if st.kind == G.ADSR:
                return B.bake_adsr_off(simple, carry, st.confs[0], sr, t0,
                                       nb, bl, st.note, caps)
            return B.bake_notes(simple, carry, t0, nb, bl, sr,
                                st.release_sec, caps)
        drum = fb.bake_drum(st.floww_index, nb).filter_note(st.note)
        if st.kind == G.SAMPLEMULTI:
            return B.bake_sample_multi(drum, carry, t0, nb, bl,
                                       st.sample_len, caps)
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

    def _program(self, bakes, t0: int, nb: int, is_scan: bool) -> torch.Tensor:
        bl = self.bl
        T = nb * bl
        bufs: dict[int, torch.Tensor] = {}
        ns = self.num_state
        fx_params = self._pack_fx() if self._has_fx else {}
        if self._uses_frames:
            frames = torch.arange(t0, t0 + T, dtype=torch.int64,
                                  device=self.device)
        if self._uses_time:
            ttab = self._time_table(t0 + T)
            time2d = ttab[t0:t0 + T].reshape(nb, bl)
            ib = ttab[:bl]  # f32(i)/f32(sr), i in block
        for vi in self.order:
            st = self.statics[vi]
            kind = st.kind
            if vi in self._fused_members:
                continue  # mixed at the consumer
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
                        xr, ns[f"{vi}.max"], ns[f"{vi}.scan_max"]
                    )
                else:
                    outr, ns[f"{vi}.max"] = mix.normalize_live(
                        xr, ns[f"{vi}.max"]
                    )
                out = outr.reshape(T, 2)
            elif kind == G.SAMPLELOOP:
                out = sampler.sample_loop(self.samples[st.sample_pos], t0, T)
            elif kind == G.SAMPLEMULTI:
                begins, vels = voices.compute_begin_vel(
                    bakes[key], t0, nb, bl, st.sample_len
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
                    self._wets[vi],
                )
            elif st.fx_skip:  # G.PLUGINFX with wet < 1e-4
                out = x  # the input passes, the state stays as it was
            else:  # G.PLUGINFX
                y, ns[f"{vi}.fx"] = fx.EFFECTS[st.fx_kind].process(
                    x, ns[f"{vi}.fx"], fx_params.get(key, {}), self.sr,
                    dict(st.fx_static),
                )
                out = x + self._wets[vi] * (y - x)
            bufs[vi] = mix.post(out, self._angles[vi], self._gains[vi])
        return bufs[self.output]
