"""Timeline sharding in the port (termdaw_tpu_torch/parallel, the mesh forms
of ops/{filters,fx,mix,scan}.py, CompiledGraph.render_window_sharded and
State's mesh plan) on 4 CPU ranks over gloo.

The module starts three runs once and the tests read them:

* the JAX reference in one subprocess with 4 virtual CPU devices
  (XLA_FLAGS=--xla_force_host_platform_device_count=4, JAX_PLATFORMS=cpu,
  PYTHONPATH scrubbed, as tests/test_parallel.py runs it): each sharded
  primitive under `shard_map`, and the single-device renders of the two
  projects (TERMDAW_MESH=0);
* the port's primitives and the eight effects in a 4-rank world;
* the port's renders in a 4-rank world: a project with SampleMulti,
  SampleLoop, Adsr, BandPass and Normalize (the reference's
  tests/subproc/mesh_default_check.py project: 8 kHz / 256, 250 blocks,
  scan then render) and c4 cut to 2 s (63 blocks); neither block count
  divides by 4, so each render ends with a window every rank renders
  alone.

Both sides take the same numpy inputs, made from a seed. This module
imports no JAX at its top: the ranks import it to find their functions,
and no rank may load JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

from termdaw_tpu_torch.engine.state import render_chunk_blocks
from termdaw_tpu_torch.fileio.midi import write_midi
from termdaw_tpu_torch.fileio.wav import write_wav
from termdaw_tpu_torch.ops import filters, fx, mix, scan
from termdaw_tpu_torch.parallel import launch, mesh as pmesh
from termdaw_tpu_torch.tools import shard_render
from termdaw_tpu_torch.utils import fixtures

from .conftest import scrubbed_env

REPO = Path(__file__).resolve().parents[1]
N = 4          # ranks and virtual devices
T = 300        # frames a rank in the primitive cases
SR = 8000
FB_D, FB_LONG_D = 7, 500       # 300 % 7 = 6: every rank but 0 has o != 0
PF_M, PF_SHORT_T, PF_SHORT_M = 7, 5, 12
BQ_T = 2048
NL_NB, NL_BL = 6, 16
FX_T = 600     # frames a rank in the effect cases
RENDER_TOL = 2  # 16-bit counts: 2/32768 of full scale (mesh_default_check.py:111)
EFFECT_PARAMS = {
    "reverb": {"room": 0.95, "damp": 0.2},
    "chorus": {"rate": 3.0, "depth": 10.0, "base": 4.0},
    "compressor": {"attack": 5.0, "release": 80.0, "threshold": -30.0,
                   "ratio": 8.0, "knee": 2.0, "makeup": 3.0},
    "tape": {"drive": 4.0, "cutoff": 2000.0},
    "delay": {"time": 90.0, "feedback": 0.7},
    "bitcrush": {"bits": 4.0},
    "eq3": {"low_freq": 300.0, "high_freq": 1500.0, "low_gain": 6.0,
            "mid_gain": -4.0, "high_gain": 3.0},
    "flanger": {"rate": 2.0, "depth": 4.0, "base": 3.0},
}


def _inputs() -> dict[str, np.ndarray]:
    """Every primitive case's inputs, global (all ranks' slices in rank
    order) where the primitive shards them."""
    rng = np.random.default_rng(7)

    def nrm(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def f32(*v):
        return np.asarray(v, np.float32)

    u = rng.uniform(0.2, 0.95, size=(N, 3)).astype(np.float32)
    ang = rng.uniform(0.0, 3.0, size=(N, 3))
    hp = filters.biquad_coefs("highpass", 120.0, SR)
    lp = filters.biquad_coefs("lowpass", 900.0, SR)
    return {
        # exclusive_total: one summary a device, [N, k, 3]
        "xt_affine": np.stack([u, nrm(N, 3)], 1),
        "xt_max_decay": np.stack([u, np.abs(nrm(N, 3))], 1),
        "xt_complex": np.stack([0.9 * np.cos(ang), 0.9 * np.sin(ang),
                                rng.normal(size=(N, 3)),
                                rng.normal(size=(N, 3))], 1).astype(
                                    np.float32),
        "affine_x": nrm(N * T, 3), "affine_a": f32(0.9, 0.999, 0.5),
        "affine_y0": nrm(3),
        "md_x": np.abs(nrm(N * T, 2)), "md_r": f32(0.995, 0.9),
        "md_y0": f32(0.5, 2.5),
        "pf_x": nrm(N * T, 2), "pf_tail": nrm(PF_M, 2),
        "pf_short_x": nrm(N * PF_SHORT_T, 2), "pf_short_tail": nrm(PF_SHORT_M,
                                                                    2),
        "bp_x": nrm(N * T, 2), "bp_prevs": nrm(4),
        "bq_x": nrm(N * BQ_T, 4), "bq_state": 0.1 * nrm(4, 4),
        "bq_coefs": np.asarray([[h, h, c, c] for h, c in zip(hp, lp)],
                               np.float32),
        "fb_x": nrm(N * T, 2), "fb_tail": nrm(FB_D, 2),
        "fb_long_x": nrm(N * 120, 1), "fb_long_tail": nrm(FB_LONG_D, 1),
        "ph_ph0": f32(1.3), "ph_rate": f32(2.7),
        "nl_x": nrm(N * NL_NB, NL_BL, 2), "nl_max": f32(0.4),
        "nl_scan_max": f32(0.7),
    }


BP = dict(lgamma=filters.gamma_from_cutoff(2000.0, SR),
          hgamma=filters.gamma_from_cutoff(60.0, SR), pass_mode=True)
XT_OPS = {  # port combine, identity
    "affine": (scan._affine, (1.0, 0.0)),
    "max_decay": (scan._max_decay, (1.0, scan.MAX_DECAY_IDENTITY)),
    "complex": (scan._caffine, (1.0, 0.0, 0.0, 0.0)),
}


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 4 virtual CPU devices
# ---------------------------------------------------------------------------

def _reference_main(out: str, mesh_dir: str, c4_dir: str) -> None:
    """Each primitive under the reference's shard_map over 4 devices, and
    the single-device renders of the two projects; saved to `out` (npz)."""
    os.environ["TERMDAW_MESH"] = "0"
    os.environ["TERMDAW_PALLAS_INTERPRET"] = "1"
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from termdaw_tpu.config import Config
    from termdaw_tpu.engine.state import State
    from termdaw_tpu.ops import filters as rf, fx as rfx, mix as rmix

    assert len(jax.devices()) >= N, jax.devices()
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("sp",))
    S, R = P("sp"), P()
    inp = _inputs()
    res: dict[str, np.ndarray] = {}

    def run(name, fn, in_specs, out_specs, *args):
        f = jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_vma=False))
        outs = f(*(jnp.asarray(a) for a in args))
        for i, o in enumerate(jax.tree.leaves(outs)):
            res[f"{name}.{i}"] = np.asarray(o)

    xt = {"affine": (rf._affine_combine, (1.0, 0.0)),
          "max_decay": (rfx._maxdecay_combine, (1.0, -3.0e38)),
          "complex": (rf._caffine_combine, rf._CAFF_IDENT)}
    for op, (comb, ident) in xt.items():
        def body(s, comb=comb, ident=ident):
            pre, tot = rf.exclusive_total(
                comb, ident, tuple(s[0, k] for k in range(len(ident))), "sp")
            return jnp.stack(pre)[None], jnp.stack(tot)
        run(f"xt_{op}", body, (S,), (S, R), inp[f"xt_{op}"])
    run("affine", lambda x, a, y0: rf.first_order_scan_sharded(x, a, y0,
                                                                "sp"),
        (S, R, R), (S, R), inp["affine_x"], inp["affine_a"],
        inp["affine_y0"])
    run("max_decay", lambda x, r, y0: rfx.max_decay_scan_sharded(x, r, y0,
                                                                  "sp"),
        (S, R, R), (S, R), inp["md_x"], inp["md_r"], inp["md_y0"])
    for name in ("pf", "pf_short"):
        run(name, lambda x, t: (lambda h, n: (h[None], n))(
            *rf.prev_frames(x, t, "sp")),
            (S, R), (S, R), inp[f"{name}_x"], inp[f"{name}_tail"])
    for first in (True, False):
        def bp(x, prevs, first=first):
            out, st = rf.band_pass_timeline(
                x, rf.BandPassState(prevs, jnp.asarray(first)),
                BP["lgamma"], BP["hgamma"], BP["pass_mode"], 1.0,
                axis_name="sp")
            return out, st.prevs, st.first
        run(f"bp_first{int(first)}", bp, (S, R), (S, R, R), inp["bp_x"],
            inp["bp_prevs"])
    run("biquad", lambda x, c, s: rf.biquad_apply(
        x, tuple(c[i] for i in range(5)), s, axis_name="sp"),
        (S, R, R), (S, R), inp["bq_x"], inp["bq_coefs"], inp["bq_state"])
    for name, D in (("fb", FB_D), ("fb_long", FB_LONG_D)):
        run(name, lambda x, t, D=D: rfx.feedback_line(x, t, 0.7, D,
                                                       axis_name="sp"),
            (S, R), (S, R), inp[f"{name}_x"], inp[f"{name}_tail"])
    run("phase", lambda ph0, rate: rfx._local_phase(ph0[0], rate[0], T, SR,
                                                    "sp"),
        (R, R), (S, R), inp["ph_ph0"], inp["ph_rate"])
    run("norm_live", lambda x, m: rmix.normalize_live(x, m[0], "sp"),
        (S, R), (S, R), inp["nl_x"], inp["nl_max"])
    run("norm_scan", lambda x, m, s: rmix.normalize_scan(x, m[0], s[0],
                                                         "sp"),
        (S, R, R), (S, R), inp["nl_x"], inp["nl_max"], inp["nl_scan_max"])

    for name, d, wav, scan_first in (("mesh", mesh_dir, "out.wav", True),
                                     ("c4", c4_dir, "outp.wav", False)):
        st = State(Config.read(Path(d) / "project.toml"), d)
        st.refresh()
        assert st.loaded
        if scan_first:
            st.scan_exact()
        st.render()
        res[f"render_{name}"] = fixtures.read_wav_ints(Path(d) / wav)[0]
    np.savez(out, **res)


class _Reference:
    """The reference's subprocess, started at once and read on demand."""

    def __init__(self, d: Path) -> None:
        self.out = d / "ref.npz"
        self.dirs = (d / "mesh", d / "c4")
        _write_mesh_project(self.dirs[0])
        fixtures.write_c4_project(self.dirs[1], 2.0, SR, 256, render_sr=SR)
        env = scrubbed_env(
            XLA_FLAGS=f"--xla_force_host_platform_device_count={N}")
        code = ("import sys; from tests.test_torch_parallel import "
                "_reference_main; _reference_main(*sys.argv[1:])")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, str(self.out),
             *map(str, self.dirs)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._res = None

    def result(self) -> dict[str, np.ndarray]:
        if self._res is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, (out + err)[-3000:]
            self._res = dict(np.load(self.out))
        return self._res


def _write_mesh_project(d: Path) -> None:
    """tests/subproc/mesh_default_check.py:35-71's project: SampleMulti,
    SampleLoop -> Adsr -> BandPass, into a Normalize; 8 s at 8 kHz / 256."""
    d.mkdir(parents=True, exist_ok=True)
    t = np.arange(int(SR * 0.3)) / SR
    x = (0.6 * np.sin(2 * np.pi * 330 * t) * np.exp(-t * 6)).astype(
        np.float32)
    write_wav(d / "tone.wav", np.stack([x, x], 1), SR, bits=16)
    write_midi(d / "ev.mid",
               [(i * 0.37, 0.1, 36 + (i % 5), 90) for i in range(20)],
               bpm=120)
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = 256\n'
        f"project_samplerate = {SR}\n")
    (d / "project.lua").write_text(f"""
set_length(8.0);
set_render_samplerate({SR});
set_render_bitdepth(16);
set_output_file("{d}/out.wav");
load_sample("tone", "{d}/tone.wav", "");
load_midi_floww("ev", "{d}/ev.mid");
add_sample_multi("m", 1.0, -20.0, "tone", "ev", -1);
add_sampleloop("bg", 0.4, 15.0, "tone");
add_adsr("env", 1.0, 0.0, 1.0, "ev", false, false, -1,
    {{ 1.0, 0.01, 0.3, 0.2, 0.3, 0.0, 0.0, 0.05, 1.0 }});
add_bandpass("band", 1.0, 0.0, 1.0, 3000, 40, true);
add_normalize("sum", 1.0, 0.0);
connect("m", "sum");
connect("bg", "env");
connect("env", "band");
connect("band", "sum");
set_output("sum");
""")


# ---------------------------------------------------------------------------
# the port's ranks (module-level functions: the ranks import this module)
# ---------------------------------------------------------------------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _flat(tree) -> np.ndarray:
    """A state tree's leaves (dicts in key order, tuples in order, a
    BandPassState as its prevs and first) as one float64 vector."""
    if isinstance(tree, filters.BandPassState):
        return np.concatenate([tree.prevs.numpy(),
                               [float(tree.first)]]).astype(np.float64)
    if isinstance(tree, dict):
        return np.concatenate([np.zeros(0)] +
                              [_flat(tree[k]) for k in sorted(tree)])
    if isinstance(tree, tuple):
        return np.concatenate([np.zeros(0)] + [_flat(v) for v in tree])
    return tree.detach().double().reshape(-1).numpy()


def _prims_rank(mesh, inp) -> dict:
    torch.set_num_threads(1)
    r = mesh.rank
    res: dict[str, np.ndarray] = {}

    def mine(a, t):
        return _t(a[r * t:(r + 1) * t])

    def keep(name, *outs):
        for i, o in enumerate(outs):
            res[f"{name}.{i}"] = o.detach().numpy()

    for op, (comb, ident) in XT_OPS.items():
        s = inp[f"xt_{op}"][r]
        pre, tot = filters.exclusive_total(
            comb, ident, tuple(torch.from_numpy(s[k]) for k in
                               range(len(ident))), mesh)
        keep(f"xt_{op}", torch.stack(pre)[None], torch.stack(tot))
    keep("affine", *filters.first_order_scan(
        mine(inp["affine_x"], T), _t(inp["affine_a"]),
        _t(inp["affine_y0"]), mesh))
    keep("max_decay", *fx.max_decay_scan_sharded(
        mine(inp["md_x"], T), _t(inp["md_r"]), _t(inp["md_y0"]), mesh))
    for name, t in (("pf", T), ("pf_short", PF_SHORT_T)):
        halo, tail = filters.prev_frames(mine(inp[f"{name}_x"], t),
                                         _t(inp[f"{name}_tail"]), mesh)
        keep(name, halo[None], tail)
    for first in (True, False):
        state = filters.BandPassState(_t(inp["bp_prevs"]),
                                      torch.tensor(first))
        out, st = filters.band_pass_timeline(
            mine(inp["bp_x"], T), state, BP["lgamma"], BP["hgamma"],
            BP["pass_mode"], torch.tensor(1.0), mesh)
        keep(f"bp_first{int(first)}", out, st.prevs, st.first)
    keep("biquad", *filters.biquad_apply(
        mine(inp["bq_x"], BQ_T), tuple(_t(c) for c in inp["bq_coefs"]),
        _t(inp["bq_state"]), mesh))
    for name, D, t in (("fb", FB_D, T), ("fb_long", FB_LONG_D, 120)):
        keep(name, *fx.feedback_line(mine(inp[f"{name}_x"], t),
                                     _t(inp[f"{name}_tail"]), 0.7, D, mesh))
    keep("phase", *fx._local_phase(_t(inp["ph_ph0"])[0],
                                   _t(inp["ph_rate"])[0], T, SR, mesh))
    x = mine(inp["nl_x"], NL_NB)
    keep("norm_live", *mix.normalize_live(x, _t(inp["nl_max"])[0], mesh))
    keep("norm_scan", *mix.normalize_scan(x, _t(inp["nl_max"])[0],
                                          _t(inp["nl_scan_max"])[0], mesh))
    res["effects"] = _effects_rank(mesh)
    return res


def _effect_signal() -> np.ndarray:
    """A smooth stereo signal over two windows of N*FX_T frames."""
    rng = np.random.default_rng(3)
    t = np.arange(2 * N * FX_T) / SR
    x = np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)],
                 1) * (0.5 + 0.4 * np.sin(2 * np.pi * 1.5 * t))[:, None]
    return (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32)


def _effects_rank(mesh) -> dict:
    """Each effect over two windows (state carried): this rank's slices
    sharded, and on rank 0 the single-device process of the whole windows."""
    x = _effect_signal()
    W = N * FX_T
    out = {}
    for kind, eff in fx.EFFECTS.items():
        p = dict(eff.defaults, **EFFECT_PARAMS[kind])
        static = fx.static_values(eff, p)
        tp = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()
              if k not in eff.static_params}
        got = {}
        for mode in ("sharded", "single"):
            if mode == "single" and mesh.rank != 0:
                continue
            st = eff.init_state(SR, static, torch.device("cpu"))
            ys = []
            for w in range(2):
                lo = w * W + (mesh.rank * FX_T if mode == "sharded" else 0)
                hi = lo + (FX_T if mode == "sharded" else W)
                y, st = eff.process(_t(x[lo:hi]), st, tp, SR, static,
                                    mesh if mode == "sharded" else None)
                ys.append(y.numpy())
            got[mode] = (ys, _flat(st))
        out[kind] = got
    return out


def _render_rank(mesh, mesh_dir: str, c4_dir: str) -> dict:
    """The two projects rendered sharded; then, on rank 0 alone, each
    under TERMDAW_MESH=0."""
    torch.set_num_threads(1)
    out = {}
    for name, d, wav, scan_first in (("mesh", mesh_dir, "out.wav", True),
                                     ("c4", c4_dir, "outp.wav", False)):
        st = fixtures.load_state(d, mesh.device, mesh=mesh)
        calls = mesh.collective_calls
        if scan_first:
            st.scan_exact()
        st.render()
        cg = st.compiled
        res = {"sharded_windows": cg.sharded_windows,
               "chain": cg._prebaked is not None or bool(cg._recorded),
               "served": cg.served_windows, "state": _flat(cg.num_state),
               "t": cg.get_time(),
               "collectives": mesh.collective_calls - calls}
        if mesh.rank == 0:
            res["wav"] = fixtures.read_wav_ints(Path(d) / wav)[0]
            os.environ["TERMDAW_MESH"] = "0"
            try:
                single = fixtures.load_state(d, mesh.device, mesh=mesh)
                single.output_file = str(Path(d) / "single.wav")
                if scan_first:
                    single.scan_exact()
                single.render()
            finally:
                del os.environ["TERMDAW_MESH"]
            res["single_wav"] = fixtures.read_wav_ints(
                Path(d) / "single.wav")[0]
            res["single_sharded_windows"] = single.compiled.sharded_windows
        out[name] = res
    # a State handed no mesh renders on its own device, process group or
    # not: its whole render is one rank's single-device render
    alone = fixtures.load_state(mesh_dir, mesh.device)
    calls = mesh.collective_calls
    alone.output_file = str(Path(mesh_dir) / f"alone{mesh.rank}.wav")
    alone.render()
    out["alone"] = {"plan": alone._mesh_plan()[:2],
                    "sharded_windows": alone.compiled.sharded_windows,
                    "collectives": mesh.collective_calls - calls}
    # parallel.sharded_render: one 64-block window from t = 0, on every
    # rank, against rank 0's single-device window
    st = fixtures.load_state(mesh_dir, mesh.device)
    out["window"] = pmesh.sharded_render(st, 64, mesh).numpy()
    out["window_t"] = st.compiled.get_time()
    if mesh.rank == 0:
        single = fixtures.load_state(mesh_dir, mesh.device)
        single.fb.set_time(0)
        out["single_window"] = single.compiled.render_window(single.fb,
                                                             64).numpy()
    return out


def _one_rank_plan(mesh, mesh_dir: str) -> tuple:
    st = fixtures.load_state(mesh_dir, mesh.device, mesh=mesh)
    plan = st._mesh_plan()
    return plan[0] is None, plan[1], plan[2], render_chunk_blocks(st.cs)


def _fail_on_rank_1(mesh) -> None:
    pmesh.pmax(torch.zeros(()), mesh)
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    pmesh.pmax(torch.zeros(()), mesh)


# ---------------------------------------------------------------------------
# the runs, once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = _Reference(tmp_path_factory.mktemp("ref"))
    yield r
    if r.proc.poll() is None:
        r.proc.kill()
        r.proc.communicate()


@pytest.fixture(scope="module")
def prims(ref):
    return launch(_prims_rank, N, _inputs(), backend="gloo", device="cpu",
                  timeout_s=300)


@pytest.fixture(scope="module")
def renders(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("port")
    _write_mesh_project(d / "mesh")
    fixtures.write_c4_project(d / "c4", 2.0, SR, 256, render_sr=SR)
    return launch(_render_rank, N, str(d / "mesh"), str(d / "c4"),
                  backend="gloo", device="cpu", timeout_s=300)


def _cat(prims, key):
    return np.concatenate([p[key] for p in prims])


def _same_on_every_rank(prims, key):
    for p in prims[1:]:
        np.testing.assert_array_equal(p[key], prims[0][key])
    return prims[0][key]


# name: (outputs sharded along time, outputs replicated, rtol of max |y|
# for the sharded ones, rtol of max |state| for the replicated ones)
PRIMITIVES = {
    # the summaries compose in float64 here, in float32 in the reference
    "xt_affine": ((0,), (1,), 1e-6, 1e-6),
    "xt_max_decay": ((0,), (1,), 1e-6, 1e-6),
    "xt_complex": ((0,), (1,), 1e-6, 1e-6),
    # scans: the port's A is r^n in float64, the reference's a float32
    # product tree; both within float32 rounding of the recurrence
    "affine": ((0,), (1,), 1e-5, 1e-5),
    "max_decay": ((0,), (1,), 1e-5, 1e-5),
    "pf": ((0,), (1,), 0.0, 0.0),
    "pf_short": ((0,), (1,), 0.0, 0.0),
    "bp_first1": ((0,), (1, 2), 1e-5, 1e-5),
    "bp_first0": ((0,), (1, 2), 1e-5, 1e-5),
    # the cascade's bound (tests/subproc/sharded_biquad_check.py:31)
    "biquad": ((0,), (1,), 1e-4, 1e-3),
    "fb": ((0,), (1,), 1e-5, 1e-5),
    "fb_long": ((0,), (1,), 1e-5, 1e-5),
    # the same float32 operations in the same order, but XLA's CPU backend
    # contracts w*t + base into an FMA (ROADMAP deviation 2): a few ulps
    "phase": ((0,), (1,), 4e-7, 4e-7),
    # exact
    "norm_live": ((0,), (1,), 0.0, 0.0),
    "norm_scan": ((0,), (1,), 0.0, 0.0),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_sharded_primitive_matches_the_reference_shard_map(ref, prims,
                                                           name):
    sharded, replicated, y_rtol, s_rtol = PRIMITIVES[name]
    want = ref.result()
    for i in sharded:
        got, w = _cat(prims, f"{name}.{i}"), want[f"{name}.{i}"]
        assert got.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got.astype(np.float64) - w).max())
        assert err <= y_rtol * scale, (name, i, err, scale)
    for i in replicated:
        got = _same_on_every_rank(prims, f"{name}.{i}")
        w = want[f"{name}.{i}"]
        assert got.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got.astype(np.float64) - w).max())
        assert err <= s_rtol * scale, (name, i, err, scale)


# sharded vs single-device, of max |y| and of max |state|: the scans'
# boundary composition is float32 rounding; the delayed reads of chorus
# and flanger move by an f32 step when the LFO's phase does by an ulp
EFFECT_RTOL = {"chorus": 1e-4, "flanger": 1e-4, "eq3": 1e-4}


@pytest.mark.parametrize("kind", sorted(fx.EFFECTS))
def test_effect_sharded_on_4_ranks_matches_one_device(prims, kind):
    single_ys, single_state = prims[0]["effects"][kind]["single"]
    rtol = EFFECT_RTOL.get(kind, 1e-5)
    for w in range(2):
        got = np.concatenate([p["effects"][kind]["sharded"][0][w]
                              for p in prims])
        want = single_ys[w]
        scale = float(np.abs(want).max())
        assert scale > 1e-3
        err = float(np.abs(got - want).max())
        assert err <= rtol * scale, (kind, w, err, scale)
    states = [p["effects"][kind]["sharded"][1] for p in prims]
    for s in states[1:]:
        np.testing.assert_array_equal(s, states[0])
    if single_state.size:
        scale = max(float(np.abs(single_state).max()), 1.0)
        err = float(np.abs(states[0] - single_state).max())
        assert err <= 1e-3 * scale, (kind, err)


@pytest.mark.parametrize("name", ["mesh", "c4"])
def test_render_took_the_sharded_path_and_stored_no_chain(renders, name):
    cg_windows = [r[name]["sharded_windows"] for r in renders]
    # 250 blocks: a 248-block window sharded and 2 alone (scan + render);
    # 63 blocks: 60 sharded and 3 alone
    assert cg_windows == [2 if name == "mesh" else 1] * N
    assert not any(r[name]["chain"] or r[name]["served"] for r in renders)
    assert renders[0][name]["collectives"] > 0


@pytest.mark.parametrize("name", ["mesh", "c4"])
def test_states_equal_on_every_rank_after_the_tail_window(renders, name):
    for r in renders[1:]:
        np.testing.assert_array_equal(r[name]["state"],
                                      renders[0][name]["state"])
        assert r[name]["t"] == renders[0][name]["t"] == 0


@pytest.mark.parametrize("name", ["mesh", "c4"])
def test_sharded_wav_matches_reference_and_single_rank(ref, renders, name):
    got = renders[0][name]["wav"]
    single = renders[0][name]["single_wav"]
    want = ref.result()[f"render_{name}"]
    assert got.shape == want.shape == single.shape
    assert np.abs(want).max() > 2 ** 14
    assert np.abs(got - want).max() <= RENDER_TOL
    assert np.abs(got - single).max() <= RENDER_TOL


@pytest.mark.parametrize("name", ["mesh", "c4"])
def test_termdaw_mesh_0_renders_single_device(renders, name):
    assert renders[0][name]["single_sharded_windows"] == 0


def test_sharded_render_gives_every_rank_the_window(renders):
    want = renders[0]["single_window"]
    assert want.shape == (64 * 256, 2)
    for r in renders:
        assert r["window_t"] == 64 * 256
        np.testing.assert_array_equal(r["window"], renders[0]["window"])
    # the band-pass's boundary composition: float32 rounding
    assert np.abs(renders[0]["window"] - want).max() <= \
        1e-5 * np.abs(want).max()


def test_a_state_handed_no_mesh_renders_alone_in_a_group(renders):
    """Only the caller's Mesh shards a State: one built without it inside
    the 4-rank world plans one device, shards no window and runs no
    collective."""
    for r in renders:
        assert r["alone"] == {"plan": (None, 1), "sharded_windows": 0,
                              "collectives": 0}


def test_a_state_and_its_mesh_share_a_device(tmp_path):
    _write_mesh_project(tmp_path)
    mesh = pmesh.Mesh(rank=0, size=2, device=torch.device("cuda", 0),
                      backend="nccl")
    with pytest.raises(ValueError, match="its mesh's rank renders on"):
        fixtures.load_state(tmp_path, torch.device("cpu"), mesh=mesh)


def test_scan_check_holds_the_sharded_scans_to_the_plain_ones():
    """tools/shard_render.scan_check (chip_smoke phase 18's primitives at
    c4's shard shapes) on 4 CPU ranks at a small T: every primitive within
    its bound of the plain scan over the whole input, no kernel launched,
    and shard offsets (rank*T) mod D != 0 on every feedback line."""
    rep = shard_render.scan_check(N, frames=(1500,), device="cpu")
    assert rep["backend"] == "gloo" and not rep["shared_card"]
    assert rep["primitives"] == 25
    got = rep["by_frames"]["1500"]
    assert set(got["kernels"]) == set(shard_render.SCAN_RTOL)
    for k, w in got["kernels"].items():
        assert w["rel"] <= shard_render.SCAN_RTOL[k], (k, w)
        assert w["state_rel"] <= shard_render.STATE_RTOL[k], (k, w)
    assert got["feedback_offsets_min_max"][0] > 0
    assert all(v == 0 for r in got["launches_by_rank"] for v in r.values())


def test_one_rank_world_takes_the_single_device_path(tmp_path):
    _write_mesh_project(tmp_path)
    (none, n, step, chunk), = launch(_one_rank_plan, 1, str(tmp_path),
                                     backend="gloo", device="cpu",
                                     timeout_s=120)
    assert none and n == 1 and step == chunk


def test_a_failing_rank_fails_the_launch():
    """Rank 1 raises between two collectives: the launch raises (rank 1's
    error, or rank 0's lost peer, whichever is joined first) well before
    its timeout, and no rank carries on."""
    t0 = time.monotonic()
    with pytest.raises(tmp_mp.ProcessRaisedException,
                       match="fails on purpose|by peer"):
        launch(_fail_on_rank_1, 2, backend="gloo", device="cpu",
               timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_transport_is_the_callers_choice():
    with pytest.raises(ValueError, match="gloo"):
        launch(_fail_on_rank_1, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError):
        launch(_fail_on_rank_1, 0, backend="gloo", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            launch(_fail_on_rank_1, 2, backend="gloo", device="cuda",
                   share_device=True)
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        pmesh.make_mesh("cpu")


def test_mesh_plan_without_a_process_group_is_single_device(tmp_path):
    _write_mesh_project(tmp_path)
    st = fixtures.load_state(tmp_path, torch.device("cpu"))
    assert st._mesh_plan() == (None, 1, render_chunk_blocks(st.cs))
    assert [st._pick_nb(left, 512, 4) for left in (1875, 339, 3)] == \
        [512, 336, 3]


def test_cli_under_a_launcher_shards_normalize_and_render(tmp_path):
    """Two CLI processes with a launcher's environment: rank 0 reads the
    workflow's commands from stdin, rank 1 follows; the normalize scan
    and the render shard over both, and the WAV matches a single-device
    scan + render of the project."""
    _write_mesh_project(tmp_path)
    port = pmesh._free_port()
    procs = []
    for rank in range(2):
        env = scrubbed_env(TERMDAW_SINK="null", RANK=str(rank),
                           WORLD_SIZE="2", LOCAL_RANK=str(rank),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "termdaw_tpu_torch", "--device", "cpu",
             str(tmp_path)], cwd=REPO, env=env, text=True,
            stdin=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        out0, _ = procs[0].communicate("normalize\nrender\nquit\n",
                                       timeout=180)
        out1, _ = procs[1].communicate(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[0].returncode == 0, out0[-2000:]
    assert procs[1].returncode == 0, out1[-2000:]
    assert "rendering on 2 ranks (gloo)" in out0
    assert out1.count("done rendering") == 1
    got, _ = fixtures.read_wav_ints(tmp_path / "out.wav")
    st = fixtures.load_state(tmp_path, torch.device("cpu"))
    st.output_file = str(tmp_path / "single.wav")
    st.scan_exact()
    st.render()
    want, _ = fixtures.read_wav_ints(tmp_path / "single.wav")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RENDER_TOL
