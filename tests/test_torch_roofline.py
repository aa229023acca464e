"""The port's roofline accounting (termdaw_tpu_torch/utils/roofline.py and
CompiledGraph.window_cost) against the reference's
(termdaw_tpu/utils/roofline.py) on the same fixture projects, on the
CPU: the window loop, the resample's flops, the analytic floor and the
bound label equal the reference's; the counting rules on single ops and
on each kernel wrapper; window_cost's contract (no time, state, chain,
counter or program-cache change; a render after it bit-identical); and
config_roofline's counts without shares on the CPU."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from termdaw_tpu.config import Config
from termdaw_tpu.engine.state import State as RefState
from termdaw_tpu.utils import roofline as ref_roofline

from termdaw_tpu_torch.graph import compile as gc
from termdaw_tpu_torch.ops import filters, fx, scan, synthv, voices
from termdaw_tpu_torch.ops.adsr import hit_conf
from termdaw_tpu_torch.utils import roofline
from termdaw_tpu_torch.utils.fixtures import (
    load_state, read_wav_ints, sampsyn_window, synth_window,
    write_c1_project, write_c2_project, write_c3_project, write_c4_project,
    write_c5_project,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# 525 blocks of 32 frames at 8 kHz: one 512-block window and a 13-block
# tail, so every config has two window sizes
LENGTH, SR, BL = 2.1, 8000, 32
WRITERS = {
    "c1": lambda d: write_c1_project(d, LENGTH, SR, BL, render_sr=4000),
    "c2": lambda d: write_c2_project(d, LENGTH, SR, BL),
    "c3": lambda d: write_c3_project(d, LENGTH, SR, BL),
    "c4": lambda d: write_c4_project(d, LENGTH, SR, BL, render_sr=SR),
    "c5": lambda d: write_c5_project(d, LENGTH, SR, BL, n_tracks=4,
                                     hit_sr=16000, bd=16),
}
CFGS = sorted(WRITERS)


def _port(tmp_path, cfg) -> object:
    d = Path(tmp_path) / cfg
    packets = WRITERS[cfg](d) or b""
    return load_state(d, CPU, packets)


def _ref(d, monkeypatch) -> RefState:
    monkeypatch.setenv("TERMDAW_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TERMDAW_MESH", "0")
    st = RefState(Config.read(Path(d) / "project.toml"), str(d))
    st.refresh()
    assert st.loaded
    return st


@pytest.mark.parametrize("cfg", CFGS)
def test_window_counts_match_reference(tmp_path, monkeypatch, cfg):
    port = _port(tmp_path, cfg)
    ref = _ref(tmp_path / cfg, monkeypatch)
    got = roofline._window_counts(port)
    assert got == ref_roofline._window_counts(ref) == {512: 1, 13: 1}


def test_window_counts_none_under_a_mesh(tmp_path, monkeypatch):
    port = _port(tmp_path, "c1")
    ref = _ref(tmp_path / "c1", monkeypatch)
    monkeypatch.delenv("TERMDAW_MESH")
    port.mesh = SimpleNamespace(size=4)
    monkeypatch.setattr(ref, "_mesh_plan", lambda: (object(), 4, 512))
    assert roofline._window_counts(port) is None
    assert ref_roofline._window_counts(ref) is None


@pytest.mark.parametrize("cfg", ["c1", "c5"])
def test_resampler_flops_match_reference(tmp_path, monkeypatch, cfg):
    d = tmp_path / cfg
    if cfg == "c1":  # a 48 -> 44.1 kHz render resample
        write_c1_project(d, 0.2, 48000, 1024, render_sr=44100)
    else:            # rendered at the project rate
        write_c5_project(d, 0.2, 48000, 1024, n_tracks=2, hit_sr=96000)
    port = load_state(d, CPU)
    ref = _ref(d, monkeypatch)
    got = roofline._resampler_flops(port, 0.2)
    assert got == ref_roofline._resampler_flops(ref, 0.2)
    assert (got > 0) == (cfg == "c1")


def test_analytic_window_model_matches_reference(tmp_path, monkeypatch):
    port = _port(tmp_path, "c4")
    ref = _ref(tmp_path / "c4", monkeypatch)
    counts = roofline._window_counts(port)
    got = roofline._analytic_window_model(port.compiled, counts)
    assert got == ref_roofline._analytic_window_model(ref.compiled, counts)
    assert got[0] > 0 and got[1] > 0


# the reference's own cases (tests/test_bench.py:148-155), "mxu" read as
# "flops"
@pytest.mark.parametrize("flop_pct, hbm_pct, want", [
    (0.35, 0.96, "dispatch"),
    (0.07, 3.67, "hbm"),
    (0.12, 237.74, "estimate-unreliable"),
    (0.32, 187.07, "estimate-unreliable"),
    (150.0, 3.0, "estimate-unreliable"),
    (55.0, 12.0, "flops"),
    (1.9, 1.9, "dispatch"),
])
def test_bound_label(flop_pct, hbm_pct, want):
    assert roofline.bound_label(flop_pct, hbm_pct) == want
    ref_want = "mxu" if want == "flops" else want
    assert ref_roofline.bound_label(flop_pct, hbm_pct) == ref_want


def test_chip_peaks():
    assert roofline.chip_peaks("NVIDIA H100 80GB HBM3") == (67.0, 3350.0)
    assert roofline.chip_peaks("NVIDIA H200") == (67.0, 4800.0)
    assert roofline.chip_peaks("NVIDIA H100 PCIe") is None
    assert roofline.chip_peaks("NVIDIA A100-SXM4-80GB") is None
    assert roofline.chip_peaks(CPU) is None


def _single_op(kind: str):
    """(what the op returns, flops, bytes, op name) for one op on fresh
    inputs, counted."""
    g = torch.Generator().manual_seed(0)
    N, M, K, P = 1000, 7, 5, 3
    x, y = torch.rand(N, generator=g), torch.rand(N, generator=g)
    a, b = torch.rand(M, K, generator=g), torch.rand(K, P, generator=g)
    idx = torch.tensor([3, 1, 4, 1, 5, 9, 2, 6, 5, 3])
    with roofline.count_work() as w:
        out = {"add": lambda: x + y, "view": lambda: x.view(10, 100),
               "mm": lambda: a @ b, "gather": lambda: x[idx]}[kind]()
    return w, out, {
        "add": (N, 12 * N, "aten.add.Tensor"),
        "view": (0, 0, "aten.view.default"),
        "mm": (2 * M * P * K, 4 * (M * K + K * P + M * P), "aten.mm.default"),
        # 10 gathered f32 elements read, the int64 index, 10 written
        "gather": (0, 10 * 4 + 10 * 8 + 10 * 4, "aten.index.Tensor"),
    }[kind]


@pytest.mark.parametrize("kind", ["add", "view", "mm", "gather"])
def test_counting_rules_on_single_ops(kind):
    w, out, (flops, nbytes, name) = _single_op(kind)
    assert w.ops == {name: [1, flops, nbytes]}
    assert (w.flops, w.bytes) == (flops, nbytes)
    if kind == "add":  # x and y read, the sum returned
        assert w.memory(out) == {"arg_bytes": 8000, "out_bytes": 4000,
                                 "temp_bytes": 0}


def test_count_work_refuses_a_capture_and_a_nested_count(monkeypatch):
    with roofline.count_work():
        with pytest.raises(RuntimeError, match="already active"):
            with roofline.count_work():
                pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        with roofline.count_work():
            pass


def _wrapper_call(name: str, rng):
    """(wrapper, args, the formula's (flops, bytes)) of one kernel wrapper
    on CPU tensors."""
    T, C = 300, 3

    def f32(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    if name == "affine_scan":
        args = (f32(T, C), f32(C, lo=0.5, hi=0.9), f32(C))
        return scan.affine_scan, args, (2 * T * C, (2 * T * C + 2 * C) * 4)
    if name == "max_decay_scan":
        args = (f32(T, C, lo=0.0), f32(C, lo=0.5, hi=0.9), f32(C, lo=0.0))
        return scan.max_decay_scan, args, (2 * T * C, (2 * T * C + 2 * C) * 4)
    if name == "complex_affine_scan":
        args = (f32(T, C), f32(T, C), f32(C, lo=0.1, hi=0.5),
                f32(C, lo=0.1, hi=0.5), f32(C), f32(C))
        return (scan.complex_affine_scan, args,
                (8 * T * C, (4 * T * C + 4 * C) * 4))
    if name == "voice_mix_stereo":
        nb, bl, P, L = 6, 32, 4, 100
        padded = voices.make_padded_sample(f32(L, 2), bl)
        begins = torch.from_numpy(
            rng.integers(0, L + bl + 1, (nb, P)).astype(np.int32))
        args = (padded, begins, f32(nb, P), f32(nb, P), nb, bl)
        ins = (padded.numel() + 3 * nb * P) * 4
        return (voices.voice_mix_stereo, args,
                (2 * nb * P * bl * 2, ins + nb * bl * 2 * 4))
    if name == "sampsyn":
        nb, bl, P, N, K, W = 6, 32, 4, 9, 2, 64
        bake, frames, ib, times, waves = sampsyn_window(
            CPU, nb, bl, P, N, K=K, W=W, seed=int(rng.integers(1 << 30)))
        args = (bake, frames, nb, bl, hit_conf(0.01, 0.1, 0.8, 5.0, 0.2, 0.5),
                times, waves, ib)
        # the int64 frames; ib, the table, idx, six note columns and two
        # [nb, N] clocks, 4 bytes each
        ins = nb * bl * 8 + (bl + K + K * W + nb * P + 6 * N + 2 * nb * N) * 4
        return synthv.sampsyn, args, (28 * nb * bl * P, ins + nb * bl * 2 * 4)
    if name == "synth":
        nb, bl, P, N = 6, 32, 4, 9
        bake, frames, time2d, ib = synth_window(
            CPU, nb, bl, P, N, seed=int(rng.integers(1 << 30)))
        note = hit_conf(0.01, 0.1, 0.8, 5.0, 0.2, 0.5)
        args = (bake, frames, nb, bl, 0.4, 0.3,
                hit_conf(0.001, 0.02, 0.0, 0.0, 0.0, 0.0), 1.0, 0.8, note,
                0.5, note, time2d, ib)
        # the int64 frames; time2d, ib, idx, six note columns and two
        # [nb, N] clocks, 4 bytes each; all three oscillators on
        ins = nb * bl * 8 + (nb * bl + bl + nb * P + 6 * N + 2 * nb * N) * 4
        return synthv.synth, args, (59 * nb * bl * P, ins + nb * bl * 2 * 4)
    if name == "eq3_crossover":
        eff = fx.EFFECTS["eq3"]
        static = fx.bind_static(eff, 48000, {"low_freq": 150.0,
                                             "high_freq": 3000.0}, CPU)
        state = {k: f32(4, 4) for k in ("st0", "st1", "st2", "st3")}
        db = tuple(f32(lo=-4.0, hi=4.0) for _ in range(3))
        args = (f32(T, 2), state, db, static["coefs"], static["sections"])
        # four biquad stages over [T, 4] lanes (the benchmark's work model)
        return fx.eq3_crossover, args, (4 * 16 * T, 4 * 32 * T)
    coefs = tuple(f32(C, lo=-0.5, hi=0.5) for _ in range(5))
    args = (f32(T, C), coefs, f32(4, C))
    return (filters.biquad_apply_sequential, args,
            (9 * T * C, (2 * T * C + 5 * C + 2 * 4 * C) * 4))


@pytest.mark.parametrize("name", [
    "affine_scan", "max_decay_scan", "complex_affine_scan",
    "voice_mix_stereo", "biquad_apply_sequential", "sampsyn",
    "eq3_crossover", "synth"])
def test_kernel_wrapper_records_its_formula(name):
    fn, args, (flops, nbytes) = _wrapper_call(name, np.random.default_rng(1))
    want = fn(*args)
    with roofline.count_work() as w:
        got = fn(*args)
    # its formula and none of the plain version's ops
    assert w.ops == {f"kernel:{name}": [1, flops, nbytes]}
    for g, h in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, h)
    work = getattr(sys.modules[fn.__module__], f"{name}_work")
    assert work(*args) == (flops, nbytes)


def _leaves(cg):
    return [t.clone() for t in tree_leaves(cg.num_state)
            if isinstance(t, torch.Tensor)]


def _snapshot(st):
    """Everything window_cost must leave as it was."""
    cg = st.compiled
    pre = cg._prebaked
    return {
        "t": cg.t, "fb": st.fb.frame,
        "carries": dict(cg.carries), "unfresh": set(cg._unfresh),
        "chains": (id(pre), pre and pre["expect"],
                   [(id(r), r["expect"]) for r in cg._recorded],
                   id(cg._rec_active), cg._prebake_used),
        "counters": (cg.live_bakes, cg.served_windows, cg.captures,
                     cg.replays),
        "programs": list(gc._PROGRAM_CACHE),
        "caps": {k: dict(v) for k, v in cg.bake_caps.items()},
        "hwm": dict(gc._CAP_HWM), "ttab": id(cg._ttab),
    }


@pytest.mark.parametrize("cfg", CFGS)
def test_window_cost_leaves_the_graph_as_it_was(tmp_path, cfg):
    """The contract of the reference's TestWindowCost
    (tests/test_bake_caps.py:389-411) and the port's own: mid-render, after
    a window served from the chain, each window size's cost is positive and
    nothing window_cost must not touch moved; the next window is still
    served."""
    st = _port(tmp_path, cfg)
    cg = st.compiled
    counts = roofline._window_counts(st)
    _, _, step = st._mesh_plan()
    cg.seed_caps(st.fb, st.cs, step)
    cg.render_window(st.fb, 512)
    # served from the chain seed_caps stored (c1 has no event vertex: none)
    chained = cg.served_windows
    assert chained == (cfg != "c1")
    st.fb.advance_blocks(512)
    before, state = _snapshot(st), _leaves(cg)
    for nb in counts:
        ca = cg.window_cost(st.fb, nb)
        assert ca["flops"] > 0 and ca["bytes accessed"] > 0
        assert ca["source"] == "torch_dispatch_count"
        mem = ca["_mem"]
        assert mem["arg_bytes"] > 0 and mem["temp_bytes"] > 0
        assert mem["out_bytes"] >= nb * BL * 2 * 4  # the audio at least
        assert "peak_bytes" not in mem  # the card's only
        assert sum(r[1] for r in ca["ops"].values()) == ca["flops"]
    assert _snapshot(st) == before
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cg), state))
    cg.render_window(st.fb, 13)
    assert cg.served_windows == 2 * chained


def test_c4_render_after_window_cost_is_bit_identical(tmp_path):
    """window_cost before the first render (no caps seeded yet) and between
    two renders changes nothing a render writes."""
    a = _port(tmp_path / "a", "c4")
    b = _port(tmp_path / "b", "c4")
    wavs = {"a": [], "b": []}
    for st, name in ((a, "a"), (b, "b")):
        for _ in range(2):
            if st is a:
                for nb in roofline._window_counts(st):
                    st.compiled.window_cost(st.fb, nb)
            st.render()
            wavs[name].append(read_wav_ints(
                tmp_path / name / "c4" / "outp.wav")[0])
    for got, want in zip(wavs["a"], wavs["b"]):
        assert np.array_equal(got, want)


def test_config_roofline_on_the_cpu(tmp_path):
    """Positive counts, the resample's flops added, and no shares: the CPU
    has no peaks (the reference's tests/test_bench.py:133-135)."""
    st = _port(tmp_path, "c1")
    st.render()
    out = roofline.config_roofline(st, 0.05, LENGTH)
    for k in ("gflops_per_s", "hbm_gbps_logical", "window_gflops",
              "window_gbytes_logical", "hbm_gbps_phys_est",
              "window_gbytes_phys_est"):
        assert out[k] > 0, k
    assert out["source"] == "torch_dispatch_count"
    assert out["peaks"] is None and out["card"] == "cpu"
    for k in ("flop_util_pct", "hbm_util_pct", "hbm_util_pct_phys_est",
              "bound", "peak_hbm_window_mb"):
        assert k not in out
    windows = sum(st.compiled.window_cost(st.fb, nb)["flops"] * n
                  for nb, n in roofline._window_counts(st).items())
    assert out["window_gflops"] * 1e9 == pytest.approx(
        windows + roofline._resampler_flops(st, LENGTH), rel=1e-12)
    assert st.compiled.get_time() == 0 and st.fb.frame == 0
