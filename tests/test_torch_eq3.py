"""The eq3's route and wrapper (termdaw_tpu_torch/ops/fx.py `_eq3_process`,
`eq3_crossover`, `eq3_plain`) on the CPU: CPU tensors take the plain
composition, the one the eq3 ran before it had a kernel, and return its
bits; under a mesh and on the exact biquad lane the router keeps that
composition on every device; the constants bind_static makes for the
kernel; the wrapper's checks, its launch counter and its work formula,
which a CPU window's count (utils/roofline.count_work) records in place
of the plain version's ops. The kernel itself (csrc/eq3.cu) is held to
the plain composition and to float64 on the card in
tests/test_torch_cuda.py. Imports nothing of JAX or termdaw_tpu."""

import contextlib

import numpy as np
import pytest
import torch

from benchmark.harness.work import _linear
from termdaw_tpu_torch.ops import filters, fx
from termdaw_tpu_torch.parallel.mesh import Mesh
from termdaw_tpu_torch.utils import roofline
from termdaw_tpu_torch.utils.fixtures import load_state, write_c4_project

CPU = torch.device("cpu")
SR = 48000
EQ3 = fx.EFFECTS["eq3"]


def _today(x, state, params, sr, static, mesh=None):
    """The eq3's process as it was before the fused kernel: the gains,
    then the LR4 tree as four biquad_apply stages and torch ops."""
    twenty = torch.full((), 20.0, dtype=torch.float32)
    g_lo = torch.pow(10.0, params["low_gain"] / twenty)
    g_mid = torch.pow(10.0, params["mid_gain"] / twenty)
    g_hi = torch.pow(10.0, params["high_gain"] / twenty)
    c_lo, c_hi = fx._eq3_coefs(sr, *fx._eq3_freqs(sr, static), x.device)
    xx = torch.cat([x, x], dim=1)
    t0, s0 = filters.biquad_apply(xx, c_lo, state["st0"], mesh)
    t1, s1 = filters.biquad_apply(t0, c_lo, state["st1"], mesh)
    low, upper = t1[:, 0:2], t1[:, 2:4]
    uu = torch.cat([upper, upper], dim=1)
    t2, s2 = filters.biquad_apply(uu, c_hi, state["st2"], mesh)
    t3, s3 = filters.biquad_apply(t2, c_hi, state["st3"], mesh)
    mid, high = t3[:, 0:2], t3[:, 2:4]
    y = low * g_lo + mid * g_mid + high * g_hi
    return y, {"st0": s0, "st1": s1, "st2": s2, "st3": s3}


def _setup(pair, seed=0):
    static = {"low_freq": pair[0], "high_freq": pair[1]}
    params = {k: torch.tensor(v, dtype=torch.float32) for k, v in
              (("low_gain", 4.0), ("mid_gain", -4.0), ("high_gain", 2.5))}
    return static, params, np.random.default_rng(seed)


def _windows(T, rng, n=3):
    return [torch.from_numpy((0.5 * rng.normal(size=(T, 2)))
                             .astype(np.float32)) for _ in range(n)]


def _chain(process, xs, static, params, **kw):
    state = EQ3.init_state(SR, static, CPU)
    outs = []
    for x in xs:
        y, state = process(x, state, params, SR, static, **kw)
        outs.append((y, state))
    return outs


def _assert_same(got, want):
    for (yg, sg), (yw, sw) in zip(got, want):
        assert torch.equal(yg, yw)
        assert sg.keys() == sw.keys()
        assert all(torch.equal(sg[k], sw[k]) for k in sg)


@pytest.mark.parametrize("pair", [(180.0, 4000.0), (100.0, 2500.0),
                                  (10.0, 0.35 * SR)],
                         ids=["c4", "c8", "edge"])
@pytest.mark.parametrize("T", [1, 2, 5, 1024, 3001])
def test_cpu_eq3_returns_todays_output_bit_for_bit(T, pair):
    """The eq3 on CPU tensors, three windows with the state carried, with
    the constants bind_static made and with bare static values: the
    router takes eq3_crossover, which runs the plain composition, and
    returns today's bits; no launch is counted."""
    static, params, rng = _setup(pair, seed=T)
    xs = _windows(T, rng)
    n0 = fx.eq3_launches
    want = _chain(_today, xs, static, params)
    _assert_same(_chain(EQ3.process, xs, static, params), want)
    bound = fx.bind_static(EQ3, SR, static, CPU)
    _assert_same(_chain(EQ3.process, xs, bound, params), want)
    assert fx.eq3_launches == n0
    assert float(want[-1][0].abs().max()) > 0.1


def _spies(monkeypatch):
    calls = []
    for name in ("eq3_crossover", "eq3_plain"):
        real = getattr(fx, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append((_name, args[-1] if _name == "eq3_plain" and
                           len(args) == 5 else kw.get("mesh")))
            return _real(*args, **kw)
        monkeypatch.setattr(fx, name, spy)
    return calls


@pytest.fixture
def one_rank(monkeypatch):
    """A 1-rank mesh with its all_gather standing in for the collective
    (what a world of one returns), so the sharded path runs in-process."""
    monkeypatch.setattr(filters, "all_gather", lambda x, mesh: x[None])
    return Mesh(rank=0, size=1, device=CPU, backend="gloo")


@pytest.mark.parametrize("case,route", [
    ("single", "eq3_crossover"), ("mesh", "eq3_plain"),
    ("exact_pinned", "eq3_plain"), ("exact_env", "eq3_plain"),
    ("env_but_pinned_off", "eq3_crossover")])
def test_router_takes_the_kernel_only_on_one_device_off_the_exact_lane(
        monkeypatch, one_rank, case, route):
    """One device with the parallel lane: eq3_crossover (on the CPU it
    runs eq3_plain with no mesh); a mesh, the exact lane pinned at build
    or asked for by TERMDAW_EXACT_BIQUAD with no pin: eq3_plain (with the
    mesh), the composition of today, whose output it returns bit for bit.
    A pin wins over the variable."""
    static, params, rng = _setup((150.0, 3000.0))
    xs = _windows(700, rng, n=2)
    mesh = one_rank if case == "mesh" else None
    monkeypatch.delenv("TERMDAW_EXACT_BIQUAD", raising=False)
    if case in ("exact_env", "env_but_pinned_off"):
        monkeypatch.setenv("TERMDAW_EXACT_BIQUAD", "1")
    pin = {"exact_pinned": True, "env_but_pinned_off": False}.get(case)
    scope = (contextlib.nullcontext() if pin is None
             else filters.exact_biquad_scope(pin))
    n0 = filters.biquad_seq_launches
    with scope:
        want = _chain(_today, xs, static, params, mesh=mesh)
        calls = _spies(monkeypatch)
        got = _chain(EQ3.process, xs, static, params, mesh=mesh)
    per_window = (["eq3_crossover", "eq3_plain"] if route == "eq3_crossover"
                  else ["eq3_plain"])
    assert [c[0] for c in calls] == per_window * 2
    assert all(c[1] is mesh for c in calls if c[0] == "eq3_plain")
    _assert_same(got, want)
    assert filters.biquad_seq_launches == n0  # CPU calls launch nothing


@pytest.mark.parametrize("pair", [(180.0, 4000.0), (10.0, 0.35 * SR),
                                  (250.0, 5000.0)])
def test_bind_static_makes_the_kernels_sections(pair):
    """bind_static's "sections" [2, 7, 4]: each crossover's b0, b1, b2 as
    the coefficients have them and its poles as biquad_apply computes
    them (filters.biquad_poles), the roots of z^2 + a1 z + a2."""
    bound = fx.bind_static(EQ3, SR, {"low_freq": pair[0],
                                     "high_freq": pair[1]}, CPU)
    sec = bound["sections"]
    assert sec.shape == (2, 7, 4) and sec.dtype == torch.float32
    assert sec.is_contiguous()
    for i, (b0, b1, b2, a1, a2) in enumerate(bound["coefs"]):
        assert torch.equal(sec[i, :3], torch.stack([b0, b1, b2]))
        poles = filters.biquad_poles(a1, a2, 4, CPU)
        assert all(torch.equal(sec[i, 3 + j], p) for j, p in enumerate(poles))
        p1 = torch.complex(sec[i, 3].double(), sec[i, 4].double())
        p2 = torch.complex(sec[i, 5].double(), sec[i, 6].double())
        torch.testing.assert_close((p1 + p2).real, -a1.double(), rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close((p1 * p2).real, a2.double(), rtol=0,
                                   atol=1e-6)
    # the lanes: lowpass on 0-1, highpass on 2-3 of each crossover
    assert torch.equal(sec[:, :, 0], sec[:, :, 1])
    assert torch.equal(sec[:, :, 2], sec[:, :, 3])


def _args(T=64):
    bound = fx.bind_static(EQ3, SR, fx.static_values(EQ3, EQ3.defaults), CPU)
    state = EQ3.init_state(SR, bound, CPU)
    db = tuple(torch.zeros(()) for _ in range(3))
    return [torch.zeros((T, 2)), state, db, bound["coefs"],
            bound["sections"]]


@pytest.mark.parametrize("bad,match", [
    (lambda a: a.__setitem__(0, torch.zeros((64, 3))), "must be"),
    (lambda a: a.__setitem__(0, torch.zeros((0, 2))), "must be"),
    (lambda a: a.__setitem__(0, torch.zeros((64, 2), dtype=torch.float64)),
     "float64"),
    (lambda a: a.__setitem__(1, dict(a[1], st1=torch.zeros((4, 2)))), "st1"),
    (lambda a: a.__setitem__(2, (0.0, a[2][1], a[2][2])), "low_gain"),
    (lambda a: a.__setitem__(4, a[4].transpose(1, 2).contiguous()
                             .transpose(1, 2)), "not contiguous"),
    (lambda a: a.__setitem__(4, a[4].to("meta")), "on meta"),
], ids=["width", "empty", "dtype", "state", "gain", "sections", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    args = _args()
    bad(args)
    n0 = fx.eq3_launches
    with pytest.raises((ValueError, TypeError), match=match):
        fx.eq3_crossover(*args)
    assert fx.eq3_launches == n0


def test_wrapper_refuses_an_unsupported_device():
    args = _args()
    args[0] = args[0].to("meta")
    args[1] = {k: v.to("meta") for k, v in args[1].items()}
    args[2] = tuple(g.to("meta") for g in args[2])
    args[4] = args[4].to("meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        fx.eq3_crossover(*args)


@pytest.mark.parametrize("T", [1, 1024, 384000])
def test_work_formula_is_the_benchmarks_count(T):
    """Four biquad stages over [T, 4] lanes, each read and written once:
    the eq3's count in benchmark/harness/work.py and work_mix.py."""
    want = [4 * v for v in _linear(T, 4, order=2)]
    assert list(fx.eq3_crossover_work(*_args(T))) == want
    assert want[1] == 128 * T


def test_cpu_window_count_records_the_kernel_formula(tmp_path):
    """window_cost of a c4 window on the CPU: the eq3 is one
    kernel:eq3_crossover record with its formula, and no complex scan or
    op of the plain composition is counted for it."""
    write_c4_project(tmp_path, 2.1, 8000, 32, render_sr=8000)
    st = load_state(tmp_path, CPU)
    nb = 512
    ops = st.compiled.window_cost(st.fb, nb)["ops"]
    T = nb * 32
    assert ops["kernel:eq3_crossover"] == [1, *fx.eq3_crossover_work(
        torch.empty((T, 2)), None, None, None, None)]
    assert "kernel:complex_affine_scan" not in ops
    args = _args(T)
    with roofline.count_work() as w:
        fx.eq3_crossover(*args)
    assert w.ops == {"kernel:eq3_crossover": [1, 64.0 * T, 128.0 * T]}
