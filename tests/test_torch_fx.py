"""The port's native effects (termdaw_tpu_torch/ops/fx.py), their scans
(ops/scan.py) and building blocks (ops/filters.py), and the PluginHost,
against the JAX reference on the same numpy inputs, on the CPU.

The JAX side is jitted as tests/test_fx.py runs it. Tolerances: the
effects within 1e-5 * max(1, max |y|) (eq3 1e-4: four cascaded biquad
stages near the unit circle, scanned in another association order); the
scans within the reference tests' bounds of a float64 recurrence.

Chorus and flanger read x at fractional f32 positions near M + T, whose
one-ulp steps are about 1.2e-4 samples here. XLA fuses the LFO's
multiply-adds and its sin differs from torch's by an ulp, so a read
position can round one ulp apart, which moves the output by up to
ulp(position) * |x[t+1] - x[t]|. Those two effects take a smooth input
(slope under 0.05 a frame) for the 1e-5 check, and a separate test holds
them on the noisy input to that position bound."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from termdaw_tpu.engine.plugins import AddPluginError as RefAddPluginError
from termdaw_tpu.engine.plugins import PluginHost as RefPluginHost
from termdaw_tpu.ops import filters as rfilt
from termdaw_tpu.ops import fx as rfx

from termdaw_tpu_torch import kernels
from termdaw_tpu_torch.engine.plugins import AddPluginError, PluginHost
from termdaw_tpu_torch.ops import filters, fx, scan

torch.set_num_threads(1)

SR = 8000
CPU = torch.device("cpu")

NON_DEFAULT = {
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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _leaves(tree):
    """The arrays of a state tree (dicts in key order, tuples in order)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for v in tree for a in _leaves(v)]
    return [np.asarray(tree)]


def _signal(T, seed, smooth=False):
    """Noise bursts over two sines: loud enough to drive the compressor
    above its threshold, with quiet stretches for its release. `smooth`:
    two low sines only, at most 0.05 apart from frame to frame."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SR
    if smooth:
        return (0.4 * np.sin(2 * np.pi * 110 * t)[:, None] + 0.3 * np.sin(
            2 * np.pi * 37 * t[:, None] + np.asarray([0.0, 1.0]))
        ).astype(np.float32)
    tone = 0.4 * np.sin(2 * np.pi * 220 * t)[:, None] + 0.2 * np.sin(
        2 * np.pi * 1900 * t[:, None] + np.asarray([0.0, 1.0]))
    gate = (np.sin(2 * np.pi * 3 * t) > 0)[:, None]
    return (tone + 0.5 * gate * rng.normal(size=(T, 2))).astype(np.float32)


def _run_both(kind, params, x, bounds):
    """The reference effect and the port's over consecutive windows of x
    (state carried): [(want, got, ref state, port state)] per window."""
    ref_eff, eff = rfx.EFFECTS[kind], fx.EFFECTS[kind]
    assert eff.defaults == ref_eff.defaults
    assert eff.static_params == ref_eff.static_params
    p = dict(eff.defaults)
    if params == "non_default":
        p.update(NON_DEFAULT[kind])
    static = fx.static_values(eff, p)
    assert static == rfx.static_values(ref_eff, p)
    rp = {k: jnp.float32(v) for k, v in p.items()
          if k not in eff.static_params}
    tp = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()
          if k not in eff.static_params}
    rfn = jax.jit(lambda x, st, pp: ref_eff.process(x, st, pp, SR, static))
    rst = ref_eff.init_state(SR, static)
    pst = eff.init_state(SR, static, CPU)
    assert [a.shape for a in _leaves(rst)] == [a.shape for a in
                                               _leaves(pst)]
    out = []
    for lo, hi in bounds:
        want, rst = rfn(jnp.asarray(x[lo:hi]), rst, rp)
        got, pst = eff.process(_t(x[lo:hi]), pst, tp, SR, static)
        assert got.shape == want.shape == (hi - lo, 2)
        out.append((np.asarray(want), got.numpy(), rst, pst))
    return out


WINDOWS = ((0, 1200), (1200, 2900))
READS = ("chorus", "flanger")  # fractional delayed reads


@pytest.mark.parametrize("params", ["default", "non_default"])
@pytest.mark.parametrize("kind", sorted(rfx.EFFECTS))
def test_effect_matches_reference_over_two_windows(kind, params):
    rtol = 1e-4 if kind == "eq3" else 1e-5
    x = _signal(2900, 3, smooth=kind in READS)
    for want, got, rst, pst in _run_both(kind, params, x, WINDOWS):
        assert got.dtype == np.float32
        assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
        atol = rtol * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        for g, w in zip(_leaves(pst), _leaves(rst)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=rtol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("kind", READS)
def test_delayed_reads_on_noise_within_the_position_bound(kind):
    """On the noisy input the reads agree to ulp(M + T) * max slope, the
    rounding step of an f32 read position (module docstring)."""
    x = _signal(2900, 3)
    M = fx.EFFECTS[kind].init_state(SR, {}, CPU)["tail"].shape[0]
    slope = np.abs(np.diff(x, axis=0)).max()
    bound = float(np.spacing(np.float32(M + 1700))) * slope + 1e-5
    for want, got, _, _ in _run_both(kind, "non_default", x, WINDOWS):
        assert np.abs(got - want).max() <= bound


def test_lfo_sine_is_correctly_rounded():
    """The chorus's and flanger's LFO sine (fx._lfo_sin) is the f32
    rounding of the float64 sine on every phase they take ([0, 2*pi) plus
    a voice offset under 4*pi/3), so the CPU and a CUDA card agree on it
    (torch's f32 sin differs between them by an ulp)."""
    ph = np.random.default_rng(5).uniform(0, 10.5, 200000).astype(np.float32)
    ph[:3] = [0.0, np.float32(math.pi), np.float32(2 * math.pi)]
    want = np.sin(ph.astype(np.float64)).astype(np.float32)
    got = fx._lfo_sin(torch.from_numpy(ph)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _feedback64(x, tail, g, D):
    y = np.zeros(x.shape, np.float64)
    hist = np.concatenate([tail.astype(np.float64), y])
    for t in range(len(x)):
        hist[D + t] = x[t] + g * hist[t]
    return hist[D:], hist[-D:]


@pytest.mark.parametrize("T,D", [(300, 37), (20, 37), (37, 37), (1, 5)])
def test_feedback_line_matches_reference_and_float64(T, D):
    """T > D, T < D (the new tail reaches into the old one), T == D and a
    one-frame window, from a non-zero tail."""
    rng = np.random.default_rng(T * 7 + D)
    x = rng.normal(size=(T, 2)).astype(np.float32)
    tail = rng.normal(size=(D, 2)).astype(np.float32)
    g = 0.7
    want, wtail = jax.jit(lambda x, t: rfx.feedback_line(x, t, g, D))(
        jnp.asarray(x), jnp.asarray(tail))
    got, gtail = fx.feedback_line(_t(x), _t(tail), torch.tensor(g), D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gtail.numpy(), np.asarray(wtail), rtol=0,
                               atol=1e-5)
    y64, tail64 = _feedback64(x, tail, np.float64(np.float32(g)), D)
    np.testing.assert_allclose(got.numpy(), y64, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gtail.numpy(), tail64, rtol=0, atol=1e-4)


def test_feedback_line_chains_across_windows():
    x = np.random.default_rng(4).normal(size=(256, 2)).astype(np.float32)
    D, g = 31, 0.6
    full, _ = fx.feedback_line(_t(x), torch.zeros(D, 2), g, D)
    tail = torch.zeros(D, 2)
    parts = []
    for lo, hi in ((0, 20), (20, 64), (64, 100), (100, 256)):
        y, tail = fx.feedback_line(_t(x[lo:hi]), tail, g, D)
        parts.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(parts), full.numpy(), rtol=0,
                               atol=1e-5)


def _max_decay64(x, r, y0):
    y = np.empty(x.shape, np.float64)
    prev = y0.astype(np.float64)
    for t in range(len(x)):
        prev = np.maximum(x[t], r * prev)
        y[t] = prev
    return y


# 1791-1793: the edge of kernels.scan_plan's 1792-frame tile at one lane
@pytest.mark.parametrize("T,C", [(1, 1), (200, 1), (3000, 2), (1791, 1),
                                 (1792, 1), (1793, 1)])
def test_max_decay_scan_plain_matches_reference_and_float64(T, C):
    rng = np.random.default_rng(T + C)
    x = np.abs(rng.normal(size=(T, C))).astype(np.float32)
    x[::97] *= 4.0  # peaks
    r = np.asarray([0.95, 0.9995][:C], np.float32)
    y0 = np.asarray([2.0, 0.0][:C], np.float32)
    want = jax.jit(rfx.max_decay_scan)(jnp.asarray(x), jnp.asarray(r),
                                       jnp.asarray(y0))
    got = scan.max_decay_scan(_t(x), _t(r), _t(y0))
    assert scan.max_decay_launches == 0  # CPU tensors run the plain form
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    y64 = _max_decay64(x, r.astype(np.float64), y0)
    np.testing.assert_allclose(got.numpy(), y64, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(y64).max()))


def test_max_decay_scan_plain_holds_a_long_slow_decay():
    """A 250 ms release at 48 kHz (r = 0.99992) decaying from one peak
    over 100,003 frames: the decay products are exact, so the plain form
    stays within 1e-6 of max |y| of a float64 recurrence (float32 products
    drifted 3.4e-5 at a c4 window)."""
    rng = np.random.default_rng(8)
    x = (0.01 * np.abs(rng.normal(size=(100003, 1)))).astype(np.float32)
    x[5, 0] = 3.0
    r = np.exp(np.float32(-1.0) / np.float32(250 * 0.001 * 48000)).reshape(1)
    y0 = np.zeros(1, np.float32)
    got = scan.max_decay_scan_plain(_t(x), _t(r), _t(y0)).numpy()
    y64 = _max_decay64(x, r.astype(np.float64), y0)
    np.testing.assert_allclose(got, y64, rtol=0,
                               atol=1e-6 * np.abs(y64).max())


def test_max_decay_scan_propagates_nan_and_keeps_negative_values():
    """NaN propagates as jnp.maximum does; values below the -3e38 identity's
    reach (large negative inputs) still come through."""
    x = np.full((2500, 1), -5.0, np.float32)
    x[1500, 0] = np.nan
    r = np.asarray([0.5], np.float32)
    y0 = np.asarray([-1e30], np.float32)
    want = np.asarray(rfx.max_decay_scan(jnp.asarray(x), jnp.asarray(r),
                                         jnp.asarray(y0)))
    got = scan.max_decay_scan_plain(_t(x), _t(r), _t(y0)).numpy()
    assert np.isnan(got[1500:]).all() and not np.isnan(got[:1500]).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _complex64(f, p, s):
    u = np.empty(f.shape, np.complex128)
    prev = s.astype(np.complex128)
    for t in range(len(f)):
        prev = p * prev + f[t]
        u[t] = prev
    return u


@pytest.mark.parametrize("T,C", [(1, 1), (700, 2), (3000, 4)])
def test_complex_affine_scan_plain_matches_reference_and_float64(T, C):
    """Poles of the eq3 crossovers near the unit circle (a 100 Hz pair at
    48 kHz), a real pole and a decaying oscillator."""
    rng = np.random.default_rng(10 * T + C)
    b = filters.biquad_coefs("lowpass", 100.0, 48000)
    a1, a2 = b[3], b[4]
    pole = (-a1 + 1j * math.sqrt(4 * a2 - a1 * a1)) / 2
    p = np.asarray([pole, 0.9 + 0.3j, 0.5, -0.7 + 0.1j][:C], np.complex64)
    f_r, f_i = (rng.normal(size=(T, C)).astype(np.float32) for _ in "ri")
    s = (rng.normal(size=C) + 1j * rng.normal(size=C)).astype(np.complex64)
    args = (f_r, f_i, p.real.copy(), p.imag.copy(), s.real.copy(),
            s.imag.copy())
    wr, wi, _, _ = jax.jit(
        lambda *a: rfilt._first_order_complex(*a, None))(
        *(jnp.asarray(a) for a in args))
    gr, gi = scan.complex_affine_scan(*(_t(a) for a in args))
    scale = max(1.0, np.abs(np.asarray(wr)).max(),
                np.abs(np.asarray(wi)).max())
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0,
                               atol=1e-5 * scale)
    u64 = _complex64(f_r + 1j * f_i.astype(np.float64), p.astype(
        np.complex128), s)
    np.testing.assert_allclose(gr.numpy() + 1j * gi.numpy(), u64, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(u64).max()))


# the scans' shapes in a c4 window at 48 kHz: eq3 stage, band-pass,
# reverb damping, compressor smoothing and peak follower, longest and
# shortest comb, longest allpass, delay; and edge shapes, the max-decay's
# among them (its card tests' wide rows and tile edges)
@pytest.mark.parametrize("T,C,op", [
    (384000, 4, "complex"), (384000, 4, "affine"), (384000, 2, "affine"),
    (384000, 1, "affine"), (384000, 1, "max_decay"), (216, 1785, "affine"),
    (317, 1215, "affine"), (1568, 490, "affine"), (67, 11520, "affine"),
    (1, 1, "affine"), (1, 1, "complex"), (5, 3, "complex"),
    (4097, 33, "complex"), (1, 1, "max_decay"), (1025, 4, "max_decay"),
    (67, 1785, "max_decay"), (4097, 33, "max_decay"), (1025, 64, "max_decay"),
    (2 * 1792 + 1, 1, "max_decay"), (384000, 4, "eq3"), (1, 4, "eq3"),
    (1472, 4, "eq3"), (1473, 4, "eq3"), (100003, 4, "eq3")])
def test_scan_plan_tiles_cover_the_scan_within_shared_memory(T, C, op):
    """kernels.scan_plan, which the tiled kernels take their tiling from:
    the tiles cover [T, C]; a CTA fits 48 KB of shared memory with the
    per-warp totals; runs are odd below 32 lanes (bank-conflict free);
    one c4 window of the eq3 or band-pass fills the card's 132 SMs, and
    the compressor's one lane spreads over 215 tiles of 1792 frames; the
    delay line is one tile; scratch holds each tile's B per lane."""
    p = kernels.scan_plan(T, C, op)
    planes, total_bytes = kernels.SCAN_OPS[op]
    assert (planes, total_bytes) == {"affine": (1, 16), "max_decay": (1, 16),
                                     "complex": (2, 32), "eq3": (1, 80)}[op]
    agg = {"eq3": 4}.get(op, planes)  # planes of each tile's total
    assert p.cl >= min(C, 32) and p.cl & (p.cl - 1) == 0 and p.cl <= 32
    assert p.s == (kernels.SCAN_THREADS // p.cl) * p.k
    assert p.tiles == -(-T // p.s) and p.lane_tiles * p.cl >= C
    assert p.smem == kernels.SCAN_THREADS * p.k * 4 * planes
    assert p.smem + 8 * p.cl * total_bytes <= kernels.SCAN_SHARED_BYTES
    assert p.cl == 32 or p.k % 2 == 1
    assert p.scratch == (agg * p.tiles * C if p.tiles > 1 else 0)
    if T == 384000 and C == 4:
        assert p.tiles * p.lane_tiles >= 132
    if (T, C, op) == (384000, 1, "max_decay"):
        assert (p.cl, p.k, p.s, p.tiles) == (1, 7, 1792, 215)
    if (T, C, op) == (1025, 4, "max_decay"):
        assert (p.k, p.tiles) == (17, 1)  # the shortest run of one tile
    if (T, C) == (67, 11520):
        assert p.tiles == 1
    if op == "eq3" and T >= 1472:  # an eq3 stage: runs of 23, 1472 frames
        assert (p.cl, p.k, p.s) == (4, 23, 1472)


def test_kernel_build_key_hashes_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by its source, every csrc/*.cuh and the flags:
    editing a header names a new library, so a stale one is not loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in kernels.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {n: kernels._lib_path(n) for n in kernels.KERNELS}
    header = csrc / "scan_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: kernels._lib_path(n) for n in kernels.KERNELS}
    assert all(before[n] != after[n] for n in kernels.KERNELS)
    assert after == {n: kernels._lib_path(n) for n in kernels.KERNELS}
    # the three tiled scans are built on the header
    for n in ("affine_scan", "max_decay_scan", "complex_scan"):
        assert '#include "scan_tile.cuh"' in (csrc / f"{n}.cu").read_text()


def _biquad64(x, coefs, state):
    b0, b1, b2, a1, a2 = (np.float64(np.float32(c)) for c in coefs)
    x1, x2, y1, y2 = (state[i].astype(np.float64) for i in range(4))
    y = np.empty(x.shape, np.float64)
    for t in range(len(x)):
        yt = b0 * x[t] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        x2, x1, y2, y1 = x1, x[t].astype(np.float64), y1, yt
        y[t] = yt
    return y


@pytest.mark.parametrize("lens", [(1, 1, 1), (2, 1, 700), (2048, 1500)])
def test_biquad_apply_matches_reference_and_float64(lens):
    """A 4-channel section (lowpass and highpass at 180 Hz and 4 kHz,
    48 kHz) over consecutive windows, one-frame windows included, within
    1e-4 of max |y| (the eq3 bound; both parallel forms measure about
    2e-5 from a float64 recurrence on the 180 Hz channels)."""
    sr = 48000
    cs = [filters.biquad_coefs(k, f, sr) for k, f in (
        ("lowpass", 180.0), ("highpass", 180.0), ("lowpass", 4000.0),
        ("highpass", 4000.0))]
    for c, k, f in zip(cs, ("lowpass", "highpass") * 2,
                       (180.0, 180.0, 4000.0, 4000.0)):
        assert c == rfilt.biquad_coefs(k, f, sr)
    coefs = np.asarray(cs, np.float32).T  # [5, 4]
    x = np.random.default_rng(sum(lens)).normal(
        size=(sum(lens), 4)).astype(np.float32)
    rcoefs = tuple(jnp.asarray(c) for c in coefs)
    tcoefs = tuple(_t(c) for c in coefs)
    rst = rfilt.biquad_init_state(4)
    pst = filters.biquad_init_state(4, CPU)
    assert pst.shape == rst.shape
    rfn = jax.jit(lambda x, s: rfilt.biquad_apply(x, rcoefs, s))
    outs, lo = [], 0
    for n in lens:
        want, rst = rfn(jnp.asarray(x[lo:lo + n]), rst)
        got, pst = filters.biquad_apply(_t(x[lo:lo + n]), tcoefs, pst)
        scale = max(1.0, np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(pst.numpy(), np.asarray(rst), rtol=0,
                                   atol=1e-4 * scale)
        outs.append(got.numpy())
        lo += n
    y64 = np.stack([_biquad64(x[:, c], coefs[:, c], np.zeros((4,)))
                    for c in range(4)], axis=1)
    np.testing.assert_allclose(np.concatenate(outs), y64, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(y64).max()))


def _eq3_section_coefs(sr=48000):
    """The c4 eq3's stage coefficients, [5, 4] f32: lowpass and highpass
    at the 180 Hz and 4 kHz crossovers."""
    cs = [filters.biquad_coefs(k, f, sr) for k, f in (
        ("lowpass", 180.0), ("highpass", 180.0), ("lowpass", 4000.0),
        ("highpass", 4000.0))]
    return np.asarray(cs, np.float32).T


def _biquad_f32_loop(x, coefs, state):
    """An independent float32 loop, one channel and one frame at a time,
    each product and sum rounded to float32 on its own."""
    f = np.float32
    y = np.empty(x.shape, np.float32)
    out = np.empty((4, x.shape[1]), np.float32)
    for c in range(x.shape[1]):
        b0, b1, b2, a1, a2 = (f(v) for v in coefs[:, c])
        x1, x2, y1, y2 = (f(v) for v in state[:, c])
        for t in range(x.shape[0]):
            xt = f(x[t, c])
            acc = f(f(b0 * xt) + f(b1 * x1))
            acc = f(acc + f(b2 * x2))
            acc = f(acc - f(a1 * y1))
            acc = f(acc - f(a2 * y2))
            y[t, c] = acc
            x2, x1, y2, y1 = x1, xt, y1, acc
        out[:, c] = (x1, x2, y1, y2)
    return y, out


@pytest.mark.parametrize("lens", [(1, 1, 1), (2, 1, 700), (2048, 1500)])
def test_exact_lane_is_bit_exact_to_a_float32_loop(lens):
    """The plain exact lane over consecutive windows (one-frame windows
    included, the state carried) equals an independent float32 loop bit
    for bit, output and state."""
    coefs = _eq3_section_coefs()
    rng = np.random.default_rng(len(lens) + sum(lens))
    x = rng.normal(size=(sum(lens), 4)).astype(np.float32)
    st0 = rng.normal(size=(4, 4)).astype(np.float32)
    want, want_st = _biquad_f32_loop(x, coefs, st0)
    pst, outs, lo = _t(st0), [], 0
    for n in lens:
        got, pst = filters.biquad_apply_sequential(
            _t(x[lo:lo + n]), tuple(_t(c) for c in coefs), pst)
        outs.append(got.numpy())
        lo += n
    np.testing.assert_array_equal(np.concatenate(outs), want)
    np.testing.assert_array_equal(pst.numpy(), want_st)


def test_exact_lane_within_5e5_of_float64():
    """The reference's gate (tests/test_fx.py:76-97): a lowpass at 800 Hz,
    48 kHz, over 4096 frames of noise within 5e-5 absolute of float64,
    scalar coefficients broadcast; and the c4 eq3 sections (the 180 Hz
    poles lie near the unit circle) within 5e-5 of max |y|."""
    rng = np.random.default_rng(76)
    x = rng.normal(size=(4096, 2)).astype(np.float32)
    c = filters.biquad_coefs("lowpass", 800.0, 48000)
    y, _ = filters.biquad_apply_sequential(
        _t(x), c, filters.biquad_init_state(2, CPU))
    coefs = np.tile(np.asarray(c, np.float32)[:, None], (1, 2))
    y64 = np.stack([_biquad64(x[:, k], coefs[:, k], np.zeros((4,)))
                    for k in range(2)], axis=1)
    np.testing.assert_allclose(y.numpy(), y64, rtol=0, atol=5e-5)
    coefs = _eq3_section_coefs()
    x4 = rng.normal(size=(4096, 4)).astype(np.float32)
    y4, _ = filters.biquad_apply_sequential(
        _t(x4), tuple(_t(c) for c in coefs), filters.biquad_init_state(4, CPU))
    y64 = np.stack([_biquad64(x4[:, k], coefs[:, k], np.zeros((4,)))
                    for k in range(4)], axis=1)
    np.testing.assert_allclose(y4.numpy(), y64, rtol=0,
                               atol=5e-5 * np.abs(y64).max())


# XLA's CPU backend may contract the reference's lane into FMAs, so the
# two lanes are held to each other at this bound, relative to max |y|
EXACT_VS_REFERENCE_RTOL = 2e-5


@pytest.mark.parametrize("lens", [(1, 1, 1), (2048, 1500)])
def test_exact_lane_matches_reference_lane(lens):
    coefs = _eq3_section_coefs()
    rng = np.random.default_rng(sum(lens))
    x = rng.normal(size=(sum(lens), 4)).astype(np.float32)
    rcoefs = tuple(jnp.asarray(c) for c in coefs)
    rfn = jax.jit(lambda x, s: rfilt.biquad_apply_sequential(x, rcoefs, s))
    rst = rfilt.biquad_init_state(4)
    pst = filters.biquad_init_state(4, CPU)
    lo = 0
    for n in lens:
        want, rst = rfn(jnp.asarray(x[lo:lo + n]), rst)
        got, pst = filters.biquad_apply_sequential(
            _t(x[lo:lo + n]), tuple(_t(c) for c in coefs), pst)
        tol = EXACT_VS_REFERENCE_RTOL * max(1.0, np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(pst.numpy(), np.asarray(rst), rtol=0,
                                   atol=tol)
        lo += n


@pytest.mark.parametrize("env,pin,exact", [
    ("1", None, True), ("0", True, True), ("1", False, False),
    ("0", None, False)])
def test_exact_lane_routing(monkeypatch, env, pin, exact):
    """biquad_apply runs the exact lane where exact_biquad_scope pins it
    or, with no pin, where TERMDAW_EXACT_BIQUAD=1 asks for it (mirror of
    tests/test_fx.py:119-131); the reference routes the same way."""
    monkeypatch.setenv("TERMDAW_EXACT_BIQUAD", env)
    x = np.random.default_rng(119).normal(size=(512, 2)).astype(np.float32)
    c = filters.biquad_coefs("lowpass", 1000.0, 48000)
    tc = tuple(_t(v) for v in c)  # 0-d, broadcast over the channels
    st = filters.biquad_init_state(2, CPU)
    seq, _ = filters.biquad_apply_sequential(_t(x), tc, st)
    if pin is None:
        got, _ = filters.biquad_apply(_t(x), tc, st)
        rgot, _ = rfilt.biquad_apply(jnp.asarray(x), c,
                                     rfilt.biquad_init_state(2))
    else:
        with filters.exact_biquad_scope(pin):
            got, _ = filters.biquad_apply(_t(x), tc, st)
        with rfilt.exact_biquad_scope(pin):
            rgot, _ = rfilt.biquad_apply(jnp.asarray(x), c,
                                         rfilt.biquad_init_state(2))
    rseq, _ = rfilt.biquad_apply_sequential(jnp.asarray(x), c,
                                            rfilt.biquad_init_state(2))
    assert torch.equal(got, seq) == exact
    assert np.array_equal(np.asarray(rgot), np.asarray(rseq)) == exact


def test_exact_lane_rejects_bad_shapes():
    x = torch.zeros(8, 4)
    c = tuple(torch.zeros(4) for _ in range(5))
    with pytest.raises(ValueError, match="state must be"):
        filters.biquad_apply_sequential(x, c, torch.zeros(4, 3))
    with pytest.raises(ValueError, match="must be \\[T, C\\]"):
        filters.biquad_apply_sequential(torch.zeros(0, 4), c,
                                        torch.zeros(4, 4))
    with pytest.raises(TypeError, match="float32"):
        filters.biquad_apply_sequential(x.double(), c, torch.zeros(4, 4))


def test_prev_frames_short_and_long_windows():
    tail = _t(np.arange(10, dtype=np.float32).reshape(5, 2))
    x = _t(100 + np.arange(6, dtype=np.float32).reshape(3, 2))
    halo, new = filters.prev_frames(x, tail)
    assert halo is tail
    # T < M: the new tail keeps the last M - T frames of the old one
    np.testing.assert_array_equal(new.numpy(), np.concatenate(
        [tail.numpy()[3:], x.numpy()]))
    x = _t(100 + np.arange(16, dtype=np.float32).reshape(8, 2))
    np.testing.assert_array_equal(filters.prev_frames(x, tail)[1].numpy(),
                                  x.numpy()[3:])


def test_pluginhost_uris_aliases_and_version(capsys):
    """The port's host against the reference's on the same calls: URI
    hints, display-name aliases, version bumps and the messages."""
    hosts = (RefPluginHost(), PluginHost())
    errs = (RefAddPluginError, AddPluginError)
    uris = [("verb", "http://calf.sourceforge.net/plugins/Reverb"),
            ("comp", "urn:x:Compressor"), ("eq", "native:eq3"),
            ("cr", "lv2:Crusher"), ("dl", "native:delay")]
    outs = []
    for h, err in zip(hosts, errs):
        for name, uri in uris:
            h.add_plugin(uri, name)
        with pytest.raises(err, match="no native effect matches uri"):
            h.add_plugin("urn:unknown", "x")
        with pytest.raises(err, match="already present"):
            h.add_plugin("native:tape", "verb")
        v0 = h.version
        h.set_value("comp", "Attack", 30.0)
        h.set_value("verb", " Room Size ", 0.5)
        h.set_value("eq", "low freq", 180.0)
        h.set_value("eq", "High Gain", 2.0)
        h.set_value("comp", "Makeup Gain", 1.5)
        assert h.version == v0 + 5
        capsys.readouterr()
        h.set_value("comp", "loudness", 1.0)
        h.set_value("nobody", "Attack", 1.0)
        assert h.version == v0 + 5  # refused: no bump
        msg = capsys.readouterr().out
        assert 'has no parameter "loudness"' in msg.replace(
            "\x1b[34m", "").replace("\x1b[33m", "").replace("\x1b[0m", "")
        assert 'unknown plugin "nobody"' in msg
        h.reset_value("comp", "ATTACK")
        h.reset_value("comp", "attack")  # already reset: no bump
        assert h.version == v0 + 6
        h.remove_plugin("cr")
        assert h.version == v0 + 7 and h.get_index("cr") is None
        outs.append(([h.get(h.get_index(n)).effect.kind for n, _ in uris
                      if n != "cr"],
                     [h.param_values(h.get_index(n)) for n, _ in uris
                      if n != "cr"], msg))
    assert outs[0] == outs[1]
    assert outs[1][0] == ["reverb", "compressor", "eq3", "delay"]
    assert outs[1][1][1]["attack"] == 20.0 and outs[1][1][1]["makeup"] == 1.5
    assert outs[1][1][2]["low_freq"] == 180.0
    for alias, key in rfx._PARAM_ALIASES.items():
        assert fx.resolve_param(alias.upper()) == key
    assert fx._URI_HINTS == rfx._URI_HINTS


def test_wet_below_threshold_passes_input_and_keeps_every_fx_leaf(
        tmp_path, monkeypatch):
    """An effect vertex with wet < 1e-4 passes its input and leaves every
    leaf of its state as it was (the reference keeps the old leaves with
    jnp.where); its output matches the reference's."""
    from termdaw_tpu.config import Config
    from termdaw_tpu.engine.state import State as RefState

    from termdaw_tpu_torch.utils.fixtures import load_state

    (tmp_path / "project.toml").write_text(
        '[settings]\nmain = "project.lua"\nbuffer_length = 256\n'
        "project_samplerate = 8000\n")
    (tmp_path / "project.lua").write_text("""
set_length(1.0);
declare_floww("f", { {0.0, 60, 0.9}, {0.5, 60, 0.0} });
load_lv2("verb", "native:reverb");
load_lv2("comp", "native:compressor");
add_synth("syn", 1.0, 0.0, "f", 0.4, 0.3, { 0.01, 0.1, 0.8, 5.0, 0.2, 0.5 },
          0.0, 0.0, {}, 0.0, {});
add_lv2fx("off", 1.0, 0.0, 0.00005, "verb");
add_lv2fx("on", 1.0, 0.0, 0.5, "comp");
add_sum("out", 1.0, 0.0);
connect("syn", "off");
connect("off", "on");
connect("on", "out");
set_output("out");
""")
    port = load_state(tmp_path, CPU)
    cg = port.compiled
    off, on = cg.graph.name_map["off"], cg.graph.name_map["on"]
    assert cg.statics[off].fx_skip and not cg.statics[on].fx_skip
    before = {k: _leaves_t(cg.num_state[f"{v}.fx"])
              for k, v in (("off", off), ("on", on))}
    port.fb.set_time(0)
    got = cg.render_window(port.fb, 16).numpy()
    after_off = _leaves_t(cg.num_state[f"{off}.fx"])
    assert len(after_off) == 25  # 16 combs, 4 + 4 allpass tails, damping
    assert all(a is b for a, b in zip(after_off, before["off"]))
    assert all(not a.any() for a in after_off)
    assert any(a.any() for a in _leaves_t(cg.num_state[f"{on}.fx"]))
    monkeypatch.setenv("TERMDAW_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TERMDAW_MESH", "0")
    ref = RefState(Config.read(tmp_path / "project.toml"), str(tmp_path))
    ref.refresh()
    ref.fb.set_time(0)
    want = np.asarray(ref.compiled.render_window(ref.fb, 16))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for a in _leaves(ref.compiled.num_state[f"{off}.fx"]):
        assert not a.any()


def _leaves_t(tree):
    """The tensors of a port state tree, in _leaves' order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves_t(tree[k])]
    if isinstance(tree, tuple):
        return [a for v in tree for a in _leaves_t(v)]
    return [tree]
