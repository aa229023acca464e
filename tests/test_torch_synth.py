"""The port's synth, envelope, sampler and filter ops
(termdaw_tpu_torch/ops/{adsr,osc,envelope,sampler,scan,filters,synthv}.py)
against the reference's on the same numpy inputs, both on the CPU.

Bake tables come from the port's graph/bake.py, which is the reference's
bake carried over unchanged, and reach both sides as numpy arrays.

Tolerances: where both sides do the same f32 ops in the same order the
difference is XLA's CPU backend contracting a multiply and an add into
one FMA (as the reference's interpret-mode voice mixer does), a few f32
ulps of values of order 1: atol 1e-6. Sums over voice slots may reduce
in another order: atol 1e-6 per slot. Libm `sin` against XLA's `sin`:
2 ulps of values near 1, 3e-7. The affine scans associate their products
differently: they are held to a float64 recurrence at the reference's
own bound, 1e-4 (tests/test_ops.py TestBandPass), and to each other at
1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from termdaw_tpu.ops import adsr as radsr
from termdaw_tpu.ops import envelope as renv
from termdaw_tpu.ops import filters as rfilt
from termdaw_tpu.ops import osc as rosc
from termdaw_tpu.ops import sampler as rsampler
from termdaw_tpu.ops import synthv as rsynth

from termdaw_tpu_torch.banks.flowwbank import DrumBake, SimpleBake
from termdaw_tpu_torch.fileio.wavetable import WaveTable
from termdaw_tpu_torch.graph import bake as B
from termdaw_tpu_torch.graph.compile import time_table
from termdaw_tpu_torch.ops import adsr, envelope, filters, osc, sampler, scan
from termdaw_tpu_torch.ops import synthv

torch.set_num_threads(1)

SR = 8000


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _both(tbl: dict):
    """A bake table as (jnp dict, torch dict)."""
    return ({k: jnp.asarray(v) for k, v in tbl.items()},
            {k: _t(np.asarray(v)) for k, v in tbl.items()})


CONFS = [
    adsr.hit_conf(0.001, 0.02, 0.0, 0.0, 0.0, 0.0),      # zero sustain/release
    adsr.AdsrConf(1.0, 0.01, 0.3, 0.2, 0.3, 0.0, 0.0, 0.05, 1.0),  # c2's
    adsr.AdsrConf(0.2, 0.0, 1.0, 0.05, 0.5, 0.1, 0.3, 0.0, 0.0),   # zero attack
    adsr.AdsrConf(0.0, 0.01, -2.0, 0.02, 0.5, 0.03, 0.2, 0.04, 0.0),  # <= -1
    adsr.hit_conf(0.01, 0.1, 0.8, 5.0, 0.2, 0.5),        # c3's note conf
]


def _time_grid(conf) -> np.ndarray:
    """Times across every segment, each f32 segment edge and its f32
    neighbours, negative times and times past the release. Around 0 the
    neighbours are the smallest normal floats: XLA's CPU backend flushes
    subnormals to zero, and no envelope clock is subnormal."""
    a32, ad, ads_end = radsr._seg_bounds(radsr.AdsrConf(*conf))
    tiny = np.finfo(np.float32).tiny
    edges = []
    for e in (np.float32(0.0), a32, ad, ads_end,
              np.float32(ads_end + np.float32(conf.release_sec))):
        edges += [-tiny, e, tiny] if e == 0.0 else [
            np.nextafter(e, np.float32(-1)), e,
            np.nextafter(e, np.float32(10))]
    grid = np.linspace(-0.05, float(ads_end) + conf.release_sec + 0.2, 2001)
    return np.concatenate([grid, edges]).astype(np.float32)


@pytest.mark.parametrize("ci", range(len(CONFS)))
def test_adsr_evaluators_match_reference(ci):
    conf = CONFS[ci]
    rconf = radsr.AdsrConf(*conf)
    t = _time_grid(conf)
    rng = np.random.default_rng(ci)
    old = rng.uniform(-1, 1, t.shape).astype(np.float32)
    for name, targs in (
        ("apply_ads", (t,)),
        ("apply_adsr", (t,)),
        ("apply_r", (t, old)),
        ("apply_r_rt", (t, np.flip(t).copy())),
    ):
        want = jax.jit(lambda *a, f=getattr(radsr, name): f(rconf, *a))(
            *[jnp.asarray(a) for a in targs])
        got = getattr(adsr, name)(conf, *[_t(a) for a in targs])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_sin_f32_and_oscillators_match_reference():
    rng = np.random.default_rng(7)
    x = np.concatenate([
        rng.uniform(-4.5e5, 4.5e5, 4000), rng.uniform(-10, 10, 1000),
        [0.0, np.pi, -np.pi, 3.99999e5, 4.0e5, -4.0e5],
    ]).astype(np.float32)
    got = osc.sin_f32(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(rosc.sin_f32)(x)),
                               rtol=0, atol=3e-7)  # 2 ulps of values near 1
    assert np.abs(got).max() <= 1.0
    t = rng.uniform(0, 40, (64, 1)).astype(np.float32)
    hz = rng.uniform(20, 5000, (1, 16)).astype(np.float32)
    for z in (0.3, 0.8, 1e-4):
        np.testing.assert_allclose(
            osc.square_sine(_t(t), _t(hz), z).numpy(),
            np.asarray(jax.jit(lambda a, b: rosc.square_sine(a, b, z))(t, hz)),
            rtol=0, atol=3e-7 / min(z, 1.0))
        np.testing.assert_allclose(
            osc.topflat_sine(_t(t), _t(hz), z).numpy(),
            np.asarray(jax.jit(lambda a, b: rosc.topflat_sine(a, b, z))(t, hz)),
            rtol=0, atol=1e-6)
    np.testing.assert_allclose(osc.triangle(_t(t), _t(hz)).numpy(),
                               np.asarray(jax.jit(rosc.triangle)(t, hz)),
                               rtol=0, atol=1e-6)
    notes = np.arange(20, 110, dtype=np.float32)
    np.testing.assert_allclose(osc.note_hz(_t(notes)).numpy(),
                               np.asarray(rosc.note_hz(notes)), rtol=1e-6)


def _frames(t0, T):
    return (jnp.int32(t0) + jnp.arange(T, dtype=jnp.int32),
            torch.arange(t0, t0 + T, dtype=torch.int64))


@pytest.mark.parametrize("use_off,use_max,wet", [
    (False, False, 1.0), (False, True, 0.6), (True, False, 1.0),
    (True, True, 0.35), (False, False, 0.0),
])
def test_adsr_apply_matches_reference(use_off, use_max, wet):
    """Both modes, hits and note-offs mid-block, a carry from a first
    window, and the wet skip (wet 0 returns the input unchanged)."""
    conf = CONFS[1] if not use_off else CONFS[4]
    nb, bl, nb1 = 12, 64, 3
    T, t0 = nb * bl, nb1 * bl
    rng = np.random.default_rng(11)
    frames = np.sort(rng.choice(np.arange(0, t0 + T), 14,
                                replace=False)).astype(np.int64)
    ons = np.arange(len(frames)) % 3 != 2
    notes = np.full(len(frames), 36.0, np.float32)
    vels = rng.uniform(0.2, 1.0, len(frames)).astype(np.float32)
    carry = B.AdsrCarry()
    for lo, n in ((0, nb1), (t0, nb)):
        sel = (frames >= lo) & (frames < lo + n * bl)
        if use_off:
            tbl, carry = B.bake_adsr_off(
                SimpleBake(frames[sel], ons[sel], notes[sel], vels[sel]),
                carry, conf, SR, lo, n, bl, None)
        else:
            tbl, carry = B.bake_adsr_drum(
                DrumBake(frames[sel], notes[sel], vels[sel]), carry, lo, n,
                bl, SR)
    jb, tb = _both(tbl)
    x = rng.normal(size=(T, 2)).astype(np.float32)
    ib = time_table(SR, T)[:bl]
    jf, tf = _frames(t0, T)
    want = jax.jit(lambda xx, bb, ff, ii: renv.adsr_apply(
        xx, bb, ff, SR, radsr.AdsrConf(*conf), use_off, use_max,
        jnp.float32(wet), ib=ii))(x, jb, jf, ib)
    got = envelope.adsr_apply(_t(x), tb, tf, conf, use_off, use_max,
                              torch.tensor(wet, dtype=torch.float32), _t(ib))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if wet == 0.0:
        np.testing.assert_array_equal(got.numpy(), x)


def test_sample_lerp_and_sample_multi_match_reference():
    """Two chained windows: a carried voice mid-crossfade, retriggers
    closer together than lerp_len, voices running past the sample end."""
    rng = np.random.default_rng(3)
    L, nb, bl, lerp_len = 300, 6, 128, 40
    T = nb * bl
    sample = rng.normal(size=(L, 2)).astype(np.float32)
    hits = np.asarray([50, 70, 400, 700, 760, 900, 1300, 1320], np.int64)
    vels = rng.uniform(0.3, 1.0, len(hits)).astype(np.float32)
    carry = B.LerpCarry(primary_start=-20, primary_vel=0.8, ghost_start=-400,
                        ghost_vel=0.5, countdown=25)
    mcarry = B.MultiCarry([(-100, 0.7)])
    for t0 in (0, T):
        sel = (hits >= t0) & (hits < t0 + T)
        drum = DrumBake(hits[sel], np.zeros(sel.sum(), np.float32), vels[sel])
        tbl, carry = B.bake_sample_lerp(drum, carry, t0, nb, bl, lerp_len,
                                        {"e": 8, "b": 8})
        jb, tb = _both(tbl)
        jf, tf = _frames(t0, T)
        want = jax.jit(lambda s, b, f: rsampler.sample_lerp(s, b, f,
                                                            lerp_len))(
            sample, jb, jf)
        got = sampler.sample_lerp(_t(sample), tb, tf, lerp_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        mtbl, mcarry = B.bake_sample_multi(drum, mcarry, t0, nb, bl, L)
        jb, tb = _both(mtbl)
        want = jax.jit(lambda s, b, f: rsampler.sample_multi(s, b, f, nb,
                                                             bl))(
            sample, jb, jf)
        got = sampler.sample_multi(_t(sample), tb, tf, nb, bl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * mtbl["idx"].shape[1])


def _recurrence64(b, a, y0):
    y = np.empty(b.shape, np.float64)
    prev = np.asarray(y0, np.float64)
    for t in range(b.shape[0]):
        prev = a * prev + b[t]
        y[t] = prev
    return y


@pytest.mark.parametrize("T,C", [(1, 1), (5, 2), (1024, 4), (1025, 1),
                                 (3000, 4)])
def test_affine_scan_plain_matches_float64_recurrence(T, C):
    rng = np.random.default_rng(T + C)
    b = rng.normal(size=(T, C)).astype(np.float32)
    a = rng.uniform(0.0, 0.999, C).astype(np.float32)
    a[0] = 0.99584  # the 30 Hz lane at 48 kHz
    y0 = rng.normal(size=C).astype(np.float32)
    got = scan.affine_scan(_t(b), _t(a), _t(y0))
    assert got.shape == (T, C) and got.dtype == torch.float32
    want = _recurrence64(b.astype(np.float64), a.astype(np.float64), y0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def _band_pass64(x, lg, hg, pass_mode):
    """Sequential float64 band-pass (reference extensions.rs:653-689, with
    the passr fix), primed from the first sample."""
    lp = x[0].astype(np.float64)
    hp = x[0].astype(np.float64)
    out = np.empty(x.shape, np.float64)
    lmul, hmul = float(lg != 0.0), float(hg != 0.0)
    for i in range(len(x)):
        lp = lp + lg * (x[i] - lp)
        hp = hp + hg * (x[i] - hp)
        cut = (lmul * lp + hmul * (x[i] - hp)) * 0.5
        out[i] = x[i] - cut if pass_mode else cut
    return out, np.concatenate([lp, hp])


def _bp_both(x, state_ref, state_port, lg, hg, pass_mode, wet):
    want, wst = jax.jit(
        lambda xx, s, w: rfilt.band_pass_timeline(xx, s, lg, hg, pass_mode,
                                                  w))(
        x, state_ref, jnp.float32(wet))
    got, gst = filters.band_pass_timeline(
        _t(x), state_port, lg, hg, pass_mode,
        torch.tensor(wet, dtype=torch.float32))
    return (np.asarray(want), wst), (got.numpy(), gst)


@pytest.mark.parametrize("pass_mode", [True, False])
def test_band_pass_matches_reference_and_float64(pass_mode):
    """c3's cutoffs (8000 Hz and 30 Hz at 48 kHz) over two windows of
    ragged length, against the reference and a float64 recurrence."""
    sr = 48000
    lg = filters.gamma_from_cutoff(8000.0, sr)
    hg = filters.gamma_from_cutoff(30.0, sr)
    assert lg == rfilt.gamma_from_cutoff(8000.0, sr)
    x = np.random.default_rng(5).normal(size=(5000, 2)).astype(np.float32)
    want64, prevs64 = _band_pass64(x, lg, hg, pass_mode)
    rst, pst = rfilt.BandPassState.init(), filters.BandPassState.init(
        torch.device("cpu"))
    outs = []
    for lo, hi in ((0, 3071), (3071, 5000)):
        (want, rst), (got, pst) = _bp_both(x[lo:hi], rst, pst, lg, hg,
                                           pass_mode, 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pst.prevs.numpy(), np.asarray(rst.prevs),
                                   rtol=0, atol=1e-5)
        assert not pst.first.item() and not bool(rst.first)
        outs.append(got)
    np.testing.assert_allclose(np.concatenate(outs), want64, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(pst.prevs.numpy(), prevs64, rtol=0, atol=1e-4)


@pytest.mark.parametrize("lg,hg,wet", [(0.5, 0.5, 0.0), (0.0, 0.0, 1.0)])
def test_band_pass_skip_leaves_state_untouched(lg, hg, wet):
    x = np.random.default_rng(6).normal(size=(300, 2)).astype(np.float32)
    cpu = torch.device("cpu")
    fresh = filters.BandPassState.init(cpu)
    # a state after one filtered window, so prevs are not zeros
    _, primed = filters.band_pass_timeline(
        _t(x), fresh, 0.3, 0.01, True, torch.tensor(1.0))
    for st in (fresh, primed):
        out, st2 = filters.band_pass_timeline(
            _t(x), st, lg, hg, True, torch.tensor(wet, dtype=torch.float32))
        np.testing.assert_array_equal(out.numpy(), x)
        assert torch.equal(st2.prevs, st.prevs)
        assert torch.equal(st2.first, st.first)
    (want, rst), (got, _) = _bp_both(x, rfilt.BandPassState.init(), fresh,
                                     lg, hg, True, wet)
    np.testing.assert_array_equal(got, want)
    assert bool(rst.first)


def _note_events(rng, t0, T):
    """Overlapping notes, a repeated pitch, offs mid-block, a zero-length
    note (on and off in one frame) and a note held past the window."""
    ev = []
    for k, note in enumerate((45.0, 57.0, 61.0, 64.0, 45.0)):
        on = t0 - 200 + k * 170 + int(rng.integers(0, 60))
        ev += [(on, True, note, 0.5 + 0.1 * k), (on + 300 + 40 * k, False,
                                                  note, 0.0)]
    z = t0 + 333
    ev += [(z, True, 70.0, 0.9), (z, False, 70.0, 0.0),
           (t0 + T - 50, True, 76.0, 0.8)]
    ev.sort(key=lambda e: e[0])
    f = np.asarray([e[0] for e in ev], np.int64)
    return f, np.asarray([e[1] for e in ev]), np.asarray(
        [e[2] for e in ev], np.float32), np.asarray([e[3] for e in ev],
                                                    np.float32)


@pytest.mark.parametrize("kind", ["debug_sine", "synth", "sampsyn"])
def test_synths_match_reference(kind):
    """A first window feeds the carry of a second window that starts
    several seconds into the timeline; both sides read the same tables."""
    rng = np.random.default_rng(9)
    nb, bl = 8, 128
    T = nb * bl
    t0 = 5 * SR + 3 * bl
    f, ons, notes, vels = _note_events(rng, t0, T)
    conf = CONFS[4]
    t_first = t0 - 4 * bl
    carry = B.SineCarry() if kind == "debug_sine" else B.NotesCarry()
    for lo, nbk in ((t_first, 4), (t0, nb)):
        sel = (f >= lo) & (f < lo + nbk * bl)
        simple = SimpleBake(f[sel], ons[sel], notes[sel], vels[sel])
        if kind == "debug_sine":
            tbl, carry = B.bake_debug_sine(simple, carry, lo, nbk, bl)
        else:
            tbl, carry = B.bake_notes(simple, carry, lo, nbk, bl, SR,
                                      conf.release_sec)
    assert (tbl["idx"] >= 0).sum(axis=1).max() >= 3  # polyphony in play
    jb, tb = _both(tbl)
    jf, tf = _frames(t0, T)
    ttab = time_table(SR, t0 + T)
    time2d, ib = ttab[t0:t0 + T].reshape(nb, bl), ttab[:bl]
    if kind == "debug_sine":
        want = rsynth.debug_sine(jb, jf, nb, bl, SR, time2d=time2d)
        got = synthv.debug_sine(tb, tf, nb, bl, _t(time2d))
    elif kind == "synth":
        hit = CONFS[0]
        want = rsynth.synth(jb, jf, nb, bl, SR, 0.4, 0.3, radsr.AdsrConf(*hit),
                            1.0, 0.8, radsr.AdsrConf(*conf), 0.5,
                            radsr.AdsrConf(*CONFS[1]), time2d=time2d, ib=ib)
        got = synthv.synth(tb, tf, nb, bl, 0.4, 0.3, hit, 1.0, 0.8, conf,
                           0.5, CONFS[1], _t(time2d), _t(ib))
    else:
        wt = WaveTable.default()
        want = rsynth.sampsyn(jb, jf, nb, bl, SR, radsr.AdsrConf(*conf),
                              jnp.asarray(wt.times), jnp.asarray(wt.waves),
                              ib=ib)
        got = synthv.sampsyn(tb, tf, nb, bl, conf, _t(wt.times),
                             _t(wt.waves), _t(ib))
    want = np.asarray(want)
    assert got.shape == want.shape == (T, 2)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * tbl["idx"].shape[1])
