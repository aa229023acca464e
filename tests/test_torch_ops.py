"""The port's tensor ops (termdaw_tpu_torch/ops/) against the reference's
on the same numpy inputs. The JAX side runs on the CPU as tests/test_ops.py
runs it. Also the vertex epilogue (mix.vertex_post) on the CPU: its
host-side flags against the torch decision, its plain composition, what a
graph resolves at build, and renders with the epilogue-free vertices
keeping their arm's output against the plain program."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from termdaw_tpu.ops import mix as rmix
from termdaw_tpu.ops import quantize as rquant
from termdaw_tpu.ops import resample as rres
from termdaw_tpu.ops import sampler as rsampler

from termdaw_tpu_torch.graph import graph as G
from termdaw_tpu_torch.ops import mix, quantize, resample, sampler
from termdaw_tpu_torch.utils.fixtures import (
    load_state, read_wav_ints, write_c4_project, write_c5_project,
)

from tests.mix_project import post_plan, write_mix_project

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("t0", [0, 1000, 123457])
def test_sample_loop_bit_exact(t0):
    rng = np.random.default_rng(0)
    s = rng.normal(size=(300, 2)).astype(np.float32)
    T = 1024
    want = jax.jit(rsampler.sample_loop)(
        jnp.asarray(s), jnp.int32(t0) + jnp.arange(T, dtype=jnp.int32)
    )
    got = sampler.sample_loop(_t(s), t0, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_in", [1e-6, 0.7, 3.0])
def test_normalize_live_and_scan_bit_exact(max_in):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(6, 64, 2)) * rng.uniform(0.1, 2, (6, 1, 1))
         ).astype(np.float32)
    m = np.float32(max_in)
    w_out, w_max = jax.jit(rmix.normalize_live)(jnp.asarray(x), m)
    g_out, g_max = mix.normalize_live(_t(x), _t(m))
    np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))
    assert g_max.item() == float(w_max)
    scan_in = np.float32(0.5)
    w_out, w_scan = jax.jit(rmix.normalize_scan)(jnp.asarray(x), m, scan_in)
    g_out, g_scan = mix.normalize_scan(_t(x), _t(m), _t(scan_in))
    np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))
    assert g_scan.item() == float(w_scan)


def test_sum_inputs_bit_exact():
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(128, 2)).astype(np.float32) for _ in range(4)]
    want = rmix.sum_inputs([jnp.asarray(x) for x in xs])
    got = mix.sum_inputs([_t(x) for x in xs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# torch.cos/sin and XLA's may differ by 1 ulp, hence rtol 1e-6 for the pan
@pytest.mark.parametrize("angle,gain", [
    (0.0, 1.0), (0.0005, 1.0005), (-40.0, 1.3), (25.0, 0.7), (90.0, 1.0),
    (-90.0, 0.25),
])
def test_post_and_post_amps(angle, gain):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 2)).astype(np.float32)
    a, g = np.float32(angle), np.float32(gain)
    want = jax.jit(rmix.post)(jnp.asarray(x), a, g)
    got = mix.post(_t(x), _t(a), _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    want_amps = jax.jit(rmix.post_amps)(a, g)
    got_amps = mix.post_amps(_t(a), _t(g))
    np.testing.assert_allclose(got_amps.numpy(), np.asarray(want_amps),
                               rtol=1e-6, atol=0)


def test_post_amps_vectorized_matches_scalar_calls():
    """One call over a group's members equals one call per member."""
    rng = np.random.default_rng(4)
    angles = np.concatenate([rng.uniform(-90, 90, 6), [0.0, 0.0005]]
                            ).astype(np.float32)
    gains = np.concatenate([rng.uniform(0.2, 2, 6), [1.0, 1.0004]]
                           ).astype(np.float32)
    vec = mix.post_amps(_t(angles), _t(gains))
    each = torch.stack([mix.post_amps(_t(a), _t(g))
                        for a, g in zip(angles, gains)])
    assert vec.shape == (8, 2)
    np.testing.assert_array_equal(vec.numpy(), each.numpy())


def _ulps(v, k: int = 4) -> list:
    """v and its k f32 neighbours on each side."""
    out, lo, hi = [np.float32(v)], np.float32(v), np.float32(v)
    for _ in range(k):
        lo, hi = np.nextafter(lo, np.float32(-np.inf)), np.nextafter(
            hi, np.float32(np.inf))
        out += [lo, hi]
    return out


# the skip thresholds' edges, every f32 within 4 ulps of them, and a wide
# spread
_ANGLES = {
    "edges": [0.0, -0.0, 0.0009, -0.0009, 0.0011, -0.0011, 0.001, -0.001,
              1e-30, 45.0, -90.0, 90.0, 180.0],
    "ulps": _ulps(0.001) + _ulps(-0.001),
    "wide": list(np.random.default_rng(8).uniform(-180, 180, 64)),
}
_GAINS = {
    "edges": [1.0, 1.0009, 1.0011, 0.9991, 0.9989, 1.001, 0.999, 0.0, 2.0,
              -1.0, 0.5],
    "ulps": _ulps(1.001) + _ulps(0.999) + _ulps(1.0),
    "wide": list(np.random.default_rng(9).uniform(0.0, 2.0, 64)),
}


@pytest.mark.parametrize("what", ["angle", "gain"])
@pytest.mark.parametrize("sweep", sorted(_ANGLES))
def test_post_flags_match_the_torch_where(what, sweep):
    """mix.post_flags, decided on the host in numpy float32, is on exactly
    where apply_angle / apply_gain change their input (their torch.where
    does not select it)."""
    x = _t(np.random.default_rng(10).uniform(0.25, 1.0, (8, 2))
           .astype(np.float32))
    values = (_ANGLES if what == "angle" else _GAINS)[sweep]
    for v in values:
        t = torch.tensor(np.float32(v))
        if what == "angle":
            on = mix.post_flags(v, 1.0)[0]
            changed = not torch.equal(mix.apply_angle(x, t), x)
        else:
            on = mix.post_flags(0.0, v)[1]
            changed = not torch.equal(mix.apply_gain(x, t), x)
        assert bool(on) == changed, f"{what} {float(v)!r}"
    a = np.asarray(values, np.float32)
    on = mix.post_flags(a, a)[0 if what == "angle" else 1]
    assert on.shape == a.shape  # elementwise over an array


@pytest.mark.parametrize("gain", [1.0, 0.6])
@pytest.mark.parametrize("angle", [0.0, 30.0])
@pytest.mark.parametrize("wet", [None, 0.5, 1.0])
def test_vertex_post_on_cpu_is_the_plain_composition(wet, angle, gain):
    """Bit for bit post(x + w*(y - x), angle, gain), or post(y, ...) where
    it does not blend; a plan with no flag on raises (its vertex keeps
    its input); nothing counts a launch on the CPU."""
    rng = np.random.default_rng(11)
    y, x = (_t(rng.normal(size=(1023, 2)).astype(np.float32))
            for _ in range(2))
    plan = post_plan(CPU, wet, angle, gain)
    n0 = mix.post_launches
    if not plan.launches:
        with pytest.raises(ValueError, match="no flag"):
            mix.vertex_post(y, None, plan)
        return
    got = mix.vertex_post(y, x if plan.blend else None, plan)
    v = x + plan.wet * (y - x) if wet is not None else y
    assert torch.equal(got, mix.post(v, plan.angle, plan.gain))
    assert mix.post_launches == n0
    flops, nbytes = mix.vertex_post_work(y, x, plan)
    assert flops == 2 * 1023 * (3 * plan.blend + plan.pan_on + plan.gain_on)
    assert nbytes == 4 * 2 * 1023 * (2 + plan.blend)


def test_vertex_post_refuses_what_it_cannot_take():
    y = torch.zeros((16, 2))
    with pytest.raises(ValueError, match="x must be"):
        mix.vertex_post(y, None, post_plan(CPU, 0.5, 0.0, 1.0))
    with pytest.raises(ValueError, match="y must be"):
        mix.vertex_post(torch.zeros(16), None,
                        post_plan(CPU, None, 10.0, 1.0))
    with pytest.raises(TypeError, match="float64"):
        mix.vertex_post(y.double(), None, post_plan(CPU, None, 10.0, 1.0))
    with pytest.raises(ValueError, match="pan must be"):
        mix.vertex_post(y, None, mix.VertexPost(
            False, True, False, torch.tensor(0.0), torch.tensor(10.0),
            torch.tensor(1.0), torch.zeros(3)))


_PROJECTS = {
    "mix": write_mix_project,
    "c4": lambda d: write_c4_project(d, 2.1, 8000, 32, render_sr=8000,
                                     bd=24),
    "c5": lambda d: write_c5_project(d, 2.1, 8000, 32, n_tracks=4,
                                     hit_sr=16000, bd=24),
}


@pytest.mark.parametrize("project", sorted(_PROJECTS))
def test_epilogue_resolved_at_build(tmp_path, project):
    """Each vertex's pan factors equal its own pan_amps call, its flags
    post_flags of its f32 angle and gain, it blends exactly where it is an
    effect outside its wet gate; each fused group's amps equal post_amps
    over its members."""
    _PROJECTS[project](tmp_path)
    cg = load_state(tmp_path, CPU).compiled
    graph = cg.graph
    for vi, plan in cg._posts.items():
        v, st = graph.vertices[vi], cg.statics[vi]
        assert torch.equal(plan.pan, mix.pan_amps(cg._angles[vi]))
        pan_on, gain_on = mix.post_flags(v.angle, v.gain)
        assert (plan.pan_on, plan.gain_on) == (bool(pan_on), bool(gain_on))
        assert plan.blend == (st.kind == G.PLUGINFX and not st.fx_skip)
        assert plan.wet.shape == plan.angle.shape == ()
        assert float(plan.gain) == float(np.float32(v.gain))
    assert set(cg._fused_amps) == set(cg.fused_groups)
    for c, ids in cg._fused_ids.items():
        assert torch.equal(cg._fused_amps[c],
                           mix.post_amps(cg._angles[ids], cg._gains[ids]))
    if project == "c5":
        assert cg.fused_groups  # its tracks are one fused group
    if project == "mix":  # loops, buses, Normalize; the near-0 pan skips
        off = {graph.names[vi] for vi, p in cg._posts.items()
               if not p.launches}
        assert off == {"track0", "track1", "track2", "mixbus", "verbbus",
                       "out"}
        assert not cg._posts[graph.names.index("compressor2")].pan_on


def _plain_epilogue(y, x, plan):
    """The window program's epilogue before vertex_post, for every vertex:
    the effect's wet blend, then mix.post."""
    out = x + plan.wet * (y - x) if plan.blend else y
    return mix.post(out, plan.angle, plan.gain)


@pytest.mark.parametrize("project", ["mix", "c4"])
def test_identity_vertices_render_as_the_plain_program(tmp_path,
                                                       monkeypatch, project):
    """The render's WAV, with the vertices that have nothing to do in
    their epilogue keeping their arm's output, equals the plain program's,
    in which every vertex runs the wet blend and mix.post."""
    _PROJECTS[project](tmp_path)
    st = load_state(tmp_path, CPU)
    posts = st.compiled._posts.values()
    assert any(p.launches for p in posts)
    assert any(not p.launches for p in posts)
    st.render()
    got, rate = read_wav_ints(tmp_path / "outp.wav")
    monkeypatch.setattr(mix.VertexPost, "launches", property(lambda s: True))
    monkeypatch.setattr(mix, "vertex_post", _plain_epilogue)
    plain = load_state(tmp_path, CPU)
    plain.render()
    want, want_rate = read_wav_ints(tmp_path / "outp.wav")
    assert rate == want_rate and got.size > 0
    assert np.abs(got).max() > 1000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bd", [8, 16, 24, 32])
def test_quantize_bit_exact(bd):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.5, 1.5, (2000, 2)).astype(np.float32)
    # out-of-range values, the exact edges, and values right at the f32
    # saturation point of a 32-bit render
    x[:6, 0] = [1.0, -1.0, 2.0, -2.0, 1.0000001, -1.0000001]
    x[:4, 1] = [0.0, -0.0, 0.99999994, -0.99999994]
    want = jax.jit(rquant.quantize_interleave_traced, static_argnums=1)(
        jnp.asarray(x), bd
    )
    got = quantize.quantize_interleave(_t(x), bd)
    assert got.dtype == (torch.int16 if bd <= 16 else torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if bd == 32:
        assert got.max().item() == 2147483520
        assert got.min().item() == -2147483648
    many = quantize.quantize_interleave_many([_t(x[:700]), _t(x[700:])], bd)
    np.testing.assert_array_equal(many.numpy(), got.numpy())


@pytest.mark.parametrize("from_sr,to_sr", [(48000, 44100), (96000, 48000),
                                           (8000, 4000)])
def test_polyphase_kernel_and_resample_sample_equal(from_sr, to_sr):
    w_ref, L_ref, M_ref = rres.polyphase_kernel(from_sr, to_sr)
    w, L, M = resample.polyphase_kernel(from_sr, to_sr)
    assert (L, M) == (L_ref, M_ref)
    np.testing.assert_array_equal(w, w_ref)
    x = np.random.default_rng(6).normal(size=(3000, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        resample.resample_sample(x, from_sr, to_sr),
        rres.resample_sample(x, from_sr, to_sr),
    )


@pytest.mark.parametrize("from_sr,to_sr", [(48000, 44100), (96000, 48000),
                                           (8000, 4000)])
def test_render_whole_matches_reference(from_sr, to_sr):
    """atol 1e-5: the reference's own bound for a change of reduction order
    in the resample matmul (tests/test_ops.py:339,364)."""
    rng = np.random.default_rng(7)
    n = 20000
    x = rng.normal(size=(n, 2)).astype(np.float32)
    chunks = [4096] * 4 + [n - 4 * 4096]
    xs, i = [], 0
    for cn in chunks:
        xs.append(x[i:i + cn])
        i += cn
    want = np.asarray(rres.StreamingResampler(from_sr, to_sr).render_whole(
        [jnp.asarray(c) for c in xs]
    ))
    rs = resample.StreamingResampler(from_sr, to_sr, torch.device("cpu"))
    got = rs.render_whole([_t(c) for c in xs]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a used resampler refuses; an empty render is empty
    with pytest.raises(RuntimeError):
        rs.render_whole([_t(c) for c in xs])
    empty = resample.StreamingResampler(from_sr, to_sr, torch.device("cpu"))
    assert tuple(empty.render_whole([]).shape) == (0, 2)


_CHUNKINGS = ([4096] * 4 + [20000 - 4 * 4096], [1000, 7000, 12000], [20000])


@pytest.mark.parametrize("from_sr,to_sr", [(48000, 44100), (96000, 48000),
                                           (44100, 48000)])
def test_streaming_feed_flush_equals_whole(from_sr, to_sr):
    """feed per chunk then flush against render_whole, the port's
    resample_device and the reference's resample_device and
    StreamingResampler, at tests/test_ops.py:313-339's ratios, chunkings
    and bound (1e-5, a change of reduction order in the matmul)."""
    n = 20000
    x = np.random.default_rng(313).normal(size=(n, 2)).astype(np.float32)
    whole = resample.resample_device(_t(x), from_sr, to_sr).numpy()
    ref_whole = np.asarray(rres.resample_device(jnp.asarray(x), from_sr,
                                                to_sr))
    assert whole.shape == ref_whole.shape == (-(-n * to_sr // from_sr), 2)
    np.testing.assert_allclose(whole, ref_whole, rtol=0, atol=1e-5)
    cpu = torch.device("cpu")
    np.testing.assert_array_equal(
        whole, resample.StreamingResampler(from_sr, to_sr, cpu)
        .render_whole([_t(x)]).numpy())
    for chunks in _CHUNKINGS:
        rs = resample.StreamingResampler(from_sr, to_sr, cpu)
        ref = rres.StreamingResampler(from_sr, to_sr)
        outs, ref_outs, i = [], [], 0
        for cn in chunks:
            got = rs.feed(_t(x[i:i + cn]))
            want = np.asarray(ref.feed(jnp.asarray(x[i:i + cn])))
            assert got.shape == want.shape  # the same rows become ready
            outs.append(got.numpy())
            ref_outs.append(want)
            i += cn
        outs.append(rs.flush().numpy())
        ref_outs.append(np.asarray(ref.flush()))
        got = np.concatenate(outs)
        assert got.shape == whole.shape
        assert (rs.n_in, rs.n_emitted) == (n, whole.shape[0])
        np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, np.concatenate(ref_outs), rtol=0,
                                   atol=1e-5)
        assert tuple(rs.flush().shape) == (0, 2)  # nothing left
    with pytest.raises(RuntimeError):
        rs.render_whole([_t(x)])


@pytest.mark.parametrize("from_sr,to_sr", [(48000, 44101), (44101, 48000)])
def test_resample_device_gather_path_matches_reference(from_sr, to_sr):
    """Ratios beyond MAX_PHASES output phases take the gather over the
    oversampled filter bank, in both packages."""
    assert to_sr // np.gcd(from_sr, to_sr) > resample.MAX_PHASES
    x = np.random.default_rng(9).normal(size=(9000, 2)).astype(np.float32)
    got = resample.resample_device(_t(x), from_sr, to_sr).numpy()
    want = np.asarray(rres.resample_device(jnp.asarray(x), from_sr, to_sr))
    assert got.shape == want.shape == (-(-9000 * to_sr // from_sr), 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        resample.resample_device(_t(x), 8000, 8000).numpy(), x)
