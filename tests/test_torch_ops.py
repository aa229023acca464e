"""The port's tensor ops (termdaw_tpu_torch/ops/) against the reference's
on the same numpy inputs. The JAX side runs on the CPU as tests/test_ops.py
runs it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from termdaw_tpu.ops import mix as rmix
from termdaw_tpu.ops import quantize as rquant
from termdaw_tpu.ops import resample as rres
from termdaw_tpu.ops import sampler as rsampler

from termdaw_tpu_torch.ops import mix, quantize, resample, sampler

torch.set_num_threads(1)


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
