"""The port's voice mixer (termdaw_tpu_torch/ops/voices.py) against the
reference's Pallas kernel, run in interpret mode as tests/test_pallas.py
runs it on the CPU. Inputs come from numpy seeds and reach both sides as
numpy arrays."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from termdaw_tpu.banks.flowwbank import DrumBake
from termdaw_tpu.graph.bake import MultiCarry, bake_sample_multi
from termdaw_tpu.ops import pallas_voices as ref

from termdaw_tpu_torch import kernels
from termdaw_tpu_torch.ops import voices

torch.set_num_threads(1)


def _begin_vel_both(tbl, t0, nb, bl, L):
    jb = {k: jnp.asarray(v) for k, v in tbl.items()}
    rb, rv = jax.jit(
        lambda: ref.compute_begin_vel(jb, jnp.int32(t0), nb, bl, L)
    )()
    tb, tv = voices.compute_begin_vel(
        {k: torch.from_numpy(np.asarray(v)) for k, v in tbl.items()},
        t0, nb, bl, L,
    )
    return (np.asarray(rb), np.asarray(rv)), (tb, tv)


def _pallas_fixture(rng):
    """tests/test_pallas.py::test_pallas_voice_mixer_matches_xla's inputs:
    overlapping voices, some crossing block boundaries, one pre-window."""
    nb, bl, L = 4, 256, 300
    sample = rng.normal(size=(L, 2)).astype(np.float32)
    drum = DrumBake(
        frames=np.asarray([10, 100, 290, 512, 700], np.int64),
        notes=np.full(5, 36.0, np.float32),
        vels=np.asarray([0.9, 0.5, 0.7, 1.0, 0.3], np.float32),
    )
    tbl, _ = bake_sample_multi(drum, MultiCarry(voices=[(-100, 0.8)]),
                               0, nb, bl, L)
    return sample, tbl, nb, bl, L


def _numpy_mix(padded, begins, al, ar, nb, bl):
    """The mix as a numpy loop: slot order, multiply and add each rounded
    to f32 (numpy never fuses them)."""
    out = np.zeros((2, nb, bl), np.float32)
    for p in range(begins.shape[1]):
        window = padded[:, begins[:, p, None] + np.arange(bl)]
        out = out + window * np.stack([al[:, p], ar[:, p]])[:, :, None]
    return out.transpose(1, 2, 0).reshape(nb * bl, 2)


# Not bit-exact against the interpret-mode kernel: XLA's CPU backend fuses
# the kernel body's `out + window * amp` into fused multiply-adds, so from
# the second voice on the reference rounds once where the port (the plain
# version and the CUDA kernel, like numpy) rounds the product and the sum
# separately. The difference is a few f32 ulps of the sum; the port is
# held bit-exact to the numpy loop instead.
MIX_ATOL = 1e-6


def _mix_both(padded, begins, al, ar, nb, bl):
    want = ref.sample_multi_pallas_stereo(
        jnp.asarray(padded), jnp.asarray(begins), jnp.asarray(al),
        jnp.asarray(ar), nb, bl, interpret=True,
    )
    got = voices.voice_mix_stereo(
        torch.from_numpy(padded.copy()), torch.from_numpy(begins.copy()),
        torch.from_numpy(al.copy()), torch.from_numpy(ar.copy()), nb, bl,
    ).numpy()
    np.testing.assert_array_equal(
        got, _numpy_mix(padded, begins, al, ar, nb, bl)
    )
    return np.asarray(want), got


@pytest.mark.parametrize("t0", [0, 5 * 256 + 17])
def test_compute_begin_vel_exact(t0):
    rng = np.random.default_rng(0)
    nb, bl, L = 6, 128, 200
    frames = np.sort(rng.integers(t0 - 300, t0 + nb * bl, 9)).astype(np.int64)
    drum = DrumBake(frames=frames, notes=np.full(9, 36.0, np.float32),
                    vels=rng.uniform(0.2, 1.0, 9).astype(np.float32))
    tbl, _ = bake_sample_multi(drum, MultiCarry(), t0, nb, bl, L,
                               {"p": 8, "n": 16})
    (rb, rv), (tb, tv) = _begin_vel_both(tbl, t0, nb, bl, L)
    assert tb.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(tb.numpy(), rb)
    np.testing.assert_array_equal(tv.numpy(), rv)


def test_plain_matches_pallas_interpret():
    sample, tbl, nb, bl, L = _pallas_fixture(np.random.default_rng(1234))
    (rb, rv), _ = _begin_vel_both(tbl, 0, nb, bl, L)
    padded = np.asarray(ref.make_padded_sample(jnp.asarray(sample), bl))
    np.testing.assert_array_equal(
        voices.make_padded_sample(torch.from_numpy(sample), bl).numpy(),
        padded,
    )
    # per-channel amps, as a fused group folds pan/gain into them
    al = (rv * np.float32(0.8)).astype(np.float32)
    ar = (rv * np.float32(1.1)).astype(np.float32)
    want, got = _mix_both(padded, rb, al, ar, nb, bl)
    assert got.shape == (nb * bl, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=MIX_ATOL)


def test_empty_blocks_are_zero():
    rng = np.random.default_rng(2)
    nb, bl, L = 2, 128, 64
    sample = rng.normal(size=(L, 2)).astype(np.float32)
    tbl, _ = bake_sample_multi(DrumBake.empty(), MultiCarry(), 0, nb, bl, L)
    (rb, rv), _ = _begin_vel_both(tbl, 0, nb, bl, L)
    padded = np.asarray(ref.make_padded_sample(jnp.asarray(sample), bl))
    want, got = _mix_both(padded, rb, rv, rv, nb, bl)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, 0.0)


def test_two_sample_concat_buffer():
    """A fused group over two samples reads one concatenated buffer with
    begins in concat coordinates; slots include empty ones, begins at 0 and
    at the largest in-bounds value L + bl of each segment."""
    rng = np.random.default_rng(3)
    nb, bl, P = 5, 128, 6
    segs = [rng.normal(size=(L, 2)).astype(np.float32) for L in (150, 90)]
    padded_segs = [np.asarray(ref.make_padded_sample(jnp.asarray(s), bl))
                   for s in segs]
    padded = np.ascontiguousarray(np.concatenate(padded_segs, axis=1))
    base = [0, padded_segs[0].shape[1]]
    seg = rng.integers(0, 2, (nb, P))
    lens = np.asarray([150, 90])
    begins = (rng.integers(0, lens[seg] + bl + 1) + np.asarray(base)[seg])
    begins[0, 0], begins[1, 1] = 0, base[1] + lens[1] + bl
    begins = begins.astype(np.int32)
    al = rng.uniform(-1, 1, (nb, P)).astype(np.float32)
    ar = rng.uniform(-1, 1, (nb, P)).astype(np.float32)
    al[:, -1] = ar[:, -1] = 0.0  # empty slots
    want, got = _mix_both(padded, begins, al, ar, nb, bl)
    np.testing.assert_allclose(got, want, rtol=0, atol=MIX_ATOL)


def test_plain_matches_pallas_interpret_above_the_resident_budget():
    """A padded buffer one frame over kernels.voice_mix_plan's resident
    budget (a long sample: the card streams it from global memory), with
    begins at 0 and at the largest in-bounds begin L + bl; small otherwise
    (3 blocks, 4 slots) to keep interpret mode quick."""
    rng = np.random.default_rng(6)
    nb, bl, P = 3, 128, 4
    L = kernels.VOICE_MIX_RESIDENT_LPAD + 1 - 2 * bl - 256
    sample = rng.normal(size=(L, 2)).astype(np.float32)
    padded = np.asarray(ref.make_padded_sample(jnp.asarray(sample), bl))
    assert not kernels.voice_mix_plan(padded.shape[1], nb, bl).resident
    begins = rng.integers(0, L + bl + 1, (nb, P)).astype(np.int32)
    begins[0, 0], begins[1, 0] = 0, L + bl
    al = rng.uniform(-1, 1, (nb, P)).astype(np.float32)
    ar = rng.uniform(-1, 1, (nb, P)).astype(np.float32)
    want, got = _mix_both(padded, begins, al, ar, nb, bl)
    np.testing.assert_allclose(got, want, rtol=0, atol=MIX_ATOL)


def _frames_mixed(plan, nb, bl):
    """How often the kernel of `plan` writes each frame of [nb, bl]: its
    warps, each walking the (block, tile) items w, w + (warps of the
    grid), ..."""
    T = kernels.VOICE_MIX_TILE
    tiles = -(-bl // T)
    count = np.zeros(nb * tiles * T, np.int64)
    warps = plan.grid * plan.threads // 32
    for first in range(warps):
        for w in range(first, plan.items, warps):
            count[w * T:(w + 1) * T] += 1
    return count.reshape(nb, tiles * T)[:, :bl]


# the buffers of the render paths (c5's one hit, c4's snare, chip_smoke's
# two-segment concat), the resident budget's edge, a 30 s sample
_C5, _C4, _SMOKE = 3840 + 2304, 7200 + 2304, 6144 + 2000 + 2304


@pytest.mark.parametrize("lpad", [
    256, _C5, _C4, _SMOKE, kernels.VOICE_MIX_RESIDENT_LPAD,
    kernels.VOICE_MIX_RESIDENT_LPAD + 1, 30 * 48000 + 2304])
@pytest.mark.parametrize("nb,bl", [(375, 1024), (3, 100), (1, 1),
                                   (700, 256)])
def test_voice_mix_plan_regime_grid_and_shared_memory(lpad, nb, bl):
    """kernels.voice_mix_plan: resident exactly while the buffer fits the
    budget (the render paths' buffers do); a CTA's shared memory, tables
    included, within the 232,448 bytes a block may use and, with what
    the system keeps, within an SM's 228 KB; at most one CTA an SM,
    enough warps for one round where 32 an SM suffice, at least 8 warps
    to copy a staged buffer, no CTA without an item; every frame of every
    block mixed once."""
    plan = kernels.voice_mix_plan(lpad, nb, bl)
    assert plan.resident == (lpad <= kernels.VOICE_MIX_RESIDENT_LPAD)
    if lpad in (_C5, _C4, _SMOKE):
        assert plan.resident
    tiles = -(-bl // kernels.VOICE_MIX_TILE)
    assert plan.items == nb * tiles
    # with the slot tables (32 warps x 32 16-byte entries, static) within
    # the 232,448 bytes a CTA may use, and with the 1 KB the system keeps
    # per CTA within an SM's 233,472
    tables = 32 * 32 * 16
    assert plan.smem + tables <= 232448
    assert plan.smem + tables + 1024 <= 233472
    if plan.resident:
        assert plan.smem == 8 * lpad + 16 <= kernels.VOICE_MIX_RESIDENT_BYTES
        assert plan.threads >= 256
    else:
        assert plan.smem == 0
    assert 1 <= plan.grid <= kernels.H100_SMS
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    warps = plan.grid * plan.threads // 32
    assert warps >= min(plan.items, 32 * kernels.H100_SMS)  # one round
    assert warps - plan.threads // 32 < plan.items  # no CTA without an item
    np.testing.assert_array_equal(_frames_mixed(plan, nb, bl), 1)


def test_cpu_call_does_not_count_a_launch():
    sample, tbl, nb, bl, L = _pallas_fixture(np.random.default_rng(4))
    _, (tb, tv) = _begin_vel_both(tbl, 0, nb, bl, L)
    padded = voices.make_padded_sample(torch.from_numpy(sample), bl)
    before = voices.launches
    voices.voice_mix_stereo(padded, tb, tv, tv, nb, bl)
    assert voices.launches == before


@pytest.mark.parametrize("bad", ["begins_int64", "amp_f64", "shape",
                                 "noncontig", "device", "short"])
def test_wrapper_rejects_bad_inputs(bad):
    nb, bl, P = 2, 64, 3
    padded = torch.zeros((2, 3 * bl + 256))
    begins = torch.zeros((nb, P), dtype=torch.int32)
    al = torch.zeros((nb, P))
    ar = torch.zeros((nb, P))
    if bad == "begins_int64":
        begins = begins.long()
    elif bad == "amp_f64":
        al = al.double()
    elif bad == "shape":
        ar = torch.zeros((nb, P + 1))
    elif bad == "noncontig":
        al = torch.zeros((P, nb)).t()
    elif bad == "short":  # fewer than 256 frames: no tile's window fits
        padded = torch.zeros((2, 255))
    else:
        ar = torch.zeros((nb, P), device="meta")
    with pytest.raises((TypeError, ValueError)):
        voices.voice_mix_stereo(padded, begins, al, ar, nb, bl)
