"""The port on a CUDA card: the voice-mix, affine-scan, max-decay,
complex-scan, exact-biquad, SampSyn, Synth and eq3 kernels against their
plain versions (the SampSyn and Synth kernels also replayed from a CUDA
graph), the
effects, small renders (the exact lane's, a chain-served one and a 24-bit
one with the native host library on and off among them), playback on
the card against the port's CPU path, and sharded windows replayed from
captured graphs with NCCL collectives inside (a 1-rank world), and the
roofline's window counts equal on the card and the CPU. This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Without a card every test skips."""

import functools
import gc

import numpy as np
import pytest
import torch

from termdaw_tpu_torch import kernels, native
from termdaw_tpu_torch.engine.player import Player
from termdaw_tpu_torch.engine.sink import Sink
from termdaw_tpu_torch.fileio.wav import read_wav
from termdaw_tpu_torch.ops import filters, fx, scan, synthv, voices
from termdaw_tpu_torch.parallel.mesh import gather
from termdaw_tpu_torch.tools import shard_render
from termdaw_tpu_torch.ops.adsr import AdsrConf, hit_conf
from termdaw_tpu_torch.utils.fixtures import (
    load_state, read_wav_ints, sampsyn_window, synth_window,
    write_c1_project, write_c2_project, write_c3_project, write_c4_project,
    write_c5_project,
)
from benchmark.projects.mix_session import EQ_HIGH, EQ_LOW

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _mix_args(cuda, rng, nb, bl, P, L, offset=0):
    """A padded sample of L frames in make_padded_sample's layout ([2, bl
    + L + bl + 256]), `offset` floats into its storage (a buffer that is
    not 16-byte aligned), begins in [0, L + bl] with both ends present,
    amps in [-1, 1]."""
    lpad = 2 * bl + L + 256
    store = torch.from_numpy(
        rng.normal(size=offset + 2 * lpad).astype(np.float32)).to(cuda)
    padded = store[offset:].view(2, lpad)
    begins = rng.integers(0, L + bl + 1, (nb, P)).astype(np.int32)
    begins[0, 0], begins[-1, -1] = 0, L + bl
    al, ar = (torch.from_numpy(rng.uniform(-1, 1, (nb, P)).astype(np.float32))
              .to(cuda) for _ in range(2))
    return padded, torch.from_numpy(begins).to(cuda), al, ar


def _mix_on_card(args, nb, bl):
    """The kernel once, counted, and bit-exact to the plain version."""
    n0 = voices.launches
    got = voices.voice_mix_stereo(*args, nb, bl)
    torch.cuda.synchronize()
    assert voices.launches == n0 + 1
    want = voices.voice_mix_stereo_plain(*args, nb, bl)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# padded lengths: c5's 0.08 s hit, the resident budget's last frame and
# the first frame over it, a 30 s sample (11.5 MB, streamed)
_LPADS = {"c5": 6144, "under": kernels.VOICE_MIX_RESIDENT_LPAD,
          "over": kernels.VOICE_MIX_RESIDENT_LPAD + 1,
          "long": 30 * 48000 + 2 * 1024 + 256}


@pytest.mark.parametrize("size", sorted(_LPADS))
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_kernel_matches_plain_on_card(cuda, size, offset):
    """Bit-exact in both regimes of kernels.voice_mix_plan (the buffer
    staged in shared memory, or streamed from global memory), 16-byte
    aligned or not: the kernel and the plain version both round the
    multiply and the add separately, in slot order."""
    rng = np.random.default_rng(5 + offset)
    nb, bl, P = 37, 1024, 16
    L = _LPADS[size] - 2 * bl - 256
    args = _mix_args(cuda, rng, nb, bl, P, L, offset)
    plan = kernels.voice_mix_plan(args[0].shape[1], nb, bl)
    assert plan.resident == (size in ("c5", "under"))
    _mix_on_card(args, nb, bl)


@pytest.mark.parametrize("bl", [100, 256, 1000])
@pytest.mark.parametrize("L", [300, kernels.VOICE_MIX_RESIDENT_LPAD])
@pytest.mark.parametrize("tight", [False, True])
def test_kernel_ragged_block_lengths(cuda, bl, L, tight):
    """Block lengths that are not a multiple of the kernel's 256-frame
    tile, resident and streamed, with slot tables over one 32-slot chunk;
    `tight`: begins up to lpad - bl, so a ragged last tile's window runs
    past the buffer's end (make_padded_sample's right pad covers it)."""
    rng = np.random.default_rng(bl + L + tight)
    nb, P = 5, 7 if L == 300 else 300
    padded, begins, al, ar = _mix_args(cuda, rng, nb, bl, P, L)
    if tight:
        lpad = padded.shape[1]
        b = rng.integers(lpad - 2 * bl, lpad - bl + 1, (nb, P))
        b[0, 0] = lpad - bl
        begins = torch.from_numpy(b.astype(np.int32)).to(cuda)
    _mix_on_card((padded, begins, al, ar), nb, bl)


@pytest.mark.parametrize("size", ["c5", "long"])
def test_kernel_at_c7_width_matches_plain_on_card(cuda, size):
    """c7's 128 slots a block (four 32-slot chunks of a warp's slot table)
    over a 375-block window, in both regimes of kernels.voice_mix_plan:
    the 0.08 s hit staged in shared memory, a 30 s sample streamed.
    Bit-exact."""
    rng = np.random.default_rng(128)
    nb, bl, P = 375, 1024, 128
    args = _mix_args(cuda, rng, nb, bl, P, _LPADS[size] - 2 * bl - 256)
    plan = kernels.voice_mix_plan(args[0].shape[1], nb, bl)
    assert plan.resident == (size == "c5")
    _mix_on_card(args, nb, bl)


def test_small_c5_render_on_card_matches_cpu(cuda, tmp_path):
    packets = write_c5_project(tmp_path, 2.0, 8000, 256, n_tracks=8,
                               hit_sr=16000, bd=16)
    n0 = voices.launches
    load_state(tmp_path, cuda, packets).render()
    assert voices.launches > n0
    got, _ = read_wav_ints(tmp_path / "mix.wav")
    load_state(tmp_path, torch.device("cpu"), packets).render()
    want, _ = read_wav_ints(tmp_path / "mix.wav")
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("T", [1, 5, 1000, 1025, 100003, 384000])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_scan_kernel_matches_plain_on_card(cuda, T, C):
    """The kernel scans tiles of runs, the plain version is a two-level
    log-step scan: both are held to a float64 recurrence at 1e-4 (the
    reference's bound) and to each other at 1e-5, relative to the largest
    |y|; a second run of the same input is bit-identical."""
    rng = np.random.default_rng(T * 10 + C)
    b = rng.normal(size=(T, C)).astype(np.float32)
    a = rng.uniform(0.0, 0.999, C).astype(np.float32)
    a[0] = 0.99584  # the 30 Hz lane at 48 kHz
    y0 = rng.normal(size=C).astype(np.float32)
    args = [torch.from_numpy(v).to(cuda) for v in (b, a, y0)]
    n0 = scan.launches
    got = scan.affine_scan(*args)
    torch.cuda.synchronize()
    assert scan.launches == n0 + 1
    assert torch.equal(scan.affine_scan(*args), got)
    want = scan.affine_scan_plain(*args)
    y64 = np.empty((T, C))
    prev = y0.astype(np.float64)
    a64 = a.astype(np.float64)
    for t in range(T):  # vectorised over lanes
        prev = a64 * prev + b[t]
        y64[t] = prev
    scale = max(1.0, np.abs(y64).max())
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(g, y64, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(w, y64, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("write", [write_c2_project, write_c3_project])
def test_small_c2_c3_renders_on_card_match_cpu(cuda, tmp_path, write):
    write(tmp_path, 2.0, 8000, 256)
    n0 = scan.launches
    load_state(tmp_path, cuda).render()
    if write is write_c3_project:
        assert scan.launches > n0  # the band-pass ran the kernel
    got, _ = read_wav_ints(tmp_path / "outp.wav")
    load_state(tmp_path, torch.device("cpu")).render()
    want, _ = read_wav_ints(tmp_path / "outp.wav")
    assert np.abs(got).max() > 16000
    assert np.abs(got - want).max() <= 1


class _CaptureSink(Sink):
    def __init__(self) -> None:
        self.chunks: list[np.ndarray] = []

    def queue_audio(self, interleaved: np.ndarray) -> None:
        self.chunks.append(np.array(interleaved, np.float32, copy=True))


def test_player_on_card(cuda, tmp_path):
    """play() on the card queues host audio equal to the CPU render of the
    same blocks (atol 1e-5); tick() goes on queueing finite audio."""
    write_c2_project(tmp_path, 2.0, 8000, 256)
    sink = _CaptureSink()
    player = Player(load_state(tmp_path, cuda), sink, 8000, 256)
    player.play()
    (pre,) = sink.chunks
    cpu = load_state(tmp_path, torch.device("cpu"))
    want = cpu.compiled.render_window(cpu.fb, Player.PREBUFFER_BLOCKS)
    np.testing.assert_allclose(pre, want.numpy().reshape(-1), rtol=0,
                               atol=1e-5)
    assert player.tick() >= 1
    assert all(np.isfinite(c).all() for c in sink.chunks[1:])


# T = 1, a few frames, a ragged T over a few and over many tiles, one c4
# window (375 blocks of 1024 frames) with one frame more
EDGE_T = [1, 7, 511, 1025, 100003, 384001]


def _max_decay64(x, r, y0):
    y = np.empty(x.shape, np.float64)
    prev = y0.astype(np.float64)
    for t in range(x.shape[0]):
        prev = np.maximum(x[t], r * prev)
        y[t] = prev
    return y


def _check_close(got, want, y64, what):
    """Both forms within 1e-4 of float64 and within 1e-5 of each other,
    relative to max |y| (the rules of chip_smoke's scan phases)."""
    scale = max(1.0, float(np.abs(y64).max()))
    np.testing.assert_allclose(got, y64, rtol=0, atol=1e-4 * scale,
                               err_msg=f"{what}: kernel vs float64")
    np.testing.assert_allclose(want, y64, rtol=0, atol=1e-4 * scale,
                               err_msg=f"{what}: plain vs float64")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=f"{what}: kernel vs plain")


# the one-lane tile of kernels.scan_plan for the max-decay: 1792 frames
MAX_DECAY_EDGE_T = [1791, 1792, 1793, 2 * 1792 + 1]


@pytest.mark.parametrize("T,C", [(T, 1) for T in EDGE_T + MAX_DECAY_EDGE_T]
                         + [(1025, 4), (67, 1785), (4097, 33), (1025, 64)])
def test_max_decay_kernel_matches_plain_on_card(cuda, T, C):
    """The tiled kernel at the plan's tile edges, over many tiles, and on
    wide rows; a second run of the same input is bit-identical."""
    rng = np.random.default_rng(T + 3 * C)
    x = np.abs(rng.normal(size=(T, C))).astype(np.float32)
    x[::977] *= 5.0  # peaks
    r = rng.uniform(0.9, 0.99999, C).astype(np.float32)
    r[0] = np.exp(np.float32(-1.0) / np.float32(250 * 0.001 * 48000))
    y0 = rng.uniform(0, 3, C).astype(np.float32)
    args = [torch.from_numpy(v).to(cuda) for v in (x, r, y0)]
    n0 = scan.max_decay_launches
    got = scan.max_decay_scan(*args)
    torch.cuda.synchronize()
    assert scan.max_decay_launches == n0 + 1
    assert torch.equal(scan.max_decay_scan(*args), got)
    want = scan.max_decay_scan_plain(*args)
    _check_close(got.cpu().numpy(), want.cpu().numpy(),
                 _max_decay64(x, r.astype(np.float64), y0), "max_decay")


def test_max_decay_kernel_holds_a_long_slow_decay_on_card(cuda):
    """A 250 ms release at 48 kHz (r = 0.99992) decaying from one peak
    over 100,003 frames (56 tiles): every run and every tile multiplies
    the same r, so a rounding error shared by them would compound; the
    kernel stays within 1e-5 of max |y| of a float64 recurrence."""
    rng = np.random.default_rng(8)
    x = (0.01 * np.abs(rng.normal(size=(100003, 1)))).astype(np.float32)
    x[5, 0] = 3.0
    r = np.exp(np.float32(-1.0) / np.float32(250 * 0.001 * 48000)).reshape(1)
    y0 = np.zeros(1, np.float32)
    got = scan.max_decay_scan(*(torch.from_numpy(v).to(cuda)
                                for v in (x, r, y0))).cpu().numpy()
    y64 = _max_decay64(x, r.astype(np.float64), y0)
    np.testing.assert_allclose(got, y64, rtol=0,
                               atol=1e-5 * np.abs(y64).max())


def test_max_decay_kernel_propagates_nan_on_card(cuda):
    """CUDA's fmaxf drops NaN; the kernel's max must not."""
    x = np.ones((4000, 2), np.float32)
    x[1234, 0] = np.nan
    r = np.full(2, 0.999, np.float32)
    y0 = np.full(2, -3.0e38, np.float32)
    got = scan.max_decay_scan(*(torch.from_numpy(v).to(cuda)
                                for v in (x, r, y0))).cpu().numpy()
    assert np.isnan(got[1234:, 0]).all() and not np.isnan(got[:1234]).any()
    assert not np.isnan(got[:, 1]).any()


def _complex64(f, p, s):
    u = np.empty(f.shape, np.complex128)
    prev = s.astype(np.complex128)
    for t in range(f.shape[0]):
        prev = p * prev + f[t]
        u[t] = prev
    return u


def _eq_poles(sr=48000):
    """The conjugate poles of the c4 crossovers (180 Hz and 4 kHz)."""
    out = []
    for f in (180.0, 4000.0):
        _, _, _, a1, a2 = filters.biquad_coefs("lowpass", f, sr)
        out.append((-a1 + 1j * np.sqrt(4 * a2 - a1 * a1)) / 2)
    return out


@pytest.mark.parametrize("T,C", [(T, 4) for T in EDGE_T] + [
    (1025, 1), (300, 600), (384000, 1), (384000, 2)])
def test_complex_scan_kernel_matches_plain_on_card(cuda, T, C):
    rng = np.random.default_rng(7 * T + C)
    p180, p4k = _eq_poles()
    poles = np.resize(np.asarray([p180, np.conj(p4k), 0.95, -0.6 + 0.5j]),
                      C).astype(np.complex64)
    f = (rng.normal(size=(T, C)) + 1j * rng.normal(size=(T, C))).astype(
        np.complex64)
    s = (rng.normal(size=C) + 1j * rng.normal(size=C)).astype(np.complex64)
    host = (f.real, f.imag, poles.real, poles.imag, s.real, s.imag)
    args = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for v in host]
    n0 = scan.complex_launches
    gr, gi = scan.complex_affine_scan(*args)
    torch.cuda.synchronize()
    assert scan.complex_launches == n0 + 1
    again = scan.complex_affine_scan(*args)
    assert torch.equal(again[0], gr) and torch.equal(again[1], gi)
    wr, wi = scan.complex_affine_scan_plain(*args)
    u64 = _complex64(f.astype(np.complex128), poles.astype(np.complex128),
                     s)
    _check_close(gr.cpu().numpy(), wr.cpu().numpy(), u64.real, "real")
    _check_close(gi.cpu().numpy(), wi.cpu().numpy(), u64.imag, "imag")


def _tiled_args(op, T, C, seed, pole=None):
    """Seeded inputs of the affine (b, a, y0) or complex (f_r, f_i, p_r,
    p_i, s_r, s_i) scan, and their float64 recurrence as [parts]. `pole`
    sets every lane's a (affine) or |p| (complex, the conjugate pair at
    20 Hz at 48 kHz on alternate lanes)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, C)).astype(np.float32)
    if op == "affine":
        a = (np.full(C, pole) if pole else rng.uniform(0.0, 0.999, C))
        a = a.astype(np.float32)
        y0 = rng.normal(size=C).astype(np.float32)
        y64 = np.empty((T, C))
        prev = y0.astype(np.float64)
        for t in range(T):
            prev = a.astype(np.float64) * prev + x[t]
            y64[t] = prev
        return (x, a, y0), [y64]
    if pole:
        p = pole * np.exp(2j * np.pi * 20.0 / 48000)
        poles = np.resize(np.asarray([p, np.conj(p)]), C)
    else:
        p180, p4k = _eq_poles()
        poles = np.resize(np.asarray([p180, np.conj(p4k), 0.95, -0.6 + 0.5j]),
                          C)
    poles = poles.astype(np.complex64)
    fi = rng.normal(size=(T, C)).astype(np.float32)
    s = (rng.normal(size=C) + 1j * rng.normal(size=C)).astype(np.complex64)
    u64 = _complex64(x + 1j * fi.astype(np.float64),
                     poles.astype(np.complex128), s)
    return (x, fi, poles.real.copy(), poles.imag.copy(), s.real.copy(),
            s.imag.copy()), [u64.real, u64.imag]


_TILED = {"affine": (scan.affine_scan, scan.affine_scan_plain),
          "complex": (scan.complex_affine_scan,
                      scan.complex_affine_scan_plain)}


@pytest.mark.parametrize("op", sorted(_TILED))
@pytest.mark.parametrize("T,C", [(100, 4), ("ragged", 4), ("ragged", 1),
                                 (216, 1785), (67, 11520)])
def test_tiled_scan_matches_plain_on_card(cuda, op, T, C):
    """The tiled kernels, beside the shapes of the two tests above: below
    one tile, ragged over three tiles of kernels.scan_plan, the longest
    reverb comb and the delay of c4's feedback lines; against their plain
    versions and float64 (the rules of chip_smoke's scan phases), and two
    runs of the same input bit-identical."""
    fn, plain = _TILED[op]
    if T == "ragged":
        T = 3 * kernels.scan_plan(384000, C, op).s + 5
    host, y64 = _tiled_args(op, T, C, seed=T + C)
    args = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for v in host]
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    got = got if op == "complex" else (got,)
    again = again if op == "complex" else (again,)
    want = plain(*args)
    want = want if op == "complex" else (want,)
    for g, a, w, y in zip(got, again, want, y64):
        assert torch.equal(g, a)
        _check_close(g.cpu().numpy(), w.cpu().numpy(), y, f"{op} {T}x{C}")


@pytest.mark.parametrize("op", sorted(_TILED))
def test_tiled_scan_slow_pole_on_card(cuda, op):
    """A slow pole (a or |p| = 0.9999) over one c4 window: every tile
    composes the same power of the pole, so an error shared by the tiles
    would compound; the kernel stays within 1e-4 of float64 relative to
    max |y|."""
    fn, _ = _TILED[op]
    host, y64 = _tiled_args(op, 384000, 4, seed=3, pole=0.9999)
    got = fn(*(torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
               for v in host))
    got = got if op == "complex" else (got,)
    scale = max(float(np.abs(y).max()) for y in y64)
    for g, y in zip(got, y64):
        np.testing.assert_allclose(g.cpu().numpy(), y, rtol=0,
                                   atol=1e-4 * scale)


@pytest.mark.parametrize("op", ["affine", "max_decay", "complex"])
def test_scan_wrappers_refuse_mixes_and_count_only_on_card(cuda, op):
    fn = {"affine": scan.affine_scan, "max_decay": scan.max_decay_scan,
          "complex": scan.complex_affine_scan}[op]
    seqs = 2 if op == "complex" else 1
    lanes = 4 if op == "complex" else 2

    def args(dev, dtype=torch.float32, bad=None):
        out = [torch.ones(50, 3, dtype=dtype, device=dev)
               for _ in range(seqs)]
        out += [torch.full((3,), 0.5, dtype=dtype, device=dev)
                for _ in range(lanes)]
        if bad is not None:
            out[bad] = out[bad].to("cpu" if dev.type == "cuda" else cuda)
        return out

    counters = ("launches", "max_decay_launches", "complex_launches")
    before = [getattr(scan, c) for c in counters]
    fn(*args(torch.device("cpu")))
    assert [getattr(scan, c) for c in counters] == before
    for bad in (0, seqs):  # a sequence, then a per-lane value elsewhere
        with pytest.raises(ValueError, match="on cpu"):
            fn(*args(cuda, bad=bad))
    with pytest.raises(TypeError, match="float32"):
        fn(*args(cuda, dtype=torch.float64))
    noncontig = args(cuda)
    noncontig[0] = torch.ones(3, 50, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        fn(*noncontig)
    assert [getattr(scan, c) for c in counters] == before
    fn(*args(cuda))
    after = [getattr(scan, c) for c in counters]
    assert sum(a - b for a, b in zip(after, before)) == 1


# SampSyn windows (utils/fixtures.sampsyn_window): c4's chords, one and
# three snapshots (uneven times), another table width, eight snapshots (a
# 64 KB table), one and 64 slots, every slot empty, frames since note-on
# past 2^31, a block length that is not a multiple of a CTA's frames;
# every note's n * c_fix wraps 2^32, and the notes are released inside
# the window and after it
_SAMPSYN = {
    "c4_chords": dict(nb=375, bl=1024, P=8, N=64),
    "K1": dict(nb=16, bl=1024, P=8, N=24, K=1),
    "K3_uneven": dict(nb=16, bl=1024, P=8, N=24, K=3, uneven=True),
    "W600": dict(nb=16, bl=1024, P=8, N=24, W=600),
    "K8": dict(nb=16, bl=1024, P=8, N=24, K=8),
    "P1": dict(nb=32, bl=1024, P=1, N=12, empty=0.0),
    "P64": dict(nb=8, bl=1024, P=64, N=96),
    "empty": dict(nb=8, bl=512, P=8, N=16, empty=1.0),
    "wrap": dict(nb=8, bl=700, P=8, N=16, wrap=True),
    "ragged_bl": dict(nb=5, bl=1500, P=8, N=16),
}
_SAMPSYN_CONFS = [
    hit_conf(0.01, 0.1, 0.8, 5.0, 0.2, 0.5),  # the fixtures' chords
    AdsrConf(0.2, 0.0, 1.0, 0.05, 0.5, 0.1, 0.3, 0.0, 0.0),  # no attack
    AdsrConf(0.0, 0.01, -2.0, 0.02, 0.5, 0.03, 0.2, 0.04, 0.0),  # <= -1
]


@pytest.mark.parametrize("case", sorted(_SAMPSYN))
def test_sampsyn_kernel_matches_plain_on_card(cuda, case):
    """csrc/sampsyn.cu against sampsyn_plain on the card, each window under
    three envelopes: within 2e-6 (the kernel sums the slots in their
    order, torch.sum in its own), one launch counted a call."""
    c = _SAMPSYN[case]
    bake, frames, ib, times, waves = sampsyn_window(cuda, seed=7, **c)
    nb, bl = c["nb"], c["bl"]
    if case == "c4_chords":
        off, T = bake["off_f"].cpu().numpy(), int(frames[-1]) + 1
        assert ((off > int(frames[0])) & (off < T)).any()  # off mid-window
        assert (off >= T).any()  # an off baked ahead
    for conf in _SAMPSYN_CONFS:
        n0 = synthv.sampsyn_launches
        got = synthv.sampsyn(bake, frames, nb, bl, conf, times, waves, ib)
        torch.cuda.synchronize()
        assert synthv.sampsyn_launches == n0 + 1
        want = synthv.sampsyn_plain(bake, frames, nb, bl, conf, times, waves,
                                    ib)
        assert got.shape == want.shape == (nb * bl, 2)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
        assert torch.equal(got[:, 0], got[:, 1])
        if case != "empty" and conf is _SAMPSYN_CONFS[0]:
            assert float(want.abs().max()) > 0.05
    if case == "empty":
        assert not bool(got.any())


def test_sampsyn_kernel_replays_in_a_cuda_graph_on_card(cuda):
    """Captured in a CUDA graph, the kernel reads its inputs at replay: a
    replay equals the eager call, and again after new inputs are copied
    into the captured tensors."""
    conf = _SAMPSYN_CONFS[0]
    first = sampsyn_window(cuda, 16, 1024, 8, 24, seed=3)
    second = sampsyn_window(cuda, 16, 1024, 8, 24, seed=4)
    bake, frames, ib, times, waves = first

    def run():
        return synthv.sampsyn(bake, frames, 16, 1024, conf, times, waves, ib)

    eager = [synthv.sampsyn(a[0], a[1], 16, 1024, conf, *a[3:], a[2])
             for a in (first, second)]
    run()  # loaded before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager[0])
    for k, v in second[0].items():
        bake[k].copy_(v)
    for dst, src in zip((frames, ib, times, waves), second[1:]):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager[1])


def test_sampsyn_launches_one_a_window_on_card(cuda, tmp_path):
    """A c3 render (one SampSyn vertex): each captured program holds one
    sampsyn launch, the wrapper counts its warm-up and capture; an eager
    window counts one more."""
    write_c3_project(tmp_path, 2.0, 8000, 256)
    st = load_state(tmp_path, cuda)
    n0 = synthv.sampsyn_launches
    st.render()
    progs = st.compiled.programs()
    assert progs and all(p.kernels.get("sampsyn") == 1 for p in progs)
    assert synthv.sampsyn_launches - n0 == 2 * len(progs)
    n1 = synthv.sampsyn_launches
    st.fb.set_time(0)
    st.compiled.set_time(0)
    st.compiled.render_window(st.fb, 4, eager=True)
    assert synthv.sampsyn_launches == n1 + 1


def test_sampsyn_wrapper_refuses_mixes_on_card(cuda):
    """A bake column or the table on the CPU beside CUDA frames raises
    before any launch; CPU tensors never count a launch."""
    conf = _SAMPSYN_CONFS[0]
    n0 = synthv.sampsyn_launches
    bake, frames, ib, times, waves = sampsyn_window(cuda, 4, 256, 8, 12)
    synthv.sampsyn({k: v.cpu() for k, v in bake.items()}, frames.cpu(), 4,
                   256, conf, times.cpu(), waves.cpu(), ib.cpu())
    assert synthv.sampsyn_launches == n0
    with pytest.raises(ValueError, match="on cpu"):
        synthv.sampsyn(dict(bake, cyc=bake["cyc"].cpu()), frames, 4, 256,
                       conf, times, waves, ib)
    with pytest.raises(ValueError, match="on cpu"):
        synthv.sampsyn(bake, frames, 4, 256, conf, times, waves.cpu(), ib)
    assert synthv.sampsyn_launches == n0


# the instrument session's note arms (benchmark/configs/c9_poly32.json):
# a 375-block window of 32 slots, the cell's ADSR and oscillators, a
# K = 4 table
_POLY_CONF = hit_conf(0.01, 0.2, 0.8, 3.0, 0.4, 0.8)


def _poly_window(cuda):
    from termdaw_tpu_torch.graph.compile import time_table

    nb, bl, sr = 375, 1024, 48000
    bake, frames, ib, times, waves = sampsyn_window(
        cuda, nb, bl, 32, 128, K=4, seed=11, empty=0.5)
    bake = dict(bake, hz=bake["cyc"] * float(sr))
    ttab = torch.from_numpy(time_table(sr, int(frames[-1]) + 1)).to(cuda)
    time2d = ttab[frames].reshape(nb, bl)
    return bake, frames, ib, times, waves, time2d


def _on_cpu(*args):
    return [({k: v.cpu() for k, v in a.items()} if isinstance(a, dict)
             else a.cpu()) for a in args]


def test_poly_synth_arm_at_the_cell_window_on_card(cuda):
    """The Synth arm, all three oscillators on, at c9's window [375, 1024,
    32] on the card against the same arm on the CPU: within 1e-5 (the
    card's and the CPU's f32 sine differ by an ulp, and each sums the 32
    slots in its own order: up to 32 roundings of partial sums below 4,
    at 2.4e-7 each)."""
    bake, frames, ib, _t, _w, time2d = _poly_window(cuda)
    args = (0.5, 0.6, _POLY_CONF, 0.7, 0.8, _POLY_CONF, 0.6, _POLY_CONF)
    got = synthv.synth(bake, frames, 375, 1024, *args, time2d, ib)
    cb, cf, cib, ct = _on_cpu(bake, frames, ib, time2d)
    want = synthv.synth(cb, cf, 375, 1024, *args, ct, cib)
    assert float(want.abs().max()) > 0.5
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def test_poly_sampsyn_kernel_at_the_cell_window_on_card(cuda):
    """csrc/sampsyn.cu at c9's window (32 slots, a K = 4 table) against
    sampsyn_plain on the CPU: within 1e-5 (the kernel adds the 32 slots
    in their order, torch.sum on the CPU in its own; see above), one
    launch."""
    bake, frames, ib, times, waves, _ = _poly_window(cuda)
    n0 = synthv.sampsyn_launches
    got = synthv.sampsyn(bake, frames, 375, 1024, _POLY_CONF, times, waves,
                         ib)
    torch.cuda.synchronize()
    assert synthv.sampsyn_launches == n0 + 1
    want = synthv.sampsyn_plain(*_on_cpu(bake, frames), 375, 1024,
                                _POLY_CONF, *_on_cpu(times, waves, ib))
    assert float(want.abs().max()) > 0.5
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


# Synth windows (utils/fixtures.synth_window): c9's cell window (32 slots,
# half empty) and c4's bass (2 slots); one and 64 slots, every slot
# empty, notes begun 2^31 frames before the window (frames since note-on
# past 2^31), a block length that is not a multiple of a CTA's frames,
# and a window 300 s in, where t * hz * 2pi passes ops/osc's 4e5
# reduction bound for the higher pitches; notes are released inside the
# window and after it. Each window under its oscillator sets: c9's (all
# three on one ADSR), c4's bass (square and top-flat, two ADSRs, the
# triangle off), each oscillator alone, all volumes 0, and three ADSRs
# with zero-length segments (no attack, no release; velocities <= -1)
_SYN_HIT = hit_conf(0.001, 0.02, 0.0, 0.0, 0.0, 0.0)
_SYN_NOTE = hit_conf(0.01, 0.1, 0.8, 5.0, 0.2, 0.5)
_SYN_ZERO = AdsrConf(0.2, 0.0, 1.0, 0.05, 0.5, 0.1, 0.3, 0.0, 0.0)
_SYN_NEG = AdsrConf(0.0, 0.01, -2.0, 0.02, 0.5, 0.03, 0.2, 0.04, 0.0)
_SYN_OSCS = {
    "c9": (0.5, 0.6, _POLY_CONF, 0.7, 0.8, _POLY_CONF, 0.6, _POLY_CONF),
    "c4_bass": (0.4, 0.3, _SYN_HIT, 1.0, 0.8, _SYN_NOTE, 0.0, AdsrConf()),
    "square": (0.5, 0.6, _SYN_NOTE, 0.0, 0.8, _SYN_NOTE, 0.0, _SYN_NOTE),
    "top_flat": (0.0, 0.6, _SYN_HIT, 0.7, 0.8, _SYN_NOTE, 0.0, _SYN_NEG),
    "triangle": (0.0, 0.6, _SYN_NOTE, 0.0, 0.8, _SYN_HIT, 0.6, _SYN_NEG),
    "silent": (0.0, 0.6, _SYN_NOTE, 0.0, 0.8, _SYN_HIT, 0.0, _SYN_NEG),
    "zero_segments": (0.5, 0.6, _SYN_ZERO, 0.7, 0.3, _SYN_NEG, 0.6,
                      _SYN_HIT),
}
_ALL_OSCS = ("c9", "c4_bass", "square", "top_flat", "triangle", "silent",
             "zero_segments")
_SYNTH = {
    "c9": (dict(nb=375, bl=1024, P=32, N=128, empty=0.5), ("c9",)),
    "c4_bass": (dict(nb=375, bl=1024, P=2, N=64), ("c4_bass",)),
    "P1": (dict(nb=32, bl=1024, P=1, N=12, empty=0.0), _ALL_OSCS),
    "P64": (dict(nb=8, bl=1024, P=64, N=96), _ALL_OSCS),
    "empty": (dict(nb=8, bl=512, P=8, N=16, empty=1.0), ("c9", "c4_bass")),
    "wrap": (dict(nb=8, bl=700, P=8, N=16, wrap=True), _ALL_OSCS),
    "ragged_bl": (dict(nb=5, bl=1500, P=8, N=16), _ALL_OSCS),
    "far": (dict(nb=16, bl=1024, P=8, N=24, start_sec=300.0), _ALL_OSCS),
}


@pytest.mark.parametrize("case", sorted(_SYNTH))
def test_synth_kernel_matches_plain_on_card(cuda, case):
    """csrc/synth.cu against synth_plain on the card, each window under its
    oscillator sets: within 2e-6, 1e-5 at 32 and 64 slots (each slot's
    value is the plain version's, the same sinf and the same f32 order;
    only the sum over slots differs, the kernel's in slot order and
    torch.sum's in its own), one launch counted a call."""
    w, oscs = _SYNTH[case]
    bake, frames, time2d, ib = synth_window(cuda, seed=7, **w)
    nb, bl = w["nb"], w["bl"]
    off, T = bake["off_f"].cpu().numpy(), int(frames[-1]) + 1
    if case not in ("empty", "wrap"):
        assert ((off > int(frames[0])) & (off < T)).any()  # off mid-window
    if case == "far":  # the sine's arguments on both sides of 4e5
        hz = bake["hz"]
        assert float(time2d.min() * hz.min()) * 2 * np.pi < 4e5 \
            < float(time2d.max() * hz.max()) * 2 * np.pi
    # 2e-6, as the SampSyn kernel is held; at 32 and 64 slots 1e-5, as the
    # SampSyn kernel at c9's window: up to 32 and more roundings of
    # partial sums below 4 at 2.4e-7 each, in either order
    atol = 2e-6 if w["P"] <= 8 else 1e-5
    for name in oscs:
        args = _SYN_OSCS[name]
        n0 = synthv.synth_launches
        got = synthv.synth(bake, frames, nb, bl, *args, time2d, ib)
        torch.cuda.synchronize()
        assert synthv.synth_launches == n0 + 1
        want = synthv.synth_plain(bake, frames, nb, bl, *args, time2d, ib)
        assert got.shape == want.shape == (nb * bl, 2)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=0, atol=atol,
                                   msg=f"{case}, {name}")
        assert torch.equal(got[:, 0], got[:, 1])
        if case != "empty" and name != "silent":
            assert float(want.abs().max()) > 0.05, name
        if case == "empty" or name == "silent":
            assert not bool(got.any())


def test_synth_kernel_replays_in_a_cuda_graph_on_card(cuda):
    """Captured in a CUDA graph, the kernel reads its inputs at replay: a
    replay equals the eager call, and again after new inputs are copied
    into the captured tensors."""
    args = _SYN_OSCS["c9"]
    first = synth_window(cuda, 16, 1024, 8, 24, seed=3)
    second = synth_window(cuda, 16, 1024, 8, 24, seed=4)
    bake, frames, time2d, ib = first

    def run():
        return synthv.synth(bake, frames, 16, 1024, *args, time2d, ib)

    eager = [synthv.synth(a[0], a[1], 16, 1024, *args, a[2], a[3])
             for a in (first, second)]
    run()  # loaded before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager[0])
    for k, v in second[0].items():
        bake[k].copy_(v)
    for dst, src in zip((frames, time2d, ib), second[1:]):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager[1])


def test_synth_launches_one_a_window_on_card(cuda, tmp_path):
    """A c3 render (one Synth vertex, the bass): each captured program
    holds one synth launch, the wrapper counts its warm-up and capture; an
    eager window counts one more."""
    write_c3_project(tmp_path, 2.0, 8000, 256)
    st = load_state(tmp_path, cuda)
    n0 = synthv.synth_launches
    st.render()
    progs = st.compiled.programs()
    assert progs and all(p.kernels.get("synth") == 1 for p in progs)
    assert synthv.synth_launches - n0 == 2 * len(progs)
    n1 = synthv.synth_launches
    st.fb.set_time(0)
    st.compiled.set_time(0)
    st.compiled.render_window(st.fb, 4, eager=True)
    assert synthv.synth_launches == n1 + 1


def test_synth_wrapper_refuses_mixes_on_card(cuda):
    """A bake column, time2d or the in-block clock on the CPU beside CUDA
    frames raises before any launch; CPU tensors never count a launch."""
    args = _SYN_OSCS["c4_bass"]
    n0 = synthv.synth_launches
    bake, frames, time2d, ib = synth_window(cuda, 4, 256, 8, 12)
    synthv.synth({k: v.cpu() for k, v in bake.items()}, frames.cpu(), 4, 256,
                 *args, time2d.cpu(), ib.cpu())
    assert synthv.synth_launches == n0
    with pytest.raises(ValueError, match="on cpu"):
        synthv.synth(dict(bake, hz=bake["hz"].cpu()), frames, 4, 256, *args,
                     time2d, ib)
    with pytest.raises(ValueError, match="on cpu"):
        synthv.synth(bake, frames, 4, 256, *args, time2d.cpu(), ib)
    with pytest.raises(ValueError, match="on cpu"):
        synthv.synth(bake, frames, 4, 256, *args, time2d, ib.cpu())
    assert synthv.synth_launches == n0


# the crossovers the fused eq3 is held at: every pair of the mix session
# (projects/mix_session.EQ_LOW x EQ_HIGH), c4's and the clamp edges (the
# lowest f_lo, the highest f_hi at 48 kHz); a few frames, c4's and c8's
# window, a timeline of several tiles of kernels.scan_plan(T, 4, "eq3")
# and a prime
_EQ3_PAIRS = ([(lo, hi) for lo in EQ_LOW for hi in EQ_HIGH]
              + [(180.0, 4000.0), (10.0, 0.35 * 48000)])
_EQ3_T = [1, 2, 5, 1024, 16 * 1024, 100003, 384000]


def _eq3_tol(f_lo):
    """The bound of the kernel against the plain composition and against
    float64, relative to max |y|. The pole cascade in f32 rounds its taps
    and poles, and a slow pole pair amplifies that rounding: from 100 Hz
    up both forms read up to ~3e-5 off float64 and off each other, at
    f_lo = 10 Hz up to ~1.5e-3 (a CPU emulation of the kernel over 3
    windows of 100,003 frames)."""
    return 4e-3 if f_lo < 100.0 else 1e-4


def _eq3_float64(x, coefs, gains):
    """The eq3 over the whole stream x [N, 2] from rest as a float64
    direct-form cascade of the f32 coefficients: (y [N, 2], each stage's
    output [N, 4])."""
    from scipy.signal import lfilter
    lo, hi = (np.asarray([c.cpu().numpy() for c in cc], np.float64)
              for cc in coefs)

    def stage(u, c):
        return np.stack([lfilter(c[:3, l], [1.0, *c[3:, l]], u[:, l])
                         for l in range(4)], axis=1)

    t0 = stage(np.concatenate([x, x], axis=1), lo)
    t1 = stage(t0, lo)
    t2 = stage(np.concatenate([t1[:, 2:4], t1[:, 2:4]], axis=1), hi)
    t3 = stage(t2, hi)
    y = t1[:, 0:2] * gains[0] + t3[:, 0:2] * gains[1] + t3[:, 2:4] * gains[2]
    stage_in = (np.concatenate([x, x], axis=1), t0,
                np.concatenate([t1[:, 2:4], t1[:, 2:4]], axis=1), t2)
    return y, (t0, t1, t2, t3), stage_in


@pytest.mark.parametrize("pair", _EQ3_PAIRS, ids=lambda p: f"{p[0]:g}-{p[1]:g}")
@pytest.mark.parametrize("T", _EQ3_T)
def test_eq3_kernel_matches_plain_and_float64_on_card(cuda, T, pair):
    """fx.eq3_crossover on the card (csrc/eq3.cu) over 3 windows of T
    frames with the state carried, gains of +-4 dB: against the plain
    composition (fx.eq3_plain: biquad_apply and the complex scan) on the
    card and a float64 direct-form cascade, the audio and each stage's
    state (x[T-1], x[T-2], y[T-1], y[T-2]) within _eq3_tol; no further
    from float64 than twice the plain form. One eq3_launches a call,
    no complex scan launched; CPU tensors launch nothing."""
    sr = 48000
    eff = fx.EFFECTS["eq3"]
    static = fx.bind_static(eff, sr, {"low_freq": pair[0],
                                      "high_freq": pair[1]}, cuda)
    rng = np.random.default_rng(T + int(pair[0]) * 7 + int(pair[1]))
    db = tuple(torch.tensor(g, dtype=torch.float32, device=cuda)
               for g in (4.0, -4.0, 2.5))
    gains = [float(g) for g in fx._eq3_gains(db, db[0])]
    x = (0.5 * rng.normal(size=(3 * T, 2))).astype(np.float32)
    st_k = eff.init_state(sr, static, cuda)
    st_p = eff.init_state(sr, static, cuda)
    yk, yp = [], []
    for w in range(3):
        xw = torch.from_numpy(x[w * T:(w + 1) * T]).to(cuda)
        n0, c0 = fx.eq3_launches, scan.complex_launches
        y, st_k = fx.eq3_crossover(xw, st_k, db, static["coefs"],
                                   static["sections"])
        torch.cuda.synchronize()
        assert fx.eq3_launches == n0 + 1 and scan.complex_launches == c0
        yk.append(y.cpu().numpy())
        y, st_p = fx.eq3_plain(xw, st_p, fx._eq3_gains(db, xw),
                               static["coefs"])
        yp.append(y.cpu().numpy())
    yk, yp = np.concatenate(yk), np.concatenate(yp)
    y64, outs, ins = _eq3_float64(x.astype(np.float64), static["coefs"],
                                  gains)
    tol = _eq3_tol(pair[0])
    scale = max(1.0, float(np.abs(y64).max()))
    np.testing.assert_allclose(yk, yp, rtol=0, atol=tol * scale,
                               err_msg="kernel vs plain")
    np.testing.assert_allclose(yk, y64, rtol=0, atol=tol * scale,
                               err_msg="kernel vs float64")
    assert (np.abs(yk - y64).max()
            <= 2 * np.abs(yp - y64).max() + 1e-5 * scale)
    n = 3 * T
    for i in range(4):
        got = st_k[f"st{i}"].cpu().numpy()
        np.testing.assert_allclose(got, st_p[f"st{i}"].cpu().numpy(),
                                   rtol=0, atol=tol * scale,
                                   err_msg=f"st{i}: kernel vs plain")
        want = np.stack([ins[i][n - 1], ins[i][n - 2] if n > 1 else 0.0,
                         outs[i][n - 1], outs[i][n - 2] if n > 1 else 0.0])
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                   err_msg=f"st{i}: kernel vs float64")
    if T == 1:  # the CPU launches nothing
        n0 = fx.eq3_launches
        fx.eq3_crossover(torch.from_numpy(x[:5]), eff.init_state(
            sr, static, "cpu"), tuple(g.cpu() for g in db),
            tuple(tuple(c.cpu() for c in cc) for cc in static["coefs"]),
            static["sections"].cpu())
        assert fx.eq3_launches == n0


def test_eq3_wrapper_refuses_mixes_on_card(cuda):
    """A state, a gain or the sections on the CPU beside a CUDA window
    raises before any launch."""
    sr = 48000
    eff = fx.EFFECTS["eq3"]
    static = fx.bind_static(eff, sr, fx.static_values(eff, eff.defaults),
                            cuda)
    x = torch.zeros((64, 2), device=cuda)
    st = eff.init_state(sr, static, cuda)
    db = tuple(torch.zeros((), device=cuda) for _ in range(3))
    n0 = fx.eq3_launches
    with pytest.raises(ValueError, match="on cpu"):
        fx.eq3_crossover(x, dict(st, st2=st["st2"].cpu()), db,
                         static["coefs"], static["sections"])
    with pytest.raises(ValueError, match="on cpu"):
        fx.eq3_crossover(x, st, (db[0], db[1].cpu(), db[2]),
                         static["coefs"], static["sections"])
    with pytest.raises(ValueError, match="on cpu"):
        fx.eq3_crossover(x, st, db, static["coefs"],
                         static["sections"].cpu())
    assert fx.eq3_launches == n0


@pytest.mark.parametrize("kind", sorted(fx.EFFECTS))
def test_effect_on_card_matches_cpu(cuda, kind):
    """Each effect over two windows at 48 kHz on the card against the CPU
    path (the kernels against the plain scans), within 1e-4 of max |y|;
    chorus and flanger bit for bit: their LFO is the correctly rounded f32
    sine on both devices (fx._lfo_sin), the rest exactly rounded f32
    arithmetic and gathers (torch's f32 sin put an ulp between the
    devices, which the delayed read amplified by the input's slope)."""
    sr = 48000
    eff = fx.EFFECTS[kind]
    static = fx.static_values(eff, eff.defaults)
    rng = np.random.default_rng(1)
    t = np.arange(30000) / sr
    x = (0.5 * np.sin(2 * np.pi * 110 * t)[:, None]
         + 0.05 * rng.normal(size=(30000, 2))).astype(np.float32)
    states = {d: eff.init_state(sr, static, d) for d in ("cpu", cuda)}
    for lo, hi in ((0, 12000), (12000, 30000)):
        outs = {}
        for d in states:
            p = {k: torch.tensor(v, dtype=torch.float32, device=d)
                 for k, v in eff.defaults.items()
                 if k not in eff.static_params}
            y, states[d] = eff.process(torch.from_numpy(x[lo:hi]).to(d),
                                       states[d], p, sr, static)
            outs[d] = y.cpu().numpy()
        if kind in ("chorus", "flanger"):
            np.testing.assert_array_equal(outs[cuda], outs["cpu"])
            continue
        atol = 1e-4 * max(1.0, float(np.abs(outs["cpu"]).max()))
        np.testing.assert_allclose(outs[cuda], outs["cpu"], rtol=0,
                                   atol=atol)


def test_capture_records_nodes_and_arms_on_card(cuda, tmp_path):
    """Each captured program reads its graph's kernel, copy and set nodes
    once, at its capture, and its vertex arms by kind; the window.capture
    span carries both, and every replay adds its program's nodes to the
    graph's replayed_nodes."""
    import time

    from termdaw_tpu_torch.utils import prof

    write_c4_project(tmp_path, 2.0, 8000, 256, render_sr=8000)
    st = load_state(tmp_path, cuda)
    t0 = time.perf_counter()
    with prof.recording():
        st.render()
        st.render()
    cg = st.compiled
    progs = cg.programs()
    assert progs and all(p.graph is not None for p in progs)
    # a wrapper launch of a hand-written kernel is one node or more
    assert all(p.nodes >= sum(p.kernels.values()) > 0 for p in progs)
    assert cg.replayed_nodes == sum(p.nodes * p.replays for p in progs) > 0
    caps = [r for r in prof.records()
            if r.name == "window.capture" and r.t0 >= t0]
    assert sorted(r.attrs["nodes"] for r in caps) == sorted(
        p.nodes for p in progs)
    assert all(r.attrs["arms"] == p.arms for r, p in zip(caps, progs))
    assert progs[0].arms["pluginfx.reverb"] == 1
    assert progs[0].arms["normalize"] == 1


def test_small_c4_render_on_card_matches_cpu(cuda, tmp_path):
    write_c4_project(tmp_path, 2.0, 8000, 256, render_sr=8000)
    scan.launches = scan.max_decay_launches = scan.complex_launches = 0
    voices.launches = synthv.sampsyn_launches = fx.eq3_launches = 0
    synthv.synth_launches = 0
    load_state(tmp_path, cuda).render()
    assert min(voices.launches, scan.launches, scan.max_decay_launches,
               fx.eq3_launches, synthv.sampsyn_launches,
               synthv.synth_launches) > 0
    assert scan.complex_launches == 0  # the eq3 was its only user here
    got, _ = read_wav_ints(tmp_path / "outp.wav")
    load_state(tmp_path, torch.device("cpu")).render()
    want, _ = read_wav_ints(tmp_path / "outp.wav")
    assert np.abs(got).max() > 16000
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("write", [
    lambda d: write_c1_project(d, 2.0, 8000, 256, render_sr=4000),
    lambda d: write_c4_project(d, 2.0, 8000, 256, render_sr=8000),
], ids=["c1", "c4"])
def test_window_cost_equal_on_card_and_cpu(cuda, tmp_path, write):
    """A window's count (utils/roofline.count_work) on fresh States is the
    same on the card as on the CPU, op by op: the kernel wrappers record
    their formulas on both devices. Once a render captured the window's
    program, the count on the card carries its pool and static inputs as
    the peak (c1: no event vertex, so the window at time 0 after the
    render has the captured program's layout)."""
    from termdaw_tpu_torch.utils import roofline

    write(tmp_path)
    costs, states = [], []
    for dev in (cuda, torch.device("cpu")):
        st = load_state(tmp_path, dev)
        (nb,) = roofline._window_counts(st)
        costs.append(st.compiled.window_cost(st.fb, nb))
        states.append(st)
    got, want = costs
    assert got["ops"] == want["ops"]
    assert got == want
    assert "peak_bytes" not in got["_mem"]  # no program captured yet
    st = states[0]
    st.render()
    if not st.compiled.carries:
        st.fb.set_time(0)
        assert st.compiled.window_cost(st.fb, nb)["_mem"]["peak_bytes"] > 0


def test_small_c4_24_bit_render_on_card_native_on_and_off(cuda, tmp_path,
                                                           monkeypatch):
    """The 24-bit WAV of a c4 cut rendered on the card is the same bytes
    with the native library (its pack24 counted) and without it."""
    write_c4_project(tmp_path, 2.0, 8000, 256, render_sr=8000, bd=24)
    assert native.get_lib() is not None, native.load_error
    n0 = native.calls["pack24"]
    load_state(tmp_path, cuda).render()
    on = (tmp_path / "outp.wav").read_bytes()
    assert native.calls["pack24"] > n0
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("TERMDAW_NATIVE", "0")
    (tmp_path / "outp.wav").unlink()
    n1 = native.calls["pack24"]
    load_state(tmp_path, cuda).render()
    assert native.calls["pack24"] == n1
    assert (tmp_path / "outp.wav").read_bytes() == on
    data, spec = read_wav(tmp_path / "outp.wav")
    assert spec.bits_per_sample == 24 and data.shape[0] >= 16000
    assert np.abs(data).max() > 2 ** 22


def _biquad_args(cuda, T, C, seed):
    """The c4 eq3's stage coefficients (lowpass and highpass at 180 Hz and
    4 kHz, 48 kHz) over C channels, a seeded input and state."""
    cs = np.asarray([filters.biquad_coefs(k, f, 48000) for k, f in (
        ("lowpass", 180.0), ("highpass", 180.0), ("lowpass", 4000.0),
        ("highpass", 4000.0))], np.float32).T  # [5, 4]
    rng = np.random.default_rng(seed)
    host = [rng.normal(size=(T, C)).astype(np.float32)]
    host += [np.ascontiguousarray(np.resize(c, C)) for c in cs]
    host.append(rng.normal(size=(4, C)).astype(np.float32))
    return [torch.from_numpy(v).to(cuda) for v in host]


# the kernel's tile is 2048 / CL frames (CL = C rounded up to a power of two)
@pytest.mark.parametrize("where", ["1", "2", "edge-1", "edge", "edge+1",
                                   "ragged"])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_biquad_seq_kernel_bit_exact_on_card(cuda, where, C):
    """The exact lane's kernel against its plain version, output and
    state, bit for bit: both round every multiply and add on its own in
    the reference's order."""
    F = 2048 // C
    T = {"1": 1, "2": 2, "edge-1": F - 1, "edge": F, "edge+1": F + 1,
         "ragged": 3 * F + 5}[where]
    args = _biquad_args(cuda, T, C, seed=T + C)
    n0 = filters.biquad_seq_launches
    y, s = filters.biquad_apply_sequential(args[0], tuple(args[1:6]),
                                           args[6])
    torch.cuda.synchronize()
    assert filters.biquad_seq_launches == n0 + 1
    wy, ws = filters.biquad_seq_plain(*(a.cpu() for a in args))
    assert torch.equal(y.cpu(), wy) and torch.equal(s.cpu(), ws)


def test_biquad_seq_wrapper_raises_on_card(cuda):
    """Bad shapes, types and devices raise, uncounted; nothing falls back
    to the plain loop on a CUDA tensor."""
    x, *cs, st = _biquad_args(cuda, 100, 4, seed=1)
    n0 = filters.biquad_seq_launches
    with pytest.raises(ValueError, match="state must be"):
        filters.biquad_apply_sequential(x, tuple(cs), st[:, :3])
    with pytest.raises(ValueError, match=r"\[T, C\]"):
        filters.biquad_apply_sequential(x[:, 0], tuple(cs), st)
    with pytest.raises(ValueError, match="on cpu"):
        filters.biquad_apply_sequential(x, tuple(cs), st.cpu())
    with pytest.raises(TypeError, match="float32"):
        filters.biquad_apply_sequential(x.double(), tuple(cs), st)
    with pytest.raises(RuntimeError):
        filters.biquad_apply_sequential(x, tuple(c[:3] for c in cs), st)
    assert filters.biquad_seq_launches == n0
    filters.biquad_apply_sequential(x, tuple(cs), st)
    assert filters.biquad_seq_launches == n0 + 1


def test_small_c4_exact_lane_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """TERMDAW_EXACT_BIQUAD=1: the eq3 runs the kernel (4 launches a
    window: the one window replays a captured program holding 4, and the
    wrapper counts the capture's warm-up and the capture), never the
    complex scan and never the fused eq3 kernel, within one count of the
    CPU."""
    monkeypatch.setenv("TERMDAW_EXACT_BIQUAD", "1")
    write_c4_project(tmp_path, 2.0, 8000, 256, render_sr=8000)
    st = load_state(tmp_path, cuda)
    n0, c0 = filters.biquad_seq_launches, scan.complex_launches
    e0 = fx.eq3_launches
    st.render()
    (prog,) = st.compiled.programs()
    assert prog.kernels["biquad_seq"] == 4 and prog.replays == 1
    assert filters.biquad_seq_launches - n0 == 2 * 4
    assert scan.complex_launches == c0 and fx.eq3_launches == e0
    got, _ = read_wav_ints(tmp_path / "outp.wav")
    load_state(tmp_path, torch.device("cpu")).render()
    want, _ = read_wav_ints(tmp_path / "outp.wav")
    assert np.abs(got).max() > 16000
    assert np.abs(got - want).max() <= 1


def test_chain_served_c5_render_on_card_bit_identical(cuda, tmp_path,
                                                      monkeypatch):
    """A c5 render served from the prebaked chain on the card is
    bit-identical to one baked live (TERMDAW_PREBAKE=0)."""
    packets = write_c5_project(tmp_path, 20.0, 8000, 256, n_tracks=8,
                               hit_sr=16000, bd=16)
    def two_renders(st):
        # the Normalize's running max carries from one render to the next,
        # so render i is compared with render i
        out = []
        for _ in range(2):
            st.render()
            out.append(read_wav_ints(tmp_path / "mix.wav")[0])
        return out

    st = load_state(tmp_path, cuda, packets)
    served = two_renders(st)
    assert st.compiled.served_windows == 4 and st.compiled.live_bakes == 0
    assert st.compiled._prebake_used <= st.compiled._prebake_budget
    monkeypatch.setenv("TERMDAW_PREBAKE", "0")
    live = load_state(tmp_path, cuda, packets)
    want = two_renders(live)
    assert live.compiled.served_windows == 0
    for got, w in zip(served, want):
        np.testing.assert_array_equal(got, w)


# -- the window-program cache: captured graphs --------------------------

_SMALL = {
    "c1": lambda d: write_c1_project(d, 2.0, 8000, 256, render_sr=4000),
    "c2": lambda d: write_c2_project(d, 2.0, 8000, 256),
    "c3": lambda d: write_c3_project(d, 2.0, 8000, 256),
    "c4": lambda d: write_c4_project(d, 2.0, 8000, 256, render_sr=8000),
    "c5": lambda d: write_c5_project(d, 2.0, 8000, 256, n_tracks=8,
                                     hit_sr=16000, bd=16),
}


def _drive(st, nb: int) -> list[np.ndarray]:
    """Windows of nb blocks from t0 = 0, a seek, a parameter change (the
    compressor's ratio where the project has one), a Normalize reset, a
    normalize scan and apply, and windows after each: the audio and then
    every numeric state leaf."""
    cg, out = st.compiled, []

    def windows(n):
        for _ in range(n):
            st.fb.set_time(cg.get_time())
            out.append(cg.render_window(st.fb, nb).cpu().numpy())
            st.fb.advance_blocks(nb)

    windows(3)
    cg.set_time(1000)
    windows(2)
    if st.host.get_index("comp") is not None:
        st.host.set_value("comp", "ratio", 6.0)
        windows(2)
    cg.reset_normalize_vertices()
    windows(1)
    st.scan_exact()
    windows(2)
    for k in sorted(cg.num_state):
        out += [t.cpu().numpy() for t in shard_render.state_leaves(
            cg.num_state[k])]
    return out


@pytest.mark.parametrize("cfg", sorted(_SMALL))
@pytest.mark.parametrize("nb", [1, 4, "render"])
def test_replay_bit_identical_to_eager_on_card(cuda, tmp_path, cfg, nb):
    """Every window replays a captured program (replays == windows) whose
    audio and state are bit-identical to the eager program's, across a
    seek, a parameter change, a Normalize reset and a scan; at the render
    size, two renders' WAVs (served windows among them)."""
    packets = _SMALL[cfg](tmp_path) or b""
    wav = tmp_path / ("mix.wav" if cfg == "c5" else "outp.wav")
    got = {}
    for mode in ("eager", "graphs"):
        st = load_state(tmp_path, cuda, packets)
        if mode == "eager":
            st.compiled.render_window = functools.partial(
                type(st.compiled).render_window, st.compiled, eager=True)
        if nb == "render":
            got[mode] = []
            for _ in range(2):
                st.render()
                got[mode].append(read_wav_ints(wav)[0])
            st.scan_exact()
            st.render()
            got[mode].append(read_wav_ints(wav)[0])
        else:
            got[mode] = _drive(st, nb)
        cg = st.compiled
        if mode == "graphs":
            assert cg.replays == cg.served_windows + cg.live_bakes > 0
            # a seek past the time table drops the programs keyed to it
            assert cg.captures >= len(cg.programs()) > 0
            assert all(p.graph is not None for p in cg.programs())
        else:
            assert cg.replays == cg.captures == 0
    assert len(got["eager"]) == len(got["graphs"])
    for a, b in zip(got["eager"], got["graphs"]):
        np.testing.assert_array_equal(a, b)


def test_served_window_equals_live_on_card(cuda, tmp_path, monkeypatch):
    """The first c5 window served from the prebaked chain replays the same
    program as the live-baked one and gives the same audio, bit for bit."""
    packets = _SMALL["c5"](tmp_path)
    audio = {}
    for mode in ("served", "live"):
        if mode == "live":
            monkeypatch.setenv("TERMDAW_PREBAKE", "0")
        st = load_state(tmp_path, cuda, packets)
        cg = st.compiled
        cg.seed_caps(st.fb, st.cs, st.cs)
        st.fb.set_time(0)
        audio[mode] = cg.render_window(st.fb, st.cs).cpu()
        assert (cg.served_windows, cg.live_bakes) == (
            (1, 0) if mode == "served" else (0, 1))
        assert cg.replays == 1
    assert torch.equal(audio["served"], audio["live"])


def test_capture_with_a_pageable_upload_raises_on_card(cuda, tmp_path,
                                                        monkeypatch):
    """A window program that uploads from pageable host memory cannot be
    captured: the render raises, naming the vertex, and does not fall
    back to the eager program."""
    from termdaw_tpu_torch.ops import sampler

    _SMALL["c1"](tmp_path)
    st = load_state(tmp_path, cuda)
    loop = sampler.sample_loop

    def uploading(sample, t0, T):
        one = torch.from_numpy(np.ones(1, np.float32)).to(sample.device)
        return loop(sample, t0, T) * one

    monkeypatch.setattr(sampler, "sample_loop", uploading)
    with pytest.raises(RuntimeError, match=r"capturing the window program "
                       r"failed in vertex .* \(sampleloop\)"):
        st.render()
    assert st.compiled.replays == 0
    monkeypatch.setattr(sampler, "sample_loop", loop)
    fresh = load_state(tmp_path, cuda)
    fresh.render()
    assert fresh.compiled.replays > 0


def test_capture_beside_another_threads_uploads_on_card(cuda, tmp_path):
    """One thread's first c4 render captures its program while another
    thread, all along, uploads from pageable host memory into fresh
    allocations (the caching allocator has to cudaMalloc new
    segments) and replays its own graph's windows: neither thread fails,
    and each one's audio equals its render alone."""
    import threading

    _SMALL["c4"](tmp_path / "a")
    _SMALL["c5"](tmp_path / "b")
    alone = torch.cat(load_state(tmp_path / "a", cuda).render_device())
    st_b = load_state(tmp_path / "b", cuda)
    cg_b = st_b.compiled

    def window_b():
        cg_b.set_time(0)
        st_b.fb.set_time(0)
        return cg_b.render_window(st_b.fb, 4).cpu()

    want_b = window_b()  # captures b's program
    st_a = load_state(tmp_path / "a", cuda)
    done, errors, uploads = threading.Event(), [], [0]

    def churn():
        kept = []
        try:
            while not done.is_set():
                # 8 MB and a little more each time, all kept: a new
                # segment from cudaMalloc every other upload
                host = np.ones((1 << 21) + 1024 * len(kept), np.float32)
                kept.append(torch.from_numpy(host).to(cuda))
                assert float(kept[-1][-1]) == 1.0
                assert torch.equal(window_b(), want_b)
                uploads[0] += 1
                if len(kept) == 512:
                    kept.clear()
                    torch.cuda.synchronize()
        except BaseException as e:  # raised below, in the test's thread
            errors.append(e)

    t = threading.Thread(target=churn)
    t.start()
    try:
        got = torch.cat(st_a.render_device())
    finally:
        done.set()
        t.join(timeout=60)
    assert not t.is_alive()
    if errors:
        raise errors[0]
    assert uploads[0] > 0
    assert st_a.compiled.captures >= 1
    assert all(p.graph is not None for p in st_a.compiled.programs())
    assert torch.equal(got, alone)


def test_a_dropped_program_is_not_freed_inside_a_capture_on_card(
        cuda, tmp_path):
    """A dropped program waits in a reference cycle for the collector; a
    collection inside a later capture must not free its CUDAGraph there
    (that destroys an executable mid-capture and voids the capture), so
    the capture collects before it begins."""
    write_c1_project(tmp_path, 2.0, 8000, 256, render_sr=4000)
    st = load_state(tmp_path, cuda)
    st.render()
    assert st.compiled.captures > 0
    gc.disable()
    try:
        st.compiled.release_chains()  # its programs: cyclic garbage now
        st2 = load_state(tmp_path, cuda)
        program = st2.compiled._program

        def collecting(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                gc.collect()
            return program(*args, **kwargs)

        st2.compiled._program = collecting
        st2.render()
    finally:
        gc.enable()
    assert st2.compiled.captures > 0
    assert st2.compiled.replays == st2.compiled.served_windows + \
        st2.compiled.live_bakes


def test_replayed_c4_window_host_launches_on_card(cuda, tmp_path):
    """A replayed c4 window, served or live, enqueues at most 8 operations
    from the host (the profiler's CPU-side runtime rows): the bake copies,
    t0, one graph launch and the audio's copy out."""
    from torch.profiler import ProfilerActivity, profile

    _SMALL["c4"](tmp_path)
    st = load_state(tmp_path, cuda)
    cg = st.compiled
    cg.seed_caps(st.fb, st.cs, st.cs)
    fresh = {vi: type(c)() for vi, c in cg.carries.items()}
    st.fb.set_time(0)
    cg.render_window(st.fb, st.cs)  # served; captures the program
    for served in (True, False):
        # the song's start again, from the same carries: the same tables
        cg.set_time(0)
        st.fb.set_time(0)
        cg._apply_carries(dict(fresh))
        cg._prebake_on = served
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cg.render_window(st.fb, st.cs)
            torch.cuda.synchronize()
        rows = [e.name for e in prof.events()
                if e.name in shard_render.ENQUEUES]
        assert rows.count("cudaGraphLaunch") == 1, rows
        assert len(rows) <= 8, rows
    assert (cg.captures, cg.replays) == (1, 3)
    assert (cg.served_windows, cg.live_bakes) == (2, 1)


def test_programs_share_the_graphs_pool_on_card(cuda, tmp_path):
    """A graph's programs capture into one memory pool, which a refresh
    lets go; its pool bytes are the sum of what each capture added. Once
    none of its programs is left, a capture takes a new pool."""
    _SMALL["c4"](tmp_path)
    st = load_state(tmp_path, cuda)
    cg = st.compiled
    for nb in (1, 4, 1, 8):
        st.fb.set_time(cg.get_time())
        cg.render_window(st.fb, nb)
        st.fb.advance_blocks(nb)
    progs = cg.programs()
    assert cg.captures == len(progs) == 3 and cg.replays == 4
    assert cg._graph_pool is not None
    assert all(p.graph.pool() == cg._graph_pool for p in progs)
    assert cg.pool_bytes == sum(p.pool_bytes for p in progs) > 0
    # a window past the time table grows it and drops every program: the
    # next capture takes a new pool (the old one, graphs gone, takes none)
    pool, n = cg._graph_pool, cg._ttab.shape[0]
    del progs
    cg.set_time(n - cg.bl)
    st.fb.set_time(cg.get_time())
    audio = cg.render_window(st.fb, 4)
    assert torch.isfinite(audio).all()
    assert cg._ttab.shape[0] == 2 * n and cg.captures == 4
    assert len(cg.programs()) == 1 and cg._graph_pool != pool
    st.refresh()
    assert cg.programs() == [] and cg._graph_pool is None
    assert cg.pool_bytes == 0


# -- the sharded scans on the card: 2 ranks ------------------------------

SHARD_T = 20000  # frames a rank: tiled scans, no feedback line's D divides it


def _card_gather_rank(mesh):
    whole = gather(torch.full((3, 2), float(mesh.rank), device=mesh.device),
                   mesh)
    return {"device": str(mesh.device),
            "gathered": None if whole is None else whole.cpu().numpy()}


def test_sharded_scans_on_two_ranks_sharing_the_card(cuda):
    """tools/shard_render.scan_check on 2 ranks (gloo on cuda:0 with one
    card): the sharded one-pole scan (slow poles to a = 0.9999), max-decay,
    both eq3 biquad cascades (complex scans) and c4's 21 feedback lines
    with CUDA tensors, against the plain scans over the whole input (the
    one-pole's in float64): within 1e-5 of max |y| (the cascade 1e-4,
    tests/subproc/sharded_biquad_check.py:31), final states equal on both
    ranks and within 1e-4 (the cascade 1e-3), every sharded scan launching
    its kernel twice on each rank (the summary, then the seeded scan); it
    raises otherwise. `gather` brings both ranks' CUDA tensors over gloo
    to rank 0 alone."""
    from termdaw_tpu_torch.parallel import launch

    rep = shard_render.scan_check(2, frames=(SHARD_T,))
    got = rep["by_frames"][str(SHARD_T)]
    assert got["feedback_offsets_min_max"][0] > 0
    assert all(r == rep["launches_a_rank"] for r in got["launches_by_rank"])
    assert rep["launches_a_rank"] == {"affine_scan": 44, "max_decay_scan": 2,
                                      "complex_affine_scan": 8}
    ranks = launch(_card_gather_rank, 2, backend="gloo", device="cuda",
                   share_device=True, timeout_s=300)
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:0"]
    np.testing.assert_array_equal(
        ranks[0]["gathered"], np.repeat([0.0, 1.0], 6).reshape(2, 3, 2))
    assert ranks[1]["gathered"] is None


# -- sharded windows from captured graphs: a 1-rank NCCL world -----------


def test_sharded_windows_replay_with_nccl_inside_on_card(cuda, tmp_path):
    """c4's windows through render_window_sharded in a 1-rank NCCL world
    (tools/shard_render.replay_check; NCCL refuses two ranks on one
    card): two States in lockstep, one through the program cache and one
    eager, give bit-identical audio and numeric state; every window of
    the cached one replays a captured program that holds its collectives
    (as many as the eager program issues a window, added to the mesh's
    count by each replay) and launches all six c4 kernels; it raises
    otherwise."""
    if not torch.distributed.is_nccl_available():
        pytest.skip("needs torch.distributed's NCCL backend")
    _SMALL["c4"](tmp_path)
    windows = (32, 16, 15)  # c4's 63 blocks
    r = shard_render.replay_check(
        [("c4", str(tmp_path), b"")], windows=windows, reps=1,
        need={"c4": ("voice_mix", "affine_scan", "max_decay_scan",
                     "complex_scan", "sampsyn", "synth")})["c4"]
    assert r["audio_bit_identical"] and r["state_bit_identical"]
    assert sorted(p["nb_total"] for p in r["programs"]) == [15, 16, 32]
    assert all(p["captured"] and p["collectives"] > 0 and p["ranks"] == 1
               for p in r["programs"])
    assert r["replays"] == r["sharded_windows"] == 3 * len(windows)
    assert r["pool_mb"] > 0
