"""The port on a CUDA card: the voice-mix and affine-scan kernels against
their plain versions, small renders and playback on the card against the
port's CPU path. This file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Without a card every test skips."""

import numpy as np
import pytest
import torch

from termdaw_tpu.engine.sink import Sink

from termdaw_tpu_torch.engine.player import Player
from termdaw_tpu_torch.ops import scan, voices
from termdaw_tpu_torch.utils.fixtures import (
    load_state, read_wav_ints, write_c2_project, write_c3_project,
    write_c5_project,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_kernel_matches_plain_on_card(cuda):
    """Bit-exact: the kernel and the plain version both round the multiply
    and the add separately, in slot order."""
    rng = np.random.default_rng(5)
    nb, bl, P, L = 37, 1024, 16, 3840
    padded = torch.from_numpy(
        rng.normal(size=(2, 2 * (2 * bl + L + 256))).astype(np.float32)
    ).to(cuda)
    begins = torch.from_numpy(
        rng.integers(0, padded.shape[1] - bl, (nb, P)).astype(np.int32)
    ).to(cuda)
    al, ar = (torch.from_numpy(rng.uniform(-1, 1, (nb, P)).astype(np.float32))
              .to(cuda) for _ in range(2))
    n0 = voices.launches
    got = voices.voice_mix_stereo(padded, begins, al, ar, nb, bl)
    torch.cuda.synchronize()
    assert voices.launches == n0 + 1
    want = voices.voice_mix_stereo_plain(padded, begins, al, ar, nb, bl)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bl", [100, 256, 1000])
def test_kernel_ragged_block_lengths(cuda, bl):
    """Block lengths that are not a multiple of the kernel's frame tile."""
    rng = np.random.default_rng(bl)
    nb, P, L = 5, 7, 300
    padded = torch.from_numpy(
        rng.normal(size=(2, 2 * bl + L + 256)).astype(np.float32)
    ).to(cuda)
    begins = torch.from_numpy(
        rng.integers(0, L + bl + 1, (nb, P)).astype(np.int32)
    ).to(cuda)
    al, ar = (torch.from_numpy(rng.uniform(-1, 1, (nb, P)).astype(np.float32))
              .to(cuda) for _ in range(2))
    got = voices.voice_mix_stereo(padded, begins, al, ar, nb, bl)
    want = voices.voice_mix_stereo_plain(padded, begins, al, ar, nb, bl)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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
    """The kernel runs the recurrence sequentially within chunks, the
    plain version as a two-level log-step scan: both are held to a
    float64 recurrence at 1e-4 (the reference's bound) and to each other
    at 1e-5, relative to the largest |y|."""
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
