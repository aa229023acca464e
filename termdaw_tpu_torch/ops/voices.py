"""Polyphonic voice mixing: SampleMulti's hot loop.

Port of termdaw_tpu/ops/pallas_voices.py. Each voice's reads within one
block are a contiguous slice of a zero-padded, channel-major sample, so a
block of the mix is

    out[k*bl + i, c] = sum_{p < P} amp_c[k, p] * padded[c, begins[k, p] + i]

accumulated in slot order as `out + window * amp`; empty slots carry
amp 0 and an in-bounds begin. On CUDA tensors `voice_mix_stereo` runs the
hand-written kernel (csrc/voice_mix.cu) or raises; on CPU tensors it runs
`voice_mix_stereo_plain`, the same arithmetic in PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.roofline import counted

# launches of the CUDA kernel by voice_mix_stereo (CPU calls do not count)
launches = 0


def make_padded_sample(sample: torch.Tensor, bl: int) -> torch.Tensor:
    """[L, 2] -> channel-major zero-padded [2, bl + L + bl + 256].

    Left pad bl (voices triggered mid-block read "before" the sample);
    right pad bl + 256, the reference's layout (its aligned DMA window of
    the largest begin, L + bl, stays in bounds)."""
    return F.pad(sample.t(), (bl, bl + 256)).contiguous()


def make_padded_pool(samples: list[torch.Tensor],
                     bl: int) -> tuple[torch.Tensor, list[int]]:
    """[L_i, 2] samples -> (one [2, sum of padded lengths] buffer, each
    sample's first column in it): the torch.cat of their
    make_padded_sample buffers, written in place without them."""
    lens = [2 * bl + int(s.shape[0]) + 256 for s in samples]
    bases = [0]
    for n in lens[:-1]:
        bases.append(bases[-1] + n)
    pool = torch.zeros((2, sum(lens)), dtype=samples[0].dtype,
                       device=samples[0].device)
    for s, b in zip(samples, bases):
        pool[:, b + bl:b + bl + s.shape[0]] = s.t()
    return pool, bases


def compute_begin_vel(
    bake: dict, t0: int, nb: int, bl: int, sample_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block (begin, vel) tables [nb, P] from a SampleMulti bake.

    begin = (block_start - voice_start) + bl in padded coordinates,
    clamped to [0, sample_len + bl]; empty slots (idx -1) get vel 0. int32
    arithmetic throughout, as in the reference (pallas_voices.py:189)."""
    idx = bake["idx"].long()  # [nb, P]; -1 wraps to the last row, as in jnp
    starts = bake["starts"][idx]
    vels = torch.where(idx >= 0, bake["vels"][idx], 0.0)
    block_starts = t0 + torch.arange(
        nb, dtype=torch.int32, device=idx.device
    ) * bl
    off = block_starts[:, None] - starts
    begins = torch.clamp(off + bl, 0, sample_len + bl)
    return begins.to(torch.int32), vels.to(torch.float32)


def voice_mix_stereo_plain(
    sample_padded: torch.Tensor, begins: torch.Tensor,
    amp_l: torch.Tensor, amp_r: torch.Tensor, nb: int, bl: int,
) -> torch.Tensor:
    """Plain PyTorch voice mix -> [nb*bl, 2]: one slice gather per slot,
    accumulated in slot order with a separate multiply and add."""
    frame = torch.arange(bl, device=begins.device)
    amps = torch.stack([amp_l, amp_r])  # [2, nb, P]
    out = torch.zeros((2, nb, bl), dtype=torch.float32, device=begins.device)
    for p in range(begins.shape[1]):
        window = sample_padded[:, begins[:, p, None].long() + frame]
        out = out + window * amps[:, :, p, None]
    return out.permute(1, 2, 0).reshape(nb * bl, 2)


def _check(sample_padded, begins, amp_l, amp_r, nb, bl) -> None:
    dev = sample_padded.device
    for name, t, dtype in (
        ("sample_padded", sample_padded, torch.float32),
        ("begins", begins, torch.int32),
        ("amp_l", amp_l, torch.float32),
        ("amp_r", amp_r, torch.float32),
    ):
        if t.device != dev:
            raise ValueError(f"voice_mix_stereo: {name} on {t.device}, "
                             f"sample_padded on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"voice_mix_stereo: {name} is {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"voice_mix_stereo: {name} is not contiguous")
    if sample_padded.dim() != 2 or sample_padded.shape[0] != 2:
        raise ValueError("voice_mix_stereo: sample_padded must be [2, Lpad], "
                         f"got {tuple(sample_padded.shape)}")
    if begins.dim() != 2 or begins.shape[0] != nb:
        raise ValueError(f"voice_mix_stereo: begins must be [{nb}, P], "
                         f"got {tuple(begins.shape)}")
    if amp_l.shape != begins.shape or amp_r.shape != begins.shape:
        raise ValueError("voice_mix_stereo: amp_l/amp_r must match begins' "
                         f"shape {tuple(begins.shape)}")
    if bl <= 0 or sample_padded.shape[1] < max(bl, 256):
        raise ValueError(f"voice_mix_stereo: bad block length {bl} for a "
                         f"padded sample of {sample_padded.shape[1]} frames "
                         "(at least max(bl, 256): make_padded_sample's "
                         "layout has 2 * bl + L + 256)")


def voice_mix_stereo_work(sample_padded: torch.Tensor, begins: torch.Tensor,
                          amp_l: torch.Tensor, amp_r: torch.Tensor, nb: int,
                          bl: int) -> tuple[float, float]:
    """(flops, bytes) of one voice_mix_stereo: a multiply-add a slot a
    frame a channel; its inputs read once, the [nb*bl, 2] mix written
    once."""
    P = begins.shape[1]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (sample_padded, begins, amp_l, amp_r))
    return 2.0 * nb * P * bl * 2, nbytes + nb * bl * 2 * 4


@counted(voice_mix_stereo_work)
def voice_mix_stereo(
    sample_padded: torch.Tensor,  # [2, Lpad] f32 (see make_padded_sample)
    begins: torch.Tensor,         # [nb, P] int32, in bounds
    amp_l: torch.Tensor,          # [nb, P] f32 left amp (0 = empty slot)
    amp_r: torch.Tensor,          # [nb, P] f32 right amp
    nb: int,
    bl: int,
) -> torch.Tensor:
    """Mixed voices [nb*bl, 2] with per-voice per-channel amps (a whole
    fused group of SampleMulti vertices in one call). CUDA tensors run
    the hand-written kernel; CPU tensors the plain version."""
    global launches
    _check(sample_padded, begins, amp_l, amp_r, nb, bl)
    dev = sample_padded.device
    if dev.type == "cpu":
        return voice_mix_stereo_plain(
            sample_padded, begins, amp_l, amp_r, nb, bl
        )
    if dev.type != "cuda":
        raise ValueError(f"voice_mix_stereo: unsupported device {dev}")
    from ..kernels import voice_mix_launch

    out = torch.empty((nb * bl, 2), dtype=torch.float32, device=dev)
    voice_mix_launch(sample_padded, begins, amp_l, amp_r, out, nb, bl)
    launches += 1
    return out
