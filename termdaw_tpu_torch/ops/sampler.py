"""Sample-playback window kernels: SampleLoop, SampleLerp, SampleMulti.

Port of termdaw_tpu/ops/sampler.py. The window start is a host int where
a function takes `t0`, so slice offsets need no device sync. SampleMulti
renders through ops/voices.py on the render path; `sample_multi` here is
the reference's plain masked gather, kept as a second oracle.
"""

from __future__ import annotations

import torch


def sample_loop(sample: torch.Tensor, t0: int, T: int) -> torch.Tensor:
    """Loop the bank sample with modulo indexing (extensions.rs:331-341):
    sample [L, 2] -> frames t0 .. t0+T-1 as [T, 2]. Gather-free, as in the
    reference: tile the sample to cover T+L frames and slice at t0 mod L."""
    L = sample.shape[0]
    reps = -(-(T + L) // L)
    start = t0 % L
    return sample.repeat(reps, 1)[start:start + T]


def sample_multi(
    sample: torch.Tensor,            # [L, 2]
    bake: dict[str, torch.Tensor],   # idx [nb, P], starts/vels [N]
    frames: torch.Tensor,            # [nb*bl] int64
    nb: int,
    bl: int,
) -> torch.Tensor:
    """Polyphonic one-shot voices (extensions.rs:343-381): every active
    voice p in block k adds sample[t - start_p] * vel_p; finished and
    empty (idx -1) slots are masked out. -> [nb*bl, 2]."""
    L = sample.shape[0]
    idx = bake["idx"].long()
    starts = bake["starts"][idx]     # -1 wraps to the last row, as in jnp
    vels = bake["vels"][idx]
    pos = frames.reshape(nb, bl)[:, :, None] - starts[:, None, :]
    mask = (idx >= 0)[:, None, :] & (pos >= 0) & (pos < L)
    smp = sample[torch.clamp(pos, 0, L - 1)]            # [nb, bl, P, 2]
    w = torch.where(mask, vels[:, None, :], 0.0)
    return torch.sum(smp * w[..., None], dim=2).reshape(-1, 2)


def sample_lerp(
    sample: torch.Tensor,            # [L, C]
    bake: dict[str, torch.Tensor],
    frames: torch.Tensor,            # [T] int64, contiguous from t0
    lerp_len: int,
) -> torch.Tensor:
    """Monophonic retrigger with a linear crossfade between the previous
    (ghost) and current (primary) voice (extensions.rs:383-421). Positions
    clamp at the sample ends (the last frame holds). The countdown starts
    at lerp_len on each trigger and decrements before use, so d frames
    after a trigger the ghost weight is (lerp_len-1-d)/lerp_len while
    d < lerp_len.

    The reference loops over the padded segments and masks each to
    [bounds[s-1], bounds[s]), reading each voice as a slice of the sample
    extended by T held frames at both ends. The bake's trigger frames
    (`bounds`, INF_FRAME-padded) increase strictly, so every frame lies in
    exactly one segment, s = searchsorted(bounds, t, right): here each
    frame gathers its own segment's row, and reads
    sample[clamp(t - start, 0, L-1)], which is the extended slice's value
    for every start."""
    L = sample.shape[0]
    seg = torch.searchsorted(bake["bounds"].long(), frames, right=True)

    def voice(prefix: str) -> torch.Tensor:
        start = bake[f"{prefix}_starts"][seg]
        pos = torch.clamp(frames - start, 0, L - 1)
        return sample[pos] * bake[f"{prefix}_vels"][seg][:, None]

    p = voice("p")
    g = voice("g")
    cd = bake["cd_init"][seg] - (frames - bake["cd_anchor"][seg])
    tc = torch.clamp((cd - 1).to(torch.float32) / float(max(lerp_len, 1)),
                     0.0, 1.0)[:, None]
    blend = g * tc + p * (1.0 - tc)
    return torch.where((cd > 0)[:, None], blend, p)
