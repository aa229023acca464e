"""Mixing primitives: input summation, constant-power pan, gain, normalize.

Port of termdaw_tpu/ops/mix.py (same arithmetic in the same order):

* sum_inputs accumulates inputs in connect order (extensions.rs:310-319);
* apply_angle is a constant-power pan, angle in degrees, +90 = full left,
  skipped when |angle| < 0.001 (sample.rs:97-106);
* apply_gain is skipped when |gain - 1| < 0.001 (sample.rs:108-114);
* post-op order is ext -> angle -> gain (extensions.rs:262-263);
* Normalize scales by the running causal peak; the per-block running max
  is `torch.cummax` over block maxima (extensions.rs:321-329).

Gain and angle are 0-dim float32 tensors on the render device, so the
skip thresholds are `torch.where` selects and need no host sync.

Under timeline sharding (a `mesh`, parallel/mesh.py; the reference's
`axis_name`, mix.py:82-125) each rank holds its own block range: the live
Normalize gathers every rank's block maxima (one float a block) and runs
the same prefix max on each rank, which scales its own blocks; the scan
pass takes the window peak with `pmax`. Both are exact.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import Mesh, all_gather, pmax

DEG_TO_RAD_HALF = 0.5 * 0.01745329  # reference sample.rs:99 constant
_FRAC = 0.7071067811865476


def sum_inputs(ins: list[torch.Tensor]) -> torch.Tensor:
    """Sum [.., 2] inputs sequentially in connect order."""
    acc = ins[0]
    for x in ins[1:]:
        acc = acc + x
    return acc


def _pan_amps(angle: torch.Tensor) -> torch.Tensor:
    rad = angle * DEG_TO_RAD_HALF
    c, s = torch.cos(rad), torch.sin(rad)
    return torch.stack([_FRAC * (c + s), _FRAC * (c - s)], dim=-1)


def apply_angle(x: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Constant-power pan. x is [..., 2]; angle a 0-dim f32 tensor."""
    skip = torch.abs(angle) < 0.001
    return torch.where(skip, x, x * _pan_amps(angle))


def apply_gain(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    skip = torch.abs(gain - 1.0) < 0.001
    return torch.where(skip, x, x * gain)


def post(x: torch.Tensor, angle: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """ext -> angle -> gain (reference extensions.rs:262-263)."""
    return apply_gain(apply_angle(x, angle), gain)


def post_amps(angle: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """The per-channel linear factor [..., 2] equivalent to `post`, for
    angle/gain tensors of any (equal) shape — one call folds every member
    of a fused SampleMulti group. Reproduces the skip thresholds."""
    amps = torch.where(
        (torch.abs(angle) < 0.001)[..., None],
        torch.ones((), dtype=torch.float32, device=angle.device),
        _pan_amps(angle),
    )
    g = torch.where(
        torch.abs(gain - 1.0) < 0.001,
        torch.ones((), dtype=torch.float32, device=gain.device),
        gain,
    )
    return amps * g[..., None]


def block_maxima(x: torch.Tensor) -> torch.Tensor:
    """Per-block |peak| over [nb, bl, 2] -> [nb]."""
    return torch.amax(torch.abs(x), dim=(1, 2))


def normalize_live(
    x: torch.Tensor, max_in: torch.Tensor, mesh: Mesh | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normal-render Normalize: block k is scaled by
    1 / max(max_in, cummax(block_maxima)[0..k]), k counted over the whole
    window under a mesh. Returns (scaled [nb, bl, 2], max_out 0-dim,
    equal on every rank)."""
    bm = block_maxima(x)
    if mesh is not None:
        nb = bm.shape[0]
        running = torch.cummax(all_gather(bm, mesh).reshape(-1), dim=0).values
        running = torch.maximum(running, max_in)
        mine = running[mesh.rank * nb:(mesh.rank + 1) * nb]
        return x / mine[:, None, None], running[-1]
    running = torch.cummax(bm, dim=0).values
    running = torch.maximum(running, max_in)
    return x / running[:, None, None], running[-1]


def normalize_scan(
    x: torch.Tensor, max_in: torch.Tensor, scan_max_in: torch.Tensor,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan-pass Normalize: record the window peak (over every rank under
    a mesh) into scan_max while scaling by the frozen current max
    (extensions.rs:321-329 is_scan arm). Returns (scaled, scan_max_out)."""
    peak = torch.amax(block_maxima(x))
    if mesh is not None:
        peak = pmax(peak, mesh)
    return x / max_in, torch.maximum(peak, scan_max_in)
