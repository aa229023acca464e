"""Adsr *effect* vertex: envelope applied to the summed input, floww-driven.

Port of termdaw_tpu/ops/envelope.py (reference extensions.rs:592-651).
Two modes:

* drum mode (use_off=false): every qualifying hit shifts primary->ghost and
  retriggers; both cells evaluate apply_adsr on their own clock
  (extensions.rs:631-647);
* use_off mode: held notes evaluate apply_ads; note-offs put first the
  ghost then the primary cell into release (apply_r from a captured value)
  (extensions.rs:603-629).

The host bakes the event state machine into per-segment cells with the
reference's accumulated f32 per-block clocks (graph/bake.py:
bake_adsr_drum / bake_adsr_off). Per frame, searchsorted picks the
segment, the [nb, S] clock table gives the cell clock at the block start,
and the in-block offset f32(i)/f32(sr) (`ib`, from the host time table)
is added as the reference adds it (extensions.rs:604, 638). use_max picks
max vs min of the two cells; wet lerps the gain against 1.0
(extensions.rs:625, 643); wet < 1e-4 skips entirely (extensions.rs:598).
"""

from __future__ import annotations

import torch

from .adsr import AdsrConf, apply_ads, apply_adsr, apply_r


def adsr_apply(
    x: torch.Tensor,               # [T, 2] summed input
    bake: dict[str, torch.Tensor],
    frames: torch.Tensor,          # [T] int64 absolute frames
    conf: AdsrConf,
    use_off: bool,
    use_max: bool,
    wet: torch.Tensor,             # 0-d f32
    ib: torch.Tensor,              # [bl] f32(i)/f32(sr)
) -> torch.Tensor:
    nb = bake["p_t0"].shape[0]
    bl = frames.shape[0] // nb
    seg = torch.searchsorted(
        bake["bounds"].long(), frames, right=True
    ).reshape(nb, bl)
    ibr = ib[None, :]

    def cell(prefix: str) -> torch.Tensor:
        clock = torch.gather(bake[f"{prefix}_t0"], 1, seg) + ibr
        velv = bake[f"{prefix}_vel"][seg]
        relv = bake[f"{prefix}_rel"][seg]
        if use_off:
            v = torch.where(relv == 0.0, apply_ads(conf, clock),
                            apply_r(conf, clock, relv))
        else:
            v = apply_adsr(conf, clock)
        return (v * velv).reshape(-1)

    pvel = cell("p")
    gvel = cell("g")
    maxmul = 1.0 if use_max else 0.0
    adsr_vel = (torch.maximum(pvel, gvel) * maxmul
                + torch.minimum(pvel, gvel) * (1.0 - maxmul))
    vel = 1.0 + wet * (adsr_vel - 1.0)  # lerp(1, adsr_vel, wet)
    return torch.where(wet < 0.0001, x, x * vel[:, None])
