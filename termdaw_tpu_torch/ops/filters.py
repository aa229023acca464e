"""Band-pass / band-cut filter: paired 1-pole low+high IIRs.

Port of the single-device part of termdaw_tpu/ops/filters.py
(`gamma_from_cutoff`, `BandPassState`, `band_pass_timeline` with
`axis_name=None`). Reference semantics (extensions.rs:70-79, 173-194,
653-689):

* gamma = 1 - e^(-2*pi*fc/sr), cutoffs clamped to [0, 20kHz];
* per frame: lp = lprev + lgamma*(x - lprev) (1-pole LP), hp likewise;
  cut = (lmul*lp + hmul*(x - hp)) * 0.5; pass = x - cut; the output is
  selected by the pass/cut mode;
* first-sample priming: the filter states start at the first input
  sample (extensions.rs:664-670);
* skip (output = summed input, state untouched) when wet < 1e-4 or both
  gammas are 0 (extensions.rs:657-658); `wet` is an on/off gate here.

Documented deviation kept from the reference: the right pass channel uses
the right cut value (`passr = r - cutr`); the reference's code uses the
left one (`passr = r - cutl`, extensions.rs:685), a bug.

The four lanes (low/high x L/R) run as one first-order affine recurrence
y = (1-g)*y_prev + g*x through ops/scan.affine_scan (the hand-written
CUDA kernel on the card). The biquads and the timeline-sharding helpers
come with the effects.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .scan import affine_scan


def gamma_from_cutoff(cut_hz: float, sr: int) -> float:
    """Reference extensions.rs:173-194."""
    fc = min(max(cut_hz, 0.0), 20000.0)
    return 1.0 - math.exp(-2.0 * math.pi * fc / sr)


class BandPassState(NamedTuple):
    prevs: torch.Tensor  # [4] f32 = (low-L, low-R, high-L, high-R)
    first: torch.Tensor  # bool scalar: prime from the next input

    @staticmethod
    def init(device: torch.device) -> "BandPassState":
        return BandPassState(
            prevs=torch.zeros(4, dtype=torch.float32, device=device),
            first=torch.ones((), dtype=torch.bool, device=device),
        )


def band_pass_timeline(
    x: torch.Tensor,           # [F, 2]
    state: BandPassState,
    lgamma: float,
    hgamma: float,
    pass_mode: bool,
    wet: torch.Tensor,         # 0-d f32
) -> tuple[torch.Tensor, BandPassState]:
    """Filter a [F, 2] window. Returns (out, new_state)."""
    g32 = np.asarray([lgamma, lgamma, hgamma, hgamma], np.float32)
    lmul = 0.0 if g32[0] == 0.0 else 1.0
    hmul = 0.0 if g32[2] == 0.0 else 1.0
    skip = wet < 0.0001
    if lmul == 0.0 and hmul == 0.0:
        skip = torch.ones_like(skip)
    pass_mul = 1.0 if pass_mode else 0.0

    y0 = torch.where(state.first, x[0].repeat(2), state.prevs)  # [4]
    g = torch.from_numpy(g32).to(x.device)
    b = g * torch.cat([x, x], dim=1)  # [F, 4] lanes lL lR hL hR
    y = affine_scan(b, 1.0 - g, y0)

    lp = y[:, 0:2]
    hp = y[:, 2:4]
    cut = (lmul * lp + hmul * (x - hp)) * 0.5
    pas = x - cut
    out = cut * (1.0 - pass_mul) + pas * pass_mul
    out = torch.where(skip, x, out)
    new_state = BandPassState(
        prevs=torch.where(skip, state.prevs, y[-1]),
        first=torch.logical_and(skip, state.first),
    )
    return out, new_state
