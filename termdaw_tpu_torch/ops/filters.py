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
CUDA kernel on the card).

The effects' building blocks, single device (the `axis_name` branches,
`exclusive_total` and the sharded halo are not ported):

* `first_order_scan` (filters.py:158-175): a one-pole IIR through
  ops/scan.affine_scan, returning the window and its last value;
* `prev_frames` (filters.py:178-203): the halo of the previous M frames;
* `biquad_coefs`, `biquad_init_state`, `biquad_apply` (filters.py:357-534):
  the direct-form-1 biquad as a cascade of two first-order complex
  recurrences through its poles, each one ops/scan.complex_affine_scan
  (the hand-written CUDA kernel on the card).

The reference's exact sequential biquad lane (`biquad_apply_sequential`,
selected by TERMDAW_EXACT_BIQUAD=1) is not ported: a graph with a biquad
effect refuses to build while that variable is set
(graph/compile.py), and `biquad_apply` never substitutes the parallel
lane for it.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .scan import affine_scan, complex_affine_scan


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


# ---------------------------------------------------------------------------
# the effects' building blocks (single device)
# ---------------------------------------------------------------------------

def lanes(v, C: int, device: torch.device) -> torch.Tensor:
    """A scalar (Python float or 0-d / [1] f32 tensor) or a [C] tensor as a
    contiguous f32 [C] tensor, the per-lane form the scans take."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).expand(C).contiguous()
    return torch.full((C,), float(v), dtype=torch.float32, device=device)


def first_order_scan(x: torch.Tensor, a, y0: torch.Tensor):
    """One-pole IIR y[i] = a*y[i-1] + x[i] over x [T, C] with y[-1] = y0
    [C]; `a` is a scalar or [C]. Returns (y [T, C], y[-1])."""
    y = affine_scan(x.contiguous(), lanes(a, x.shape[1], x.device),
                    y0.contiguous())
    return y, y[-1]


def prev_frames(x: torch.Tensor, tail: torch.Tensor):
    """The M = tail.shape[0] frames before x (the carried tail) and the new
    last-M tail of the stream, concat(tail, x)[T:T+M], which reaches back
    into the old tail when T < M."""
    T = x.shape[0]
    xcat = torch.cat([tail, x])
    return tail, xcat[T:T + tail.shape[0]]


def biquad_coefs(kind: str, fc: float, sr: int,
                 q: float = 0.7071067811865476):
    """RBJ cookbook lowpass/highpass coefficients (b0,b1,b2,a1,a2),
    normalized a0=1. Host-side floats."""
    w0 = 2.0 * math.pi * fc / sr
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    a0 = 1.0 + alpha
    if kind == "lowpass":
        b0 = (1.0 - cw) / 2.0
        b1 = 1.0 - cw
        b2 = b0
    elif kind == "highpass":
        b0 = (1.0 + cw) / 2.0
        b1 = -(1.0 + cw)
        b2 = b0
    else:
        raise ValueError(kind)
    a1 = -2.0 * cw
    a2 = 1.0 - alpha
    return (b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def biquad_init_state(channels: int, device: torch.device) -> torch.Tensor:
    """[4, C]: (x[n-1], x[n-2], y[n-1], y[n-2])."""
    return torch.zeros((4, channels), dtype=torch.float32, device=device)


def exact_biquad_env() -> bool:
    """TERMDAW_EXACT_BIQUAD=1 asks for the reference's sequential biquad
    lane, which the port does not have (graph/compile.py reads this once
    at build and refuses a graph that runs a biquad)."""
    return os.environ.get("TERMDAW_EXACT_BIQUAD", "0") == "1"


def biquad_apply(x: torch.Tensor, coefs: tuple, state: torch.Tensor):
    """Direct-form-1 biquad over a window x [T, C]; exact cross-window
    state [4, C]. `coefs` = (b0, b1, b2, a1, a2), each an f32 tensor [C]
    (or 0-d) on x's device: per-channel coefficients let independent
    filter branches run batched (the eq3 runs its LR4 tree as 4 stages of
    a 4-channel biquad).

    The feed-forward part f = b0*x + b1*x[n-1] + b2*x[n-2] is elementwise;
    the feedback y[n] = f[n] - a1*y[n-1] - a2*y[n-2] is factored through
    the section's poles p1, p2 (roots of z^2 + a1 z + a2, computed in f32
    per channel, real or a conjugate pair) into a cascade of two
    first-order complex recurrences,

        u[n] = p1*u[n-1] + f[n],    y[n] = p2*y[n-1] + u[n],

    each one complex_affine_scan (filters.py:444-534, single device)."""
    T, C = x.shape
    b0, b1, b2, a1, a2 = coefs
    x1 = torch.cat([state[0:1], x[:-1]])
    x2 = torch.cat([state[1:2], x1[:-1]]) if T > 1 else \
        state[1:2].expand(T, C)
    new_x1, new_x2 = x[-1], (x1[-1] if T > 1 else state[0])
    f = b0 * x + b1 * x1 + b2 * x2  # [T, C]

    disc = a1 * a1 - 4.0 * a2
    sq = torch.sqrt(torch.abs(disc))
    is_real = disc >= 0.0
    p1r = torch.where(is_real, (-a1 + sq) * 0.5, -a1 * 0.5)
    p1i = torch.where(is_real, 0.0, sq * 0.5)
    p2r = torch.where(is_real, (-a1 - sq) * 0.5, -a1 * 0.5)
    p2i = -p1i
    p1r, p1i, p2r, p2i = (lanes(p, C, x.device)
                          for p in (p1r, p1i, p2r, p2i))

    y1, y2 = state[2], state[3]  # y[n-1], y[n-2], each [C]
    # u[-1] = y[-1] - p2*y[-2] (from y[n] = p2*y[n-1] + u[n])
    u0r = y1 - p2r * y2
    u0i = -p2i * y2
    u_r, u_i = complex_affine_scan(f, torch.zeros_like(f), p1r, p1i, u0r,
                                   u0i)
    y_r, _ = complex_affine_scan(u_r, u_i, p2r, p2i, y1.contiguous(),
                                 torch.zeros_like(y1))
    # y is real by construction; the imaginary lane carries only rounding
    new_y2 = y_r[-2] if T > 1 else state[2]
    new_state = torch.stack([new_x1, new_x2, y_r[-1], new_y2])
    return y_r, new_state
