"""Band-pass / band-cut filter: paired 1-pole low+high IIRs.

Port of termdaw_tpu/ops/filters.py (`gamma_from_cutoff`, `BandPassState`,
`band_pass_timeline`). Reference semantics (extensions.rs:70-79, 173-194,
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

The effects' building blocks:

* `first_order_scan` (filters.py:158-175): a one-pole IIR through
  ops/scan.affine_scan, returning the window and its last value;
* `prev_frames` (filters.py:178-203): the halo of the previous M frames;
* `biquad_coefs`, `biquad_init_state`, `biquad_apply` (filters.py:357-534):
  the direct-form-1 biquad as a cascade of two first-order complex
  recurrences through its poles, each one ops/scan.complex_affine_scan
  (the hand-written CUDA kernel on the card);
* the exact sequential lane (filters.py:384-441): `biquad_apply_sequential`
  runs the recurrence frame by frame in the reference's order, each
  multiply and add rounded on its own; `biquad_apply` takes it instead of
  the parallel lane when `exact_biquad_scope` pins it (graph/compile.py
  pins the value it read from TERMDAW_EXACT_BIQUAD at build) or, with no
  pin, when the variable says so. On CUDA tensors it launches the
  hand-written kernel csrc/biquad_seq.cu (counter `biquad_seq_launches`)
  or raises; on CPU tensors it runs `biquad_seq_plain`, a per-frame
  float32 numpy loop. The two are bit-identical.

Under timeline sharding (a `mesh`, parallel/mesh.py; the reference's
`axis_name`) the window is each rank's block range of one global stream:

* `exclusive_total` (filters.py:128-155) gathers each rank's fold of a
  monoid scan and returns the fold of the earlier ranks (`pre`, which
  seeds this rank's scan) and of all of them (`tot`, the next window's
  carried state, equal on every rank); the folds come from
  ops/scan.*_summary and compose in float64;
* `first_order_scan`, `band_pass_timeline` (the global first frame from
  rank 0) and `_first_order_complex` take their seeds from it;
* `prev_frames` gathers the last M frames of every rank when T >= M, or
  the whole slices when T < M;
* `biquad_apply` reads its 2-frame halo from `prev_frames` and recovers
  the global y[T-2] by the clamped complex division of the reference; it
  takes the parallel cascade even where the exact lane is pinned
  (filters.py:479), so the exact lane never runs sharded.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.mesh import Mesh, all_gather
from .scan import (
    _affine, _caffine, affine_scan, affine_summary, complex_affine_scan,
    complex_summary,
)


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
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, BandPassState]:
    """Filter a [F, 2] window (this rank's slice under a mesh, primed from
    the global first frame, rank 0's). Returns (out, new_state); the state
    is the global stream's, equal on every rank."""
    g32 = np.asarray([lgamma, lgamma, hgamma, hgamma], np.float32)
    lmul = 0.0 if g32[0] == 0.0 else 1.0
    hmul = 0.0 if g32[2] == 0.0 else 1.0
    skip = wet < 0.0001
    if lmul == 0.0 and hmul == 0.0:
        skip = torch.ones_like(skip)
    pass_mul = 1.0 if pass_mode else 0.0

    x_first = x[0] if mesh is None else all_gather(x[0], mesh)[0]
    y0 = torch.where(state.first, x_first.repeat(2), state.prevs)  # [4]
    g = torch.from_numpy(g32).to(x.device)
    b = g * torch.cat([x, x], dim=1)  # [F, 4] lanes lL lR hL hR
    if mesh is None:
        y = affine_scan(b, 1.0 - g, y0)
        final = y[-1]
    else:
        y, final = _affine_sharded(b, 1.0 - g, y0, mesh)

    lp = y[:, 0:2]
    hp = y[:, 2:4]
    cut = (lmul * lp + hmul * (x - hp)) * 0.5
    pas = x - cut
    out = cut * (1.0 - pass_mul) + pas * pass_mul
    out = torch.where(skip, x, out)
    new_state = BandPassState(
        prevs=torch.where(skip, state.prevs, final),
        first=torch.logical_and(skip, state.first),
    )
    return out, new_state


# ---------------------------------------------------------------------------
# cross-rank boundary composition (timeline sharding)
# ---------------------------------------------------------------------------

def exclusive_total(combine, identity: tuple, summary: tuple, mesh: Mesh):
    """For a monoid scan sharded over the ranks: given this rank's fold
    `summary` (a tuple of equally shaped tensors), return (pre, tot):
    `pre` the fold of every earlier rank's summary (the identity on rank
    0), `tot` the fold of all of them, equal on every rank. Applied to the
    carried global seed, `pre` seeds this rank's scan and `tot` is the
    next window's state. One all_gather of the summaries; the folds run in
    float64 in rank order."""
    g = all_gather(torch.stack([s.double() for s in summary]), mesh)
    tot = tuple(torch.full_like(g[0, k], ident)
                for k, ident in enumerate(identity))
    pre = tot
    for j in range(mesh.size):
        tot = combine(tot, tuple(g[j, k] for k in range(len(identity))))
        if j == mesh.rank - 1:
            pre = tot
    return pre, tot


def _affine_sharded(b: torch.Tensor, a: torch.Tensor, y0: torch.Tensor,
                    mesh: Mesh):
    """y = a*y_prev + b over this rank's rows b [T, C] of the global stream
    whose y[-1] = y0 [C]: (y [T, C], the global stream's last y [C])."""
    (a_pre, b_pre), (a_tot, b_tot) = exclusive_total(
        _affine, (1.0, 0.0), affine_summary(b, a), mesh)
    y0d = y0.double()
    y = affine_scan(b, a, (a_pre * y0d + b_pre).float())
    return y, (a_tot * y0d + b_tot).float()


# ---------------------------------------------------------------------------
# the effects' building blocks
# ---------------------------------------------------------------------------

def lanes(v, C: int, device: torch.device) -> torch.Tensor:
    """A scalar (Python float or 0-d / [1] f32 tensor) or a [C] tensor as a
    contiguous f32 [C] tensor, the per-lane form the scans take."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).expand(C).contiguous()
    return torch.full((C,), float(v), dtype=torch.float32, device=device)


def first_order_scan(x: torch.Tensor, a, y0: torch.Tensor,
                     mesh: Mesh | None = None):
    """One-pole IIR y[i] = a*y[i-1] + x[i] over x [T, C] with y[-1] = y0
    [C]; `a` is a scalar or [C]. Returns (y [T, C], the last y), the last
    y of the global stream under a mesh."""
    a = lanes(a, x.shape[1], x.device)
    if mesh is not None:
        return _affine_sharded(x.contiguous(), a, y0.contiguous(), mesh)
    y = affine_scan(x.contiguous(), a, y0.contiguous())
    return y, y[-1]


def prev_frames(x: torch.Tensor, tail: torch.Tensor,
                mesh: Mesh | None = None):
    """The M = tail.shape[0] frames of the global stream just before x
    (the carried tail on rank 0), and the stream's new last-M tail,
    concat(tail, x)[T:T+M] single device, which reaches back into the old
    tail when T < M. Under a mesh: one all_gather of every rank's last M
    frames when T >= M, else of the whole slices."""
    T, C = x.shape
    M = tail.shape[0]
    if mesh is None:
        xcat = torch.cat([tail, x])
        return tail, xcat[T:T + M]
    if T >= M:
        last = all_gather(x[-M:], mesh)  # [n, M, C]
        halo = tail if mesh.rank == 0 else last[mesh.rank - 1]
        return halo, last[-1]
    flat = torch.cat([tail, all_gather(x, mesh).reshape(mesh.size * T, C)])
    return flat[mesh.rank * T:mesh.rank * T + M], flat[-M:]


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


# launches of csrc/biquad_seq.cu by biquad_apply_sequential (CPU calls do
# not count)
biquad_seq_launches = 0


def biquad_seq_plain(x, b0, b1, b2, a1, a2, state):
    """The exact lane's plain version: a per-frame float32 loop over the
    host copies of x [T, C], the per-channel coefficients [C] and the
    state [4, C], each multiply and add rounded on its own in the
    reference's order y = (((b0*x + b1*x1) + b2*x2) - a1*y1) - a2*y2.
    Returns (y [T, C], state (x[T-1], x[T-2], y[T-1], y[T-2])) on x's
    device."""
    xs = x.detach().cpu().numpy()
    B0, B1, B2, A1, A2 = (np.asarray(c.detach().cpu().numpy(), np.float32)
                          for c in (b0, b1, b2, a1, a2))
    x1, x2, y1, y2 = state.detach().cpu().numpy().astype(np.float32)
    y = np.empty_like(xs)
    for t in range(xs.shape[0]):
        xt = xs[t]
        acc = B0 * xt + B1 * x1
        acc = acc + B2 * x2
        acc = acc - A1 * y1
        acc = acc - A2 * y2
        y[t] = acc
        x2, x1, y2, y1 = x1, xt, y1, acc
    s = np.stack([x1, x2, y1, y2])
    return (torch.from_numpy(y).to(x.device),
            torch.from_numpy(s).to(x.device))


def biquad_apply_sequential(x: torch.Tensor, coefs: tuple,
                            state: torch.Tensor):
    """The exact-order sequential biquad over x [T, C] (reference
    filters.py:384-406): the recurrence of biquad_apply evaluated frame by
    frame with no reassociation. `coefs` = (b0, b1, b2, a1, a2), each a
    scalar, a 0-d tensor or a [C] tensor; state [4, C]. Returns (y [T, C],
    new state [4, C]). CUDA tensors run csrc/biquad_seq.cu, CPU tensors
    biquad_seq_plain; anything else raises."""
    global biquad_seq_launches
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"biquad_apply_sequential: x must be [T, C] with "
                         f"T, C >= 1, got {tuple(x.shape)}")
    T, C = x.shape
    cs = tuple(lanes(c, C, x.device) for c in coefs)
    if len(cs) != 5:
        raise ValueError(f"biquad_apply_sequential: 5 coefficients, got "
                         f"{len(cs)}")
    if state.shape != (4, C):
        raise ValueError(f"biquad_apply_sequential: state must be [4, {C}],"
                         f" got {tuple(state.shape)}")
    for name, t in (("x", x), ("state", state)) + tuple(
            zip(("b0", "b1", "b2", "a1", "a2"), cs)):
        if t.device != x.device:
            raise ValueError(f"biquad_apply_sequential: {name} on "
                             f"{t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"biquad_apply_sequential: {name} is {t.dtype}, "
                            "expected torch.float32")
    if x.device.type == "cpu":
        return biquad_seq_plain(x, *cs, state)
    if x.device.type != "cuda":
        raise ValueError(f"biquad_apply_sequential: unsupported device "
                         f"{x.device}")
    from ..kernels import biquad_seq_launch

    x, state = x.contiguous(), state.contiguous()
    y = torch.empty_like(x)
    new_state = torch.empty_like(state)
    biquad_seq_launch(x, *cs, state, y, new_state)
    biquad_seq_launches += 1
    return y, new_state


# the lane pinned for the calls inside exact_biquad_scope: the compiled
# graph reads TERMDAW_EXACT_BIQUAD once at build and renders each window
# under its value, so a later change of the variable does not switch a
# built graph's lane (a ContextVar, so interleaved renders of graphs built
# with different values each keep their own)
_EXACT_BIQUAD_OVERRIDE: contextvars.ContextVar[bool | None] = (
    contextvars.ContextVar("exact_biquad_override", default=None)
)


@contextlib.contextmanager
def exact_biquad_scope(value: bool):
    """Pin the biquad lane (True: the exact sequential lane) inside."""
    token = _EXACT_BIQUAD_OVERRIDE.set(bool(value))
    try:
        yield
    finally:
        _EXACT_BIQUAD_OVERRIDE.reset(token)


def exact_biquad_env() -> bool:
    """TERMDAW_EXACT_BIQUAD=1 asks for the exact sequential biquad lane."""
    return os.environ.get("TERMDAW_EXACT_BIQUAD", "0") == "1"


def _exact_biquad() -> bool:
    pinned = _EXACT_BIQUAD_OVERRIDE.get()
    return exact_biquad_env() if pinned is None else pinned


def _first_order_complex(f_r, f_i, p_r, p_i, s_r, s_i,
                         mesh: Mesh | None):
    """u[n] = p*u[n-1] + f[n] with u[-1] = s, complex as (re, im) real
    lanes; f [T, C], p and s [C]. Returns (u_r, u_i, ufin_r, ufin_i): the
    window and the global stream's final value (filters.py:316-354); under
    a mesh the seed entering this rank's slice is the earlier ranks' fold
    applied to s."""
    if mesh is None:
        u_r, u_i = complex_affine_scan(f_r, f_i, p_r, p_i, s_r, s_i)
        return u_r, u_i, u_r[-1], u_i[-1]
    pre, tot = exclusive_total(_caffine, (1.0, 0.0, 0.0, 0.0),
                               complex_summary(f_r, f_i, p_r, p_i), mesh)
    sr, si = s_r.double(), s_i.double()

    def apply(m):
        mar, mai, mbr, mbi = m
        return ((mar * sr - mai * si + mbr).float(),
                (mar * si + mai * sr + mbi).float())

    l_r, l_i = apply(pre)
    u_r, u_i = complex_affine_scan(f_r, f_i, p_r, p_i, l_r, l_i)
    return (u_r, u_i, *apply(tot))


def biquad_apply(x: torch.Tensor, coefs: tuple, state: torch.Tensor,
                 mesh: Mesh | None = None):
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

    each one complex_affine_scan (filters.py:444-534). Where the exact
    lane is pinned or asked for, biquad_apply_sequential runs instead
    (filters.py:479-480), on one device only. Under a mesh x is this
    rank's slice, the feed-forward taps before it come from prev_frames
    and the returned state is the global stream's."""
    if mesh is None and _exact_biquad():
        return biquad_apply_sequential(x, coefs, state)
    T, C = x.shape
    b0, b1, b2, a1, a2 = coefs
    if mesh is None:
        x1 = torch.cat([state[0:1], x[:-1]])
        x2 = torch.cat([state[1:2], x1[:-1]]) if T > 1 else \
            state[1:2].expand(T, C)
        new_x1, new_x2 = x[-1], (x1[-1] if T > 1 else state[0])
    else:
        # the 2 global-stream frames before this slice
        halo, new_tail = prev_frames(x, torch.stack([state[1], state[0]]),
                                     mesh)
        xcat = torch.cat([halo, x])  # [T+2, C]
        x1, x2 = xcat[1:T + 1], xcat[0:T]
        new_x1, new_x2 = new_tail[1], new_tail[0]
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
    u_r, u_i, ufin_r, ufin_i = _first_order_complex(
        f, torch.zeros_like(f), p1r, p1i, u0r, u0i, mesh)
    y_r, _, yfin_r, yfin_i = _first_order_complex(
        u_r, u_i, p2r, p2i, y1.contiguous(), torch.zeros_like(y1), mesh)
    # y is real by construction; the imaginary lane carries only rounding
    if mesh is None:
        new_y2 = y_r[-2] if T > 1 else state[2]
    else:
        # the global y[T-2] is not on this rank: from y[T-1] = p2*y[T-2] +
        # u[T-1], by a complex division with |p2|^2 = a2 clamped (tiny only
        # for a nearly first-order section, where y[n-2] hardly counts)
        dr, di = yfin_r - ufin_r, yfin_i - ufin_i
        den = torch.clamp(p2r * p2r + p2i * p2i, min=1e-12)
        new_y2 = (dr * p2r + di * p2i) / den
    new_state = torch.stack([new_x1, new_x2, yfin_r, new_y2])
    return y_r, new_state
