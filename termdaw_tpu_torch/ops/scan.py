"""First-order affine recurrence over a timeline: y[t] = a * y[t-1] + b[t].

The reference evaluates one-pole filters (band-pass lanes, effect
followers) as an XLA `associative_scan` over affine maps y -> A*y + B,
composed as (A2*A1, A2*B1 + B2), two-level over tiles of 1024 frames
(termdaw_tpu/ops/filters.py:72-121 `tiled_cumulative`, `affine_cumulative`).
PyTorch has no primitive for it, so:

* `affine_scan_plain` is that two-level form in PyTorch ops: an inclusive
  log-step (Hillis-Steele) scan inside each tile, the same scan over the
  tile summaries, then each tile's exclusive prefix composed in. It runs
  for CPU tensors and is the oracle of the kernel;
* on CUDA tensors `affine_scan` launches the hand-written kernel
  csrc/affine_scan.cu or raises. It counts its launches.

Types: b [T, C] float32, a [C] float32, y0 [C] float32 (y[-1]) -> y [T, C].
The two forms associate the products differently, so they agree to
float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

# launches of the CUDA kernel by affine_scan (CPU calls do not count)
launches = 0

SCAN_TILE = 1024


def _combine(a1, b1, a2, b2):
    """(earlier, later) -> the map 'earlier, then later'."""
    return a2 * a1, a2 * b1 + b2


def _inclusive(A: torch.Tensor, B: torch.Tensor, dim: int):
    """Inclusive log-step scan of affine maps along `dim`."""
    n = A.shape[dim]
    d = 1
    while d < n:
        a1, b1 = A.narrow(dim, 0, n - d), B.narrow(dim, 0, n - d)
        a2, b2 = A.narrow(dim, d, n - d), B.narrow(dim, d, n - d)
        na, nb = _combine(a1, b1, a2, b2)
        A = torch.cat([A.narrow(dim, 0, d), na], dim)
        B = torch.cat([B.narrow(dim, 0, d), nb], dim)
        d *= 2
    return A, B


def affine_scan_plain(b: torch.Tensor, a: torch.Tensor,
                      y0: torch.Tensor) -> torch.Tensor:
    """The two-level tiled scan of filters.tiled_cumulative, then
    y = A_cum * y0 + B_cum."""
    T, C = b.shape
    S = min(SCAN_TILE, T)
    R = -(-T // S)
    pad = R * S - T
    A = a.expand(T, C)
    Bp = b
    if pad:  # identity maps (1, 0) on the tail
        A = torch.cat([A, A.new_ones(pad, C)])
        Bp = torch.cat([b, b.new_zeros(pad, C)])
    A_cum, B_cum = _inclusive(A.reshape(R, S, C), Bp.reshape(R, S, C), 1)
    # scan of the tile summaries, shifted by one tile: exclusive prefixes
    pa, pb = _inclusive(A_cum[:, -1], B_cum[:, -1], 0)
    ea = torch.cat([pa.new_ones(1, C), pa[:-1]])
    eb = torch.cat([pb.new_zeros(1, C), pb[:-1]])
    A_tot, B_tot = _combine(ea[:, None], eb[:, None], A_cum, B_cum)
    y = A_tot * y0 + B_tot
    return y.reshape(R * S, C)[:T]


def _check(b, a, y0) -> None:
    dev = b.device
    for name, t in (("b", b), ("a", a), ("y0", y0)):
        if t.device != dev:
            raise ValueError(f"affine_scan: {name} on {t.device}, b on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"affine_scan: {name} is {t.dtype}, expected "
                            "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"affine_scan: {name} is not contiguous")
    if b.dim() != 2 or b.shape[0] < 1 or b.shape[1] < 1:
        raise ValueError(f"affine_scan: b must be [T, C] with T, C >= 1, got "
                         f"{tuple(b.shape)}")
    if a.shape != (b.shape[1],) or y0.shape != (b.shape[1],):
        raise ValueError(f"affine_scan: a and y0 must be [{b.shape[1]}], got "
                         f"{tuple(a.shape)} and {tuple(y0.shape)}")


def affine_scan(b: torch.Tensor, a: torch.Tensor,
                y0: torch.Tensor) -> torch.Tensor:
    """y [T, C] with y[t, c] = a[c] * y[t-1, c] + b[t, c], y[-1] = y0.
    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version."""
    global launches
    _check(b, a, y0)
    dev = b.device
    if dev.type == "cpu":
        return affine_scan_plain(b, a, y0)
    if dev.type != "cuda":
        raise ValueError(f"affine_scan: unsupported device {dev}")
    from ..kernels import affine_scan_launch

    y = torch.empty_like(b)
    affine_scan_launch(b, a, y0, y)
    launches += 1
    return y
