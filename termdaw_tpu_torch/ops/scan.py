"""First-order recurrences over a timeline, one per lane of [T, C].

The reference evaluates them as XLA `associative_scan`s of small monoid
elements, two-level over tiles of 1024 frames
(termdaw_tpu/ops/filters.py:72-114 `tiled_cumulative`). PyTorch has no
primitive for any of them, so for each:

* a plain version is that two-level form in PyTorch ops
  (`_tiled_cumulative`): an inclusive log-step (Hillis-Steele) scan inside
  each tile, the same scan over the tile summaries, then each tile's
  exclusive prefix composed in. It runs for CPU tensors and is the oracle
  of the kernel;
* on CUDA tensors the wrapper launches a hand-written kernel or raises,
  and counts its launches in a module counter.

The three recurrences:

* `affine_scan`: y[t] = a * y[t-1] + b[t], composed as (A2*A1, A2*B1 + B2)
  (filters.py:117 `affine_cumulative`; band-pass, one-pole followers,
  feedback lines), kernel csrc/affine_scan.cu, counter `launches`;
* `max_decay_scan`: y[t] = max(x[t], r * y[t-1]), composed as
  (A1*A2, max(B2, A2*B1)) with identity (1, -3.0e38) (fx.py:57-89,
  compressor peak follower; the decay products in float64), kernel
  csrc/max_decay_scan.cu, counter `max_decay_launches`;
* `complex_affine_scan`: u[t] = p * u[t-1] + f[t] on complex values held
  as real lanes, composed by `_caffine_combine` (filters.py:295-354,
  biquad pole cascades), kernel csrc/complex_scan.cu, counter
  `complex_launches`.

Types: every tensor float32 and contiguous; sequences [T, C], per-lane
values [C]. The two forms associate the products differently, so they
agree to float32 rounding, not bit for bit.

Under timeline sharding (ops/filters.exclusive_total) each rank needs its
shard's fold (A, B) per lane before its seeded scan: `affine_summary`,
`max_decay_summary` and `complex_summary` take B from the same wrapper,
launched with the monoid's identity seed (0, or -3.0e38 for the
max-decay), as the last row of its output, and A, the lane's decay raised
to the count of rows, in float64 (the kernels carry r^n in float64 too).
A sharded scan is then two launches of the kernel: this one and the
seeded one.
"""

from __future__ import annotations

import torch

from ..utils.roofline import counted

# launches of each CUDA kernel by its wrapper (CPU calls do not count)
launches = 0             # affine_scan
max_decay_launches = 0   # max_decay_scan
complex_launches = 0     # complex_affine_scan

SCAN_TILE = 1024
MAX_DECAY_IDENTITY = -3.0e38


def _affine(left, right):
    """(earlier, later) -> the map 'earlier, then later'."""
    a1, b1 = left
    a2, b2 = right
    return a2 * a1, a2 * b1 + b2


def _max_decay(left, right):
    """(decay, value) elements; the decays may be float64 (see
    max_decay_scan_plain), the values stay in their own dtype."""
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, torch.maximum(b2, (a2 * b1).to(b2.dtype))


def _caffine(left, right):
    """Complex affine maps u -> A*u + B as 4 real lanes (ar, ai, br, bi),
    composed (earlier, later) in the reference's product order."""
    ar1, ai1, br1, bi1 = left
    ar2, ai2, br2, bi2 = right
    return (
        ar2 * ar1 - ai2 * ai1,
        ar2 * ai1 + ai2 * ar1,
        ar2 * br1 - ai2 * bi1 + br2,
        ar2 * bi1 + ai2 * br1 + bi2,
    )


def _inclusive(combine, elems: tuple, dim: int) -> tuple:
    """Inclusive log-step scan of monoid elements along `dim`."""
    n = elems[0].shape[dim]
    d = 1
    while d < n:
        new = combine(tuple(e.narrow(dim, 0, n - d) for e in elems),
                      tuple(e.narrow(dim, d, n - d) for e in elems))
        elems = tuple(torch.cat([e.narrow(dim, 0, d), m], dim)
                      for e, m in zip(elems, new))
        d *= 2
    return elems


def _tiled_cumulative(combine, identity: tuple, elems: tuple) -> tuple:
    """Inclusive cumulative `combine` along axis 0 of [T, C] elements, in
    the two-level form of filters.tiled_cumulative; `identity` pads the
    last tile and shifts the tile prefixes. The last element is [T, C];
    the others may be per-lane [C] (broadcast over the timeline)."""
    T, C = elems[-1].shape
    S = min(SCAN_TILE, T)
    R = -(-T // S)
    pad = R * S - T
    tiled = []
    for e, ident in zip(elems, identity):
        e = e.expand(T, C)
        if pad:
            e = torch.cat([e, e.new_full((pad, C), ident)])
        tiled.append(e.reshape(R, S, C))
    cum = _inclusive(combine, tuple(tiled), 1)
    prow = _inclusive(combine, tuple(c[:, -1] for c in cum), 0)
    excl = tuple(torch.cat([p.new_full((1, C), ident), p[:-1]])
                 for p, ident in zip(prow, identity))
    out = combine(tuple(e[:, None] for e in excl), cum)
    return tuple(o.reshape(R * S, C)[:T] for o in out)


def affine_scan_plain(b: torch.Tensor, a: torch.Tensor,
                      y0: torch.Tensor) -> torch.Tensor:
    """The two-level tiled scan, then y = A_cum * y0 + B_cum."""
    A_cum, B_cum = _tiled_cumulative(_affine, (1.0, 0.0), (a, b))
    return A_cum * y0 + B_cum


def max_decay_scan_plain(x: torch.Tensor, r: torch.Tensor,
                         y0: torch.Tensor) -> torch.Tensor:
    """The two-level tiled scan, then y = max(B_cum, A_cum * y0).

    The decay products A (powers of r) are carried in float64, as the
    kernel carries them. Every tile composes the same power of r, so in
    float32 their rounding errors add up along a long decay: 3.4e-5 of
    max |y| at one c4 compressor window (r = 0.99992), against 9e-7 for a
    sequential float32 recurrence. The values B stay float32."""
    A_cum, B_cum = _tiled_cumulative(
        _max_decay, (1.0, MAX_DECAY_IDENTITY), (r.double(), x))
    return torch.maximum(B_cum, (A_cum * y0.double()).to(x.dtype))


def complex_affine_scan_plain(
    f_r: torch.Tensor, f_i: torch.Tensor, p_r: torch.Tensor,
    p_i: torch.Tensor, s_r: torch.Tensor, s_i: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-level tiled scan, then u = A_cum * s + B_cum (complex)."""
    ar, ai, br, bi = _tiled_cumulative(
        _caffine, (1.0, 0.0, 0.0, 0.0), (p_r, p_i, f_r, f_i))
    return ar * s_r - ai * s_i + br, ar * s_i + ai * s_r + bi


def _check(op: str, seqs: tuple, lanes: tuple) -> None:
    """seqs: (name, [T, C] tensor) pairs; lanes: (name, [C] tensor) pairs.
    All on one device, float32, contiguous."""
    first = seqs[0][1]
    dev = first.device
    for name, t in seqs + lanes:
        if t.device != dev:
            raise ValueError(f"{op}: {name} on {t.device}, {seqs[0][0]} on "
                             f"{dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} is {t.dtype}, expected "
                            "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if first.dim() != 2 or first.shape[0] < 1 or first.shape[1] < 1:
        raise ValueError(f"{op}: {seqs[0][0]} must be [T, C] with T, C >= 1,"
                         f" got {tuple(first.shape)}")
    for name, t in seqs[1:]:
        if t.shape != first.shape:
            raise ValueError(f"{op}: {name} must be {tuple(first.shape)}, got"
                             f" {tuple(t.shape)}")
    C = first.shape[1]
    for name, t in lanes:
        if t.shape != (C,):
            raise ValueError(f"{op}: {name} must be [{C}], got "
                             f"{tuple(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {dev}")


def affine_scan_work(b: torch.Tensor, a: torch.Tensor,
                     y0: torch.Tensor) -> tuple[float, float]:
    """(flops, bytes) of one affine_scan: a multiply-add a frame a lane;
    b, a and y0 read once, y written once."""
    T, C = b.shape
    return 2.0 * T * C, (2.0 * T * C + 2 * C) * 4


# a multiply and a max a frame a lane; x, r and y0 read once, y written
# once: the affine scan's count
max_decay_scan_work = affine_scan_work


def complex_affine_scan_work(
    f_r: torch.Tensor, f_i: torch.Tensor, p_r: torch.Tensor,
    p_i: torch.Tensor, s_r: torch.Tensor, s_i: torch.Tensor,
) -> tuple[float, float]:
    """(flops, bytes) of one complex_affine_scan: a complex multiply-add
    (8 real operations) a frame a lane; f, p and s read once, u written
    once."""
    T, C = f_r.shape
    return 8.0 * T * C, (4.0 * T * C + 4 * C) * 4


@counted(affine_scan_work)
def affine_scan(b: torch.Tensor, a: torch.Tensor,
                y0: torch.Tensor) -> torch.Tensor:
    """y [T, C] with y[t, c] = a[c] * y[t-1, c] + b[t, c], y[-1] = y0.
    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version."""
    global launches
    _check("affine_scan", (("b", b),), (("a", a), ("y0", y0)))
    if b.device.type == "cpu":
        return affine_scan_plain(b, a, y0)
    from ..kernels import affine_scan_launch

    y = torch.empty_like(b)
    affine_scan_launch(b, a, y0, y)
    launches += 1
    return y


@counted(max_decay_scan_work)
def max_decay_scan(x: torch.Tensor, r: torch.Tensor,
                   y0: torch.Tensor) -> torch.Tensor:
    """y [T, C] with y[t, c] = max(x[t, c], r[c] * y[t-1, c]), y[-1] = y0;
    NaN propagates as in torch.maximum. CUDA tensors run the hand-written
    kernel; CPU tensors the plain version."""
    global max_decay_launches
    _check("max_decay_scan", (("x", x),), (("r", r), ("y0", y0)))
    if x.device.type == "cpu":
        return max_decay_scan_plain(x, r, y0)
    from ..kernels import max_decay_scan_launch

    y = torch.empty_like(x)
    max_decay_scan_launch(x, r, y0, y)
    max_decay_launches += 1
    return y


@counted(complex_affine_scan_work)
def complex_affine_scan(
    f_r: torch.Tensor, f_i: torch.Tensor, p_r: torch.Tensor,
    p_i: torch.Tensor, s_r: torch.Tensor, s_i: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(u_r, u_i), each [T, C], with u[t] = p * u[t-1] + f[t] in complex
    arithmetic on (re, im) lanes, u[-1] = s. CUDA tensors run the
    hand-written kernel; CPU tensors the plain version."""
    global complex_launches
    _check("complex_affine_scan", (("f_r", f_r), ("f_i", f_i)),
           (("p_r", p_r), ("p_i", p_i), ("s_r", s_r), ("s_i", s_i)))
    if f_r.device.type == "cpu":
        return complex_affine_scan_plain(f_r, f_i, p_r, p_i, s_r, s_i)
    from ..kernels import complex_scan_launch

    u_r = torch.empty_like(f_r)
    u_i = torch.empty_like(f_r)
    complex_scan_launch(f_r, f_i, p_r, p_i, s_r, s_i, u_r, u_i)
    complex_launches += 1
    return u_r, u_i


# -- each shard's fold, for the sharded scans (ops/filters.exclusive_total)

def affine_summary(b: torch.Tensor, a: torch.Tensor):
    """The fold of the T maps y -> a*y + b[t] per lane: (A = a^T float64
    [C], B = affine_scan from y0 = 0, last row, float32 [C])."""
    B = affine_scan(b, a, torch.zeros_like(a))[-1]
    return a.double() ** b.shape[0], B


def max_decay_summary(x: torch.Tensor, r: torch.Tensor):
    """The fold of the T max-decay steps per lane: (A = r^T float64 [C],
    B = max_decay_scan from the identity -3.0e38, last row, [C])."""
    B = max_decay_scan(x, r, torch.full_like(r, MAX_DECAY_IDENTITY))[-1]
    return r.double() ** x.shape[0], B


def complex_summary(f_r: torch.Tensor, f_i: torch.Tensor, p_r: torch.Tensor,
                    p_i: torch.Tensor):
    """The fold of the T complex maps u -> p*u + f[t] per lane, as
    (A_r, A_i, B_r, B_i): A = p^T in complex128, B = complex_affine_scan
    from u = 0, last row."""
    z = torch.zeros_like(p_r)
    u_r, u_i = complex_affine_scan(f_r, f_i, p_r, p_i, z, z)
    A = torch.complex(p_r.double(), p_i.double()) ** f_r.shape[0]
    return A.real, A.imag, u_r[-1], u_i[-1]
