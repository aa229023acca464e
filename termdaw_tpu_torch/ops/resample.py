"""Windowed-sinc sample-rate conversion.

Port of termdaw_tpu/ops/resample.py. The filter recipe is the reference's
(256-tap sinc, Blackman-Harris window, cutoff 0.95 scaled by the ratio
when downsampling; rubato's SincFixedIn, sample.rs:150-175 and
state.rs:533-561). The numpy parts are carried over verbatim:
`_window_at`, `_exact_filter`, `polyphase_kernel`, `filter_bank` and
`resample_sample` (the sample-import path, computed on the host).

The render path's whole-signal resample (`StreamingResampler.
render_whole`) is one float32 `torch.matmul`, X[Q, K] @ W[K, L]: output
phase p of row q reads the padded input window X[q] = xp[q*M : q*M + K]
through phase p's exact filter, packed at its offset in W's column p.
Full f32 products are required (termdaw_tpu_torch.device.set_full_f32).

`resample_device` and the chunked `StreamingResampler.feed`/`flush`
(carried tail, host-integer row bookkeeping) complete the reference's API
on the same matmul, with the reference's gather over `filter_bank` for
ratios beyond MAX_PHASES phases; no module of the port calls them.

Alignment (first-party, as in the reference): output sample n is input
position n*M/L; the filter is centered; edges are zero-padded; output
length = ceil(len*L/M).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

SINC_LEN = 256
OVERSAMPLE = 256
F_CUTOFF = 0.95
MAX_PHASES = 4096
_TILE = 8192


def _window_at(x: np.ndarray) -> np.ndarray:
    """4-term Blackman-Harris evaluated at tap positions x (centered
    coordinates, window support [-SINC_LEN/2, SINC_LEN/2])."""
    n = SINC_LEN
    wpos = np.clip((x / n + 0.5) * (n - 1), 0, n - 1)
    return (
        0.35875
        - 0.48829 * np.cos(2 * np.pi * wpos / (n - 1))
        + 0.14128 * np.cos(4 * np.pi * wpos / (n - 1))
        - 0.01168 * np.cos(6 * np.pi * wpos / (n - 1))
    )


def _exact_filter(frac: float, cutoff: float) -> np.ndarray:
    """Exact windowed-sinc for one fractional delay, unity DC gain."""
    j = np.arange(SINC_LEN, dtype=np.float64)
    x = (j - (SINC_LEN // 2 - 1)) - frac
    h = cutoff * np.sinc(cutoff * x) * _window_at(x)
    return h / h.sum()


@lru_cache(maxsize=16)
def polyphase_kernel(from_sr: int, to_sr: int) -> tuple[np.ndarray, int, int]:
    """Conv kernel [L, 1, K] for the polyphase formulation + (L, M).

    Row p holds phase p's exact 256-tap filter placed at offset
    floor(p*M/L) within the K = (M-1) + SINC_LEN window."""
    g = math.gcd(from_sr, to_sr)
    L, M = to_sr // g, from_sr // g
    ratio = to_sr / from_sr
    cutoff = F_CUTOFF * min(1.0, ratio)
    K = (M - 1) + SINC_LEN
    w = np.zeros((L, 1, K), dtype=np.float64)
    for p in range(L):
        off = (p * M) // L
        frac = (p * M % L) / L
        w[p, 0, off : off + SINC_LEN] = _exact_filter(frac, cutoff)
    return w.astype(np.float32), L, M


@lru_cache(maxsize=8)
def filter_bank(ratio_key: tuple[int, int]) -> np.ndarray:
    from_sr, to_sr = ratio_key
    cutoff = F_CUTOFF * min(1.0, to_sr / from_sr)
    bank = np.zeros((OVERSAMPLE + 1, SINC_LEN), dtype=np.float64)
    for p in range(OVERSAMPLE + 1):
        bank[p] = _exact_filter(p / OVERSAMPLE, cutoff)
    return bank.astype(np.float32)


def _n_out(n: int, from_sr: int, to_sr: int) -> int:
    return math.ceil(n * to_sr / from_sr)


def resample_sample(x: np.ndarray, from_sr: int, to_sr: int) -> np.ndarray:
    """Sample-import resample (reference sample.rs:305-310), computed ON
    THE HOST with the same oversampled-bank + linear-interpolation recipe
    as rubato's SincFixedIn. float64 accumulation over the 256 taps,
    rounded once."""
    x = np.asarray(x, dtype=np.float32)
    if from_sr == to_sr:
        return x
    n = x.shape[0]
    c = x.shape[1]
    n_out = _n_out(n, from_sr, to_sr)
    half = SINC_LEN // 2
    xpad = np.zeros((n + SINC_LEN, c), np.float64)
    xpad[half - 1 : half - 1 + n] = x
    bank = filter_bank((from_sr, to_sr)).astype(np.float64)
    out = np.empty((n_out, c), np.float32)
    tile = 16384
    taps = np.arange(SINC_LEN)
    for t0 in range(0, n_out, tile):
        nn = np.arange(t0, min(t0 + tile, n_out))
        num = nn * from_sr
        int_pos = num // to_sr
        frac = (num % to_sr) / float(to_sr)
        idx = np.clip(int_pos[:, None] + taps[None, :], 0, len(xpad) - 1)
        windows = xpad[idx]  # [T, taps, C]
        pf = frac * OVERSAMPLE
        p0 = np.floor(pf).astype(np.int64)
        w = (pf - p0)[:, None]
        filt = bank[p0] * (1.0 - w) + bank[p0 + 1] * w
        out[t0 : t0 + len(nn)] = np.einsum(
            "tjc,tj->tc", windows, filt
        ).astype(np.float32)
    return out


def polyphase_rows(
    buf: torch.Tensor, W: torch.Tensor, rows: int, M: int
) -> torch.Tensor:
    """`rows` polyphase output rows of the padded signal buf [N, C] with
    N >= (rows-1)*M + K: one matmul X[C, rows, K] @ W[K, L], flattened to
    [rows*L, C]."""
    K, L = W.shape
    C = buf.shape[1]
    X = buf.t().contiguous().unfold(1, K, M)[:, :rows]  # [C, rows, K]
    out = torch.matmul(X, W)  # [C, rows, L]
    return out.permute(1, 2, 0).reshape(rows * L, C)


def _gather_resample(x: torch.Tensor, from_sr: int, to_sr: int,
                     n_out: int) -> torch.Tensor:
    """The reference's gather path (resample.py:131-156) for ratios with
    more than MAX_PHASES phases: per output frame, the 256 taps of the
    zero-padded input around n*from/to through the oversampled bank
    interpolated linearly at the fractional position (float32), in tiles
    of _TILE frames."""
    n, c = x.shape
    half = SINC_LEN // 2
    xpad = x.new_zeros((n + SINC_LEN, c))
    xpad[half - 1:half - 1 + n] = x
    bank = torch.from_numpy(filter_bank((from_sr, to_sr))).to(x.device)
    taps = torch.arange(SINC_LEN, device=x.device)
    outs = []
    for t0 in range(0, n_out, _TILE):
        nn = torch.arange(t0, min(t0 + _TILE, n_out), device=x.device)
        num = nn * from_sr
        frac = (num % to_sr).to(torch.float32) / np.float32(to_sr)
        idx = (num // to_sr)[:, None] + taps[None, :]
        windows = xpad[idx.clamp(0, xpad.shape[0] - 1)]  # [T, taps, C]
        pf = frac * OVERSAMPLE
        p0 = torch.floor(pf)
        w = (pf - p0)[:, None]
        p0 = p0.long()
        filt = bank[p0] * (1.0 - w) + bank[p0 + 1] * w
        outs.append(torch.einsum("tjc,tj->tc", windows, filt))
    return torch.cat(outs)


def resample_device(x: torch.Tensor, from_sr: int, to_sr: int) -> torch.Tensor:
    """Resample x [N, C] on its device to [ceil(N*to/from), C] (reference
    resample.py:167-180): one polyphase matmul (polyphase_rows) when the
    reduced ratio has at most MAX_PHASES output phases, else the gather
    over filter_bank."""
    if from_sr == to_sr:
        return x
    n_out = _n_out(x.shape[0], from_sr, to_sr)
    if to_sr // math.gcd(from_sr, to_sr) <= MAX_PHASES:
        return StreamingResampler(from_sr, to_sr, x.device,
                                  x.shape[1]).render_whole([x])
    return _gather_resample(x, from_sr, to_sr, n_out)


class StreamingResampler:
    """Chunked polyphase resample with carried state (reference
    termdaw_tpu/ops/resample.py:278-397): `feed` chunks, then `flush`,
    gives the output of `resample_device` on the concatenation up to
    float32 summation order; `render_whole` does a complete signal in one
    matmul. The input starts behind `lead` zero frames (the centered
    filter's look-back) and the end is zero-padded to complete the last
    row. The row bookkeeping is host integers: `avail` padded-stream
    frames held (the carried `tail` covers those from row q_done on),
    `q_done` rows emitted, `n_in` frames fed, `n_emitted` frames out."""

    def __init__(self, from_sr: int, to_sr: int, device: torch.device,
                 channels: int = 2) -> None:
        w, self.L, self.M = polyphase_kernel(from_sr, to_sr)
        self.K = w.shape[2]
        self.W = torch.from_numpy(np.ascontiguousarray(w[:, 0, :].T)).to(
            device
        )  # [K, L]
        self.lead = SINC_LEN // 2 - 1
        self.channels = channels
        self.device = device
        self.tail = torch.zeros((self.lead, channels), dtype=torch.float32,
                                device=device)
        self.avail = self.lead
        self.q_done = 0
        self.n_in = 0
        self.n_emitted = 0

    def _empty(self) -> torch.Tensor:
        return torch.zeros((0, self.channels), dtype=torch.float32,
                           device=self.device)

    def feed(self, x: torch.Tensor) -> torch.Tensor:
        """Feed [n, C]; returns the output rows whose windows are complete
        ([m, C], m may be 0)."""
        self.n_in += int(x.shape[0])
        self.avail += int(x.shape[0])
        q_ready = self.q_done
        if self.avail >= self.K:
            q_ready = max(self.q_done, (self.avail - self.K) // self.M + 1)
        return self._step(x, q_ready, trail=0)

    def flush(self) -> torch.Tensor:
        """Emit the rest, zero-padding the end, so that the total output
        is ceil(n_in * L / M) frames."""
        n_out_total = math.ceil(self.n_in * self.L / self.M)
        q_total = -(-n_out_total // self.L)
        if q_total <= self.q_done:
            return self._empty()
        trail = max(0, (q_total - 1) * self.M + self.K - self.avail)
        return self._step(self._empty(), q_total, trail,
                          take=n_out_total - self.n_emitted)

    def _step(self, x: torch.Tensor, q_ready: int, trail: int,
              take: int | None = None) -> torch.Tensor:
        rows = q_ready - self.q_done
        if rows <= 0:
            if x.shape[0]:
                self.tail = torch.cat([self.tail, x])
            return self._empty()
        # buf holds padded-stream frames [q_done*M, avail + trail); after
        # row q_ready - 1 the frames from q_ready*M on are kept
        keep = max(0, self.avail + trail - q_ready * self.M)
        buf = torch.cat([self.tail, x, x.new_zeros((trail, self.channels))])
        out = polyphase_rows(buf, self.W, rows, self.M)
        self.tail = buf[rows * self.M:rows * self.M + keep]
        if take is not None:
            out = out[:take]
        self.avail = q_ready * self.M + keep
        self.q_done = q_ready
        self.n_emitted += int(out.shape[0])
        return out

    def render_whole(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """Resample a COMPLETE signal given as window chunks [n_i, C]:
        output length ceil(sum(n_i) * L / M). Must be called on a fresh
        resampler."""
        if self.n_in or self.q_done:
            raise RuntimeError("StreamingResampler.render_whole: resampler "
                               "not fresh")
        n_in = sum(int(x.shape[0]) for x in xs)
        if n_in == 0:
            return torch.zeros((0, self.channels), dtype=torch.float32,
                               device=self.device)
        self.n_in = n_in
        n_out = math.ceil(n_in * self.L / self.M)
        rows = -(-n_out // self.L)
        avail = self.lead + n_in
        trail = max(0, (rows - 1) * self.M + self.K - avail)
        z = xs[0].new_zeros
        buf = torch.cat(
            [z((self.lead, self.channels)), *xs, z((trail, self.channels))]
        )
        return polyphase_rows(buf, self.W, rows, self.M)[:n_out]
