"""Band-unlimited oscillators (reference synth.rs:21-34), on tensors.

Port of termdaw_tpu/ops/osc.py. All take time in seconds (tensor),
frequency in Hz, and the shape parameter z where applicable:

* square-sine: clamp(sin, -z, z) / z              (synth.rs:21-24)
* topflat-sine: (min(sin, z) + (1-z)/2) * 2/(1+z) (synth.rs:26-29)
* triangle: 4*|t*hz - floor(t*hz + 1/2)| - 1      (synth.rs:31-34)

`sin_f32` keeps the reference's three-term Cody-Waite reduction of the
f32 argument by 2π and takes `torch.sin` of the residue, so the phase of
a second-scale argument is resolved as the reference resolves it.
Scalar constants are rounded to f32 in numpy first, as the reference's
jnp.float32 operands are.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 6.283185307179586


def _split_two_pi() -> tuple[float, float, float]:
    """2π = HI + MID + LO with HI/MID carrying 8 explicit mantissa bits
    each (so k*HI and k*MID are exact f32 products for integer k < 2^16)
    and LO the f32 remainder."""
    def trunc8(v: float) -> float:
        f = np.float32(v)
        bits = f.view(np.uint32) & np.uint32(0xFFFF0000)  # keep 8 frac bits
        return float(bits.view(np.float32))

    hi = trunc8(TWO_PI)
    mid = trunc8(TWO_PI - hi)
    lo = float(np.float32(TWO_PI - hi - mid))
    return hi, mid, lo


_PI2_HI, _PI2_MID, _PI2_LO = _split_two_pi()
_INV_2PI = float(np.float32(1.0 / TWO_PI))
_REDUCE_MAX = 4.0e5  # k < 2^16: exactness bound of the reduction


def sin_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 sine: Cody-Waite reduce x mod 2π, then sin of the residue;
    plain sin beyond the reduction's exactness range (where the f32
    argument itself no longer resolves the phase). torch.round rounds
    half to even, as jnp.round does."""
    k = torch.round(x * _INV_2PI)
    r = x - k * _PI2_HI
    r = r - k * _PI2_MID
    r = r - k * _PI2_LO
    return torch.where(torch.abs(x) < _REDUCE_MAX, torch.sin(r), torch.sin(x))


def square_sine(t: torch.Tensor, hz: torch.Tensor, z: float) -> torch.Tensor:
    s = sin_f32(t * hz * TWO_PI)
    z32 = np.float32(z)
    return torch.clamp(s, -float(z32), float(z32)) * float(np.float32(1.0) / z32)


def topflat_sine(t: torch.Tensor, hz: torch.Tensor, z: float) -> torch.Tensor:
    s = sin_f32(t * hz * TWO_PI)
    z32 = np.float32(z)
    one = np.float32(1.0)
    return ((torch.clamp(s, max=float(z32)) + float((one - z32) / np.float32(2.0)))
            * float(np.float32(2.0) / (one + z32)))


def triangle(t: torch.Tensor, hz: torch.Tensor) -> torch.Tensor:
    x = t * hz
    return 4.0 * torch.abs(x - torch.floor(x + 0.5)) - 1.0


def note_hz(note: torch.Tensor) -> torch.Tensor:
    """MIDI note number -> Hz (reference extensions.rs:451). The render
    path bakes hz on the host in float64 (graph/bake._note_hz)."""
    return 440.0 * torch.exp2((note.to(torch.float32) - 69.0) / 12.0)
