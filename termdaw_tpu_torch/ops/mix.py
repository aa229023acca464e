"""Mixing primitives: input summation, constant-power pan, gain, normalize.

Port of termdaw_tpu/ops/mix.py (same arithmetic in the same order):

* sum_inputs accumulates inputs in connect order (extensions.rs:310-319);
* apply_angle is a constant-power pan, angle in degrees, +90 = full left,
  skipped when |angle| < 0.001 (sample.rs:97-106);
* apply_gain is skipped when |gain - 1| < 0.001 (sample.rs:108-114);
* post-op order is ext -> angle -> gain (extensions.rs:262-263);
* `vertex_post` is that epilogue at the end of a window program's vertex,
  an effect's wet blend first: its pan factors and three flags (blend,
  pan on, gain on) are resolved once when the graph is built
  (`pan_amps` over every vertex's angle, `post_flags` on the host in
  f32, as a `VertexPost`); CUDA tensors run it as one hand-written
  kernel, csrc/vertex_post.cu (counter `post_launches`), CPU tensors the
  plain composition `post(x + wet * (y - x), angle, gain)`. A vertex with
  no flag on has nothing to do: the window program keeps its buffer;
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

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import Mesh, all_gather, pmax
from ..utils.roofline import counted

DEG_TO_RAD_HALF = 0.5 * 0.01745329  # reference sample.rs:99 constant
_FRAC = 0.7071067811865476
SKIP = 0.001  # |angle| and |gain - 1| below it skip the pan and the gain

# launches of csrc/vertex_post.cu by vertex_post (CPU calls do not count)
post_launches = 0


def sum_inputs(ins: list[torch.Tensor]) -> torch.Tensor:
    """Sum [.., 2] inputs sequentially in connect order."""
    acc = ins[0]
    for x in ins[1:]:
        acc = acc + x
    return acc


def pan_amps(angle: torch.Tensor) -> torch.Tensor:
    """The constant-power pan's per-channel factors [..., 2] of angle
    [...] (f32 degrees); elementwise, so one call over many angles gives
    each angle's own call's bits."""
    rad = angle * DEG_TO_RAD_HALF
    c, s = torch.cos(rad), torch.sin(rad)
    return torch.stack([_FRAC * (c + s), _FRAC * (c - s)], dim=-1)


def apply_angle(x: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Constant-power pan. x is [..., 2]; angle a 0-dim f32 tensor."""
    skip = torch.abs(angle) < SKIP
    return torch.where(skip, x, x * pan_amps(angle))


def apply_gain(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    skip = torch.abs(gain - 1.0) < SKIP
    return torch.where(skip, x, x * gain)


def post(x: torch.Tensor, angle: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """ext -> angle -> gain (reference extensions.rs:262-263)."""
    return apply_gain(apply_angle(x, angle), gain)


def post_amps(angle: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """The per-channel linear factor [..., 2] equivalent to `post`, for
    angle/gain tensors of any (equal) shape — one call folds every member
    of a fused SampleMulti group. Reproduces the skip thresholds."""
    amps = torch.where(
        (torch.abs(angle) < SKIP)[..., None],
        torch.ones((), dtype=torch.float32, device=angle.device),
        pan_amps(angle),
    )
    g = torch.where(
        torch.abs(gain - 1.0) < SKIP,
        torch.ones((), dtype=torch.float32, device=gain.device),
        gain,
    )
    return amps * g[..., None]


def post_flags(angle, gain) -> tuple[np.ndarray, np.ndarray]:
    """(pan_on, gain_on) of angles and gains (numbers or arrays, taken as
    float32), decided on the host as apply_angle's and apply_gain's
    torch.where decides on the device: the same f32 values, |gain - 1|
    taken in f32, compared in f32 with SKIP."""
    a = np.asarray(angle, np.float32)
    g = np.asarray(gain, np.float32)
    skip = np.float32(SKIP)
    return ~(np.abs(a) < skip), ~(np.abs(g - np.float32(1.0)) < skip)


@dataclass(frozen=True)
class VertexPost:
    """One vertex's epilogue, resolved at build: whether it blends an
    effect's output with its input (a PLUGINFX whose wet passes its 1e-4
    gate), pans and gains (post_flags), and its device operands: the 0-d f32 wet,
    angle and gain the plain composition takes, and the pan factors [2]
    (pan_amps of the angle) the kernel takes. All of a graph's vertices
    share three [V] tensors and one [V, 2]."""
    blend: bool
    pan_on: bool
    gain_on: bool
    wet: torch.Tensor
    angle: torch.Tensor
    gain: torch.Tensor
    pan: torch.Tensor

    @property
    def launches(self) -> bool:
        """Whether it has anything to do: with no flag on its output is
        its input."""
        return self.blend or self.pan_on or self.gain_on


def vertex_post_work(y: torch.Tensor, x: torch.Tensor | None,
                     plan: VertexPost) -> tuple[float, float]:
    """(flops, bytes) of one vertex_post: an element takes 3 f32
    operations to blend, one to pan and one to gain; y (and x where it
    blends) is read and the output written once."""
    n = y.numel()
    flops = n * (3 * plan.blend + plan.pan_on + plan.gain_on)
    return float(flops), float(4 * n * (2 + plan.blend))


def _post_check(y, x, plan) -> None:
    if not plan.launches:
        raise ValueError("vertex_post: no flag is on, nothing to do (the "
                         "vertex's buffer is its input)")
    if not isinstance(y, torch.Tensor) or y.dim() != 2 or y.shape[1] != 2:
        raise ValueError(f"vertex_post: y must be a [T, 2] tensor, got "
                         f"{getattr(y, 'shape', type(y))}")
    named = [("y", y, tuple(y.shape))]
    if plan.blend:
        named.append(("x", x, tuple(y.shape)))
    named += [("wet", plan.wet, ()), ("angle", plan.angle, ()),
              ("gain", plan.gain, ()), ("pan", plan.pan, (2,))]
    for name, t, shape in named:
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise ValueError(f"vertex_post: {name} must be a tensor of shape "
                             f"{shape}")
        if t.device != y.device:
            raise ValueError(f"vertex_post: {name} on {t.device}, y on "
                             f"{y.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"vertex_post: {name} is {t.dtype}, expected "
                            "torch.float32")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vertex_post: unsupported device {y.device}")


@counted(vertex_post_work)
def vertex_post(y: torch.Tensor, x: torch.Tensor | None,
                plan: VertexPost) -> torch.Tensor:
    """A vertex's epilogue: y [T, 2] its arm's output, x [T, 2] its summed
    input (read only where plan.blend). CUDA tensors run
    csrc/vertex_post.cu, one launch, bit-equal to the plain composition
    on the card; CPU tensors the plain composition,
    post(x + wet * (y - x), angle, gain), or post(y, angle, gain) where it
    does not blend. A plan with no flag on, or anything else, raises."""
    global post_launches
    _post_check(y, x, plan)
    if y.device.type == "cpu":
        v = x + plan.wet * (y - x) if plan.blend else y
        return post(v, plan.angle, plan.gain)
    from ..kernels import vertex_post_launch

    y = y.contiguous()
    x = x.contiguous() if plan.blend else None
    out = torch.empty_like(y)
    vertex_post_launch(y, x, plan.pan, plan.wet, plan.gain, plan.blend,
                       plan.pan_on, plan.gain_on, out)
    post_launches += 1
    return out


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
