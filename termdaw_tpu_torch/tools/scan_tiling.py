"""Device time of the tiled scan kernels (csrc/scan_tile.cuh) at the
shapes of a c3/c4 window under several run lengths, beside the one
kernels.scan_plan picks. Needs a CUDA card:

    python3 -m termdaw_tpu_torch.tools.scan_tiling

Prints the card (nvidia-smi name and power limit), then one JSON line a
shape: for each run length K the tiles along the timeline, the kernels a
call launches and the device ms per call (torch.profiler over 40 calls
after a warm-up), with the plan's K marked. The runs go through the
kernels' launchers directly, so the wrappers' host time is not in them.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from .. import kernels

# (name, [T, C], planes, run lengths tried besides the plan's)
SHAPES = (
    ("eq3_stage", (384000, 4), 2, (7, 15)),
    ("band_pass", (384000, 4), 1, (15, 47)),
    ("damping", (384000, 2), 1, (7, 31)),
    ("smoothing", (384000, 1), 1, (3, 15)),
    ("comb_1785", (216, 1785), 1, (15, 27)),
    ("comb_1215", (317, 1215), 1, (15, 40)),
    ("allpass_605", (635, 1210), 1, (15, 31)),
    ("allpass_245", (1568, 490), 1, (15, 31)),
    ("delay", (67, 11520), 1, (5,)),
)


def device_ms(fn, reps: int = 40) -> tuple[float, float]:
    """(device ms per call, device kernels per call) of fn."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.device_time_total for e in rows) / 1e3 / reps,
            len(rows) / reps)


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_tiling: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    cuda = torch.device("cuda", 0)
    launchers = {1: kernels.affine_scan_lib().affine_scan_launch,
                 2: kernels.complex_scan_lib().complex_scan_launch}
    rng = np.random.default_rng(0)
    for name, (T, C), planes, ks in SHAPES:
        plan = kernels.scan_plan(T, C, planes)
        x = [torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32))
             .to(cuda) for _ in range(planes)]
        # a, y0 or p_r, p_i, s_r, s_i: a stable pole, a zero state
        lanes = [torch.full((C,), v, device=cuda)
                 for v in ((0.9, 0.0) if planes == 1 else
                           (0.9, 0.1, 0.0, 0.0))]
        y = [torch.empty_like(x[0]) for _ in range(planes)]
        stream = torch.cuda.current_stream().cuda_stream
        runs = {}
        for k in sorted({plan.k, *ks}):
            tiles = -(-T // ((kernels.SCAN_THREADS // plan.cl) * k))
            scratch = torch.empty(max(1, planes * tiles * C), device=cuda)
            # the launcher's order: inputs, lanes, outputs, scratch
            ptrs = [t.data_ptr() for t in (*x, *lanes, *y, scratch)]
            launch = launchers[planes]

            def call():
                rc = launch(*ptrs, T, C, plan.cl, k, stream)
                if rc:
                    raise RuntimeError(f"{name} K={k}: CUDA error {rc}")

            ms, n = device_ms(call)
            runs[f"K={k}"] = {"tiles": tiles, "kernels": n, "ms": ms,
                              "plan": k == plan.k}
        print(json.dumps({"shape": name, "T": T, "C": C, "planes": planes,
                          "cl": plan.cl, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
