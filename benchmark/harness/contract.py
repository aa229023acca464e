"""The run's last line and the checks beside it."""

from __future__ import annotations

import json
import sys

BLOCKED = ("jax", "jaxlib", "flax", "termdaw_tpu")


def blocked_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is, as a whole word, one that
    no run may load (the program's name begins with the JAX package's, so
    a prefix test would be wrong)."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in BLOCKED)


def device_info(device_type: str, chips: int, peak_bytes: int) -> dict:
    if device_type == "cuda":
        import torch

        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
