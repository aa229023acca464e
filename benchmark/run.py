"""Run one cell of the benchmark once and print the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
are found by name in BENCHMARK.json (benchmark/harness/cell.py). The run
writes the cell's project from its configuration and the seed into a
fresh directory under TMPDIR, loads it into the program
(termdaw_tpu_torch), warms up the shapes the cell uses (set-up), drives
the cell's loop (benchmark/loops/<loop>.py) for `--seconds`, checks what
the window produced against the plain reference (benchmark/reference)
and prints one JSON line: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, `breakdown` (traced runs) and `checks` (each number compared
with its limit, also the last lines on stderr). The engine's own prints
go to stderr.

It needs as many CUDA cards as the cell asks for, and exits 2 without a
result where there are fewer. It exits 3 without a result where any
module of JAX or of the JAX package (`termdaw_tpu`) was loaded.
`--device cpu` runs the same steps on the CPU, for the benchmark's own
tests; its numbers are not device numbers.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the build and kernel caches live at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import contract  # noqa: E402
from benchmark.harness.spans import Spans  # noqa: E402
from benchmark.harness.trace import Tracer  # noqa: E402


class Run:
    """What a loop reads and fills: the cell, the seed, the device, the
    work directory, the spans and the tracer; the loop sets `state`,
    `spec`, `attempted`, `failed`, `e2e` (end-to-end values by metric
    name) and whatever its metric readers and check need."""

    def __init__(self, cell, seed: int, device, workdir: Path,
                 tracer: Tracer, spans: Spans) -> None:
        self.cell = cell
        self.seed = seed
        self.device = device
        self.device_type = device.type
        self.workdir = workdir
        self.tracer = tracer
        self.spans = spans
        self.state = None
        self.spec: dict = {}
        self.attempted = 0
        self.failed = 0
        self.e2e: dict = {}
        self.counters: dict = {}
        self.trace = None
        self.setup_s = 0.0
        self.seconds = 0.0


def _parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    cell = cells.find(args.workload)
    import torch

    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA card(s), found "
                  f"{have}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    code, result = execute(cell, device, args.seed, args.seconds,
                           bool(args.trace))
    if result is not None:
        contract.print_checks(result["checks"])
        print(contract.result_line(**result), flush=True)
    return code


def execute(cell, device, seed: int, seconds: float,
            trace: bool) -> tuple[int, dict | None]:
    """One run of `cell` on `device`: set-up, the window, the JAX check,
    the trace's reduction, the program's state freed, the check against
    the reference, then the metrics. Returns (0, the result line's
    fields) or (an exit code, None)."""
    import torch

    import termdaw_tpu_torch  # noqa: F401  (the program under test)

    loop = cells.loop_module(cell.traffic["loop"])
    spans = Spans()
    tracer = Tracer(loop.TRACED_UNITS if trace else 0, device.type, spans)
    workdir = Path(tempfile.mkdtemp(prefix="bench_run_"))
    run = Run(cell, seed, device, workdir, tracer, spans)
    run.seconds = seconds
    run.device_kind = (torch.cuda.get_device_name(0)
                       if device.type == "cuda" else "cpu")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            loop.setup(run)
            run.setup_s = time.perf_counter() - T_START
            tracer.prime()
            loop.window(run, seconds)
            tracer.close()
            peak = (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0)
            if _jax_loaded():
                return 3, None
            run.trace = tracer.reduce()
            spans.unwrap()
            loop.release(run)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            checks = loop.check(run)
    finally:
        spans.unwrap()
        shutil.rmtree(workdir, ignore_errors=True)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    run.e2e["setup_s"] = run.setup_s
    metrics: dict = {}
    breakdown = None
    dev = contract.device_info(device.type, cell.chips, peak)
    if trace:
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if device.type == "cuda" and (run.trace is None
                                      or run.trace.busy_s <= 0):
            print("the traced window holds no device work", file=sys.stderr)
            return 4, None
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            dev["window_s"] = run.trace.window_s
            breakdown = run.trace.breakdown()
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(run.e2e[m["name"]]),
                                  "unit": m["unit"]}
    if _jax_loaded():
        return 3, None
    return 0, {"correct": correct, "attempted": run.attempted,
               "failed": run.failed, "metrics": metrics, "device": dev,
               "checks": checks, "breakdown": breakdown}


def _jax_loaded() -> bool:
    bad = contract.blocked_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
    return bool(bad)


if __name__ == "__main__":
    sys.exit(main())
