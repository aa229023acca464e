"""Shared pieces of the benchmark's own tests: the `cuda` marker, a tiny
copy of the benchmark, and a run driven in this process."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny sizes for the CPU: short songs, few tracks, a slow live stream
TINY = {
    "configs": {"c4_fullgraph": {"length_s": 4.0},
                "c5_stream64": {"length_s": 4.0, "tracks": 6}},
    "traffic": {"live": {"packet_rate_hz": 30.0, "warmup_s": 0.5}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


# cells whose files the benchmark keeps without listing them in
# BENCHMARK.json (PERF.md, Open questions); the tests' copy lists them
KEPT = {
    "configs": [{"name": "c5_stream64", "source": "kept for a later cell",
                 "file": "benchmark/configs/c5_stream64.json",
                 "reduced": ["length_s"], "why": "kept for a later cell"}],
    "workloads": [{"name": n, "config": n.split(".")[0], "traffic": t,
                   "chips": 1, "why": "kept for a later cell"}
                  for n, t in (("c5_stream64.live", "live"),
                               ("c5_stream64.bounce", "bounce"),
                               ("c4_fullgraph.refresh", "refresh"))],
}


def tiny_copy(dest: Path, kept: bool = False) -> Path:
    """BENCHMARK.json and benchmark/ copied into dest, at TINY sizes;
    `kept` also lists the KEPT cells in the copy's BENCHMARK.json."""
    dest = Path(dest)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if kept:
        for key, entries in KEPT.items():
            have = {e["name"] for e in bench[key]}
            bench[key] += [e for e in entries if e["name"] not in have]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for kind, entries in TINY.items():
        for name, over in entries.items():
            p = dest / "benchmark" / kind / f"{name}.json"
            data = json.loads(p.read_text())
            data.update(over)
            p.write_text(json.dumps(data))
    return dest


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_copy(tmp_path)


@pytest.fixture(scope="session")
def tiny_kept(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("tiny_kept"), kept=True)


def run_cli(root: Path, *args: str, env_extra: dict | None = None,
            timeout: float = 900) -> subprocess.CompletedProcess:
    """benchmark/run.py of the copy at root, with the program importable;
    one compute thread a process, since the test workers run side by
    side."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           **(env_extra or {})}
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def drive(tiny_kept):
    """drive(cell, seconds, seed): the cell of the tests' copy (TINY
    sizes, the KEPT cells listed) run on the CPU in this process through
    run.py's own sequence, the look for a card skipped, so that a test
    can break the program underneath. Returns the checks and `correct`."""
    import torch

    from benchmark import run as bench_run
    from benchmark.harness import cell as cells

    def go(cell_name: str, seconds: float, seed: int = 7):
        torch.set_num_threads(1)  # the test workers run side by side
        c = cells.find(cell_name, tiny_kept / "BENCHMARK.json")
        code, result = bench_run.execute(c, torch.device("cpu"), seed,
                                         seconds, trace=False)
        assert code == 0 and result is not None
        return result["checks"], result["correct"]

    return go
