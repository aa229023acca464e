"""Each cell of the benchmark, run end to end on the CPU at tiny sizes,
ends in a well-formed result line; the harness refuses to run without
the card, without the program, or with JAX loaded."""

from __future__ import annotations

import json
import shutil

import pytest

from conftest import KEPT, ROOT, last_json, run_cli

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
KEPT_CELLS = [w["name"] for w in KEPT["workloads"] if w["name"] not in CELLS]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS + KEPT_CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_bench_cell_prints_a_contract_line(tiny_kept, cell, trace):
    bench = json.loads((tiny_kept / "BENCHMARK.json").read_text())
    r = run_cli(tiny_kept, "--workload", cell, "--seed", "3000000017",
                "--seconds", "1.5", "--trace", str(trace), "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    line = last_json(r.stdout)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    kind = "per_layer" if trace else "end_to_end"
    for m in bench[kind]:
        applies = "workloads" not in m or cell in m["workloads"]
        if not applies:
            assert m["name"] not in line["metrics"]
        elif not trace or m["source"] != "device_trace":
            # device readings are absent on the CPU, the rest are there
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the checks are also the last lines of stderr, each with its limit
    tail = r.stderr.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), tail):
        assert text.startswith(f"check {name} = ") and "limit" in text


def test_bench_unlisted_live_loop_runs_correct(drive):
    """The live loop, kept for a later cell (PERF.md, Open questions),
    still drives the stream workflow to a correct result."""
    checks, ok = drive("c5_stream64.live", 1.5)
    assert ok, checks


def test_bench_refuses_without_a_card(tiny):
    r = run_cli(tiny, "--workload", CELLS[0], "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert r.returncode == 2 and r.stdout.strip() == ""


def test_bench_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--device", "cpu"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_bench_refuses_with_jax_loaded(tiny_kept, tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "jax.py").write_text("")
    (site / "sitecustomize.py").write_text("import jax\n")
    import os

    r = run_cli(tiny_kept, "--workload", "c5_stream64.bounce", "--seed", "1",
                "--seconds", "1", "--trace", "0", "--device", "cpu",
                env_extra={"PYTHONPATH": f"{site}{os.pathsep}{ROOT}"})
    assert r.returncode == 3 and r.stdout.strip() == ""
    assert "jax" in r.stderr


@pytest.mark.parametrize("loaded,blocked", [
    ({"termdaw_tpu_torch": 1, "termdaw_tpu_torch.graph": 1}, []),
    ({"termdaw_tpu": 1, "termdaw_tpu_torch": 1}, ["termdaw_tpu"]),
    ({"termdaw_tpu.ops.fx": 1}, ["termdaw_tpu.ops.fx"]),
    ({"jaxtyping": 1, "flax_like": 1}, []),
    ({"jax": 1, "jaxlib.xla": 1, "flax.linen": 1},
     ["flax.linen", "jax", "jaxlib.xla"]),
])
def test_bench_jax_check_is_whole_word(loaded, blocked):
    from benchmark.harness.contract import blocked_modules

    assert blocked_modules(loaded) == blocked


@pytest.mark.cuda
def test_bench_cell_on_card(tiny):
    """One short run of the first cell on the card, with its checks."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run_cli(tiny, "--workload", CELLS[0], "--seed", "3000000019",
                "--seconds", "2", "--trace", "0")
    assert r.returncode == 0, r.stderr[-3000:]
    line = last_json(r.stdout)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
