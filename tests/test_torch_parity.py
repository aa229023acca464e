"""The port's parity report (termdaw_tpu_torch/tools/parity_report.py) as
a user runs it: `python -m termdaw_tpu_torch.tools.parity_report` in a
child process in which jax and the JAX package cannot be imported
(fixtures.alone_argv, which also fails the child if any of their modules
was loaded). On the CPU it writes every toy entry, each within its gate
(parity_report.GATES, the oracle tests' tolerances, and the drift
ceilings set from the readings; config5 on the fused voice-mix path),
and exits 0; asked for a card where there is none, it
exits non-zero with an `error`."""

import json
import subprocess
from pathlib import Path

import pytest
import torch

from termdaw_tpu_torch.tools import parity_report as P
from termdaw_tpu_torch.utils.fixtures import alone_argv

from .conftest import scrubbed_env

REPO = Path(__file__).resolve().parents[1]
TOY = [name for name, _, _ in P.TOY]


def _run(*args, timeout=300):
    proc = subprocess.run(
        alone_argv("termdaw_tpu_torch.tools.parity_report", *args),
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=scrubbed_env(OMP_NUM_THREADS="1"))
    lines = proc.stdout.strip().splitlines()
    return proc, json.loads(lines[-1]) if lines else None


def test_parity_report_on_cpu_within_gates(tmp_path):
    out = tmp_path / "PARITY_test.json"
    proc, report = _run("test", "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert json.loads(out.read_text()) == report
    assert report["device"] == "cpu"
    assert [k for k in report if k.startswith("config")] == TOY
    assert P.gate_failures(report, TOY) == []
    assert report["config5_multitrack_fused"]["fused_kernel"] is True
    for name in TOY:
        assert report[name]["isolated_boundary_race_frames"] == 0


def test_parity_report_needs_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc, report = _run("--device", "cuda", "--out",
                        str(tmp_path / "p.json"), timeout=120)
    assert proc.returncode != 0
    assert "is_available() is false" in report["error"]
    assert not (tmp_path / "p.json").exists()


def test_gate_failures_names_each_fault():
    ok = {"max_err": 1e-7, "fused_kernel": True}
    report = {"config1_sampleloops": ok,
              "config2_negadsr": {"max_err": 1e-3},
              "config3_synths_bandpass": {"error": "RuntimeError: x"},
              # inside the oracle test's 2e-3, as half floats would be,
              # but 40 dB over the reading
              "config3_full_48k": {"max_err": 1e-4},
              "config5_multitrack_fused": {"max_err": 1e-7,
                                           "fused_kernel": False}}
    bad = P.gate_failures(report, [*report, "config1_full_48k"])
    assert [b.split(":")[0] for b in bad] == [
        "config2_negadsr", "config3_synths_bandpass", "config3_full_48k",
        "config5_multitrack_fused", "config1_full_48k"]
    assert "drift ceiling -104.6 dBFS" in bad[2]
    assert P.gate_failures(report, ["config1_sampleloops"]) == []


def test_drift_ceilings_lie_inside_the_gates():
    assert P.DRIFT_CEILING_DBFS.keys() == P.GATES.keys()
    for name, ceiling in P.DRIFT_CEILING_DBFS.items():
        assert 10.0 ** (ceiling / 20.0) < P.GATES[name] / 10.0, name
