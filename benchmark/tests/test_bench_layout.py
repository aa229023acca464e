"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files and entries only: the harness finds them by
name, and no file it already has is edited."""

from __future__ import annotations

import hashlib
import json

from conftest import last_json, run_cli


def digest(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_bench_new_cell_is_found_from_new_files(tiny):
    before = digest(tiny)
    b = tiny / "benchmark"
    cfg = json.loads((b / "configs" / "c5_stream64.json").read_text())
    cfg.update({"name": "c5_stream8", "tracks": 8})
    (b / "configs" / "c5_stream8.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "bounce.json").read_text())
    mix["what"] = "the bounce loop under another name"
    (b / "traffic" / "bounce_short.json").write_text(json.dumps(mix))
    (b / "limits" / "c5_stream8.bounce_short.json").write_text(
        json.dumps({"frames_off": 0, "bounces_off": 0, "max_err_fs": 2e-5}))
    (b / "metrics" / "bounces.bounce.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "c5_stream8", "source": cfg["source"],
        "file": "benchmark/configs/c5_stream8.json", "reduced": [],
        "why": "a smaller mix"})
    bench["workloads"].append({
        "name": "c5_stream8.bounce_short", "config": "c5_stream8",
        "traffic": "bounce_short", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "bounce_xrt":
            m["workloads"].append("c5_stream8.bounce_short")
    bench["per_layer"].append({
        "name": "bounces.bounce", "unit": "bounces", "better": "higher",
        "source": "host_clock", "layer": "bounce loop",
        "moves": "bounce_xrt", "workloads": ["c5_stream8.bounce_short"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(tiny)
    assert {k: after[k] for k in before} == before   # nothing edited
    for trace, key in ((0, "bounce_xrt"), (1, "bounces.bounce")):
        r = run_cli(tiny, "--workload", "c5_stream8.bounce_short", "--seed",
                    "5", "--seconds", "1", "--trace", str(trace),
                    "--device", "cpu")
        assert r.returncode == 0, r.stderr[-3000:]
        line = last_json(r.stdout)
        assert line["correct"] is True and key in line["metrics"]
