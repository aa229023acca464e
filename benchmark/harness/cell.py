"""A cell's pieces, found by the names in BENCHMARK.json: the workload,
its configuration file, its traffic file and the modules they name
(projects/<project>.py, loops/<loop>.py, metrics/<metric>.py). Nothing
here knows a particular cell: a new one is new files and entries."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]   # benchmark/
ROOT = HERE.parent                           # the checkout


def load_module(path: Path, name: str):
    """Import the file at `path` as module `name` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def project_module(name: str):
    """projects/<name>.py as a submodule of the `benchmark.projects`
    package, so that its relative imports resolve."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"benchmark.projects.{name}")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def find(name: str, bench_path: Path | None = None) -> Cell:
    """The cell `name` of a BENCHMARK.json (by default the one beside the
    benchmark folder), its configuration and traffic files read from the
    checkout that file sits in."""
    bench_path = Path(bench_path or ROOT / "BENCHMARK.json")
    bench = json.loads(bench_path.read_text())
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in {bench_path}; "
                       f"known: {sorted(wl)}")
    w, root = wl[name], bench_path.parent
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / cfgs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())

    def applies(m: dict) -> bool:
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, w, config, traffic,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def metric_reader(name: str):
    """metrics/<name>.py's `read(run) -> float | None`."""
    path = HERE / "metrics" / f"{name}.py"
    return load_module(path, f"_bench_metric_{name}").read


def loop_module(name: str):
    return load_module(HERE / "loops" / f"{name}.py", f"_bench_loop_{name}")


def limits(cell: str) -> dict:
    """limits/<cell>.json: each number the check compares, with its
    limit (PERF.md gives the readings each was set from)."""
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())
