"""CLI entrypoint: python -m termdaw_tpu_torch [--device cuda|cpu] [workdir]

Counterpart of termdaw_tpu/cli.py (reference main.rs:38-135): reads
<wdir>/project.toml, prints the banner, builds the State on the asked
device (default `cuda`; an unavailable device is an error, never a
fallback), runs the project's make_assets.py if it has one (the shipped
examples' `import _gen` resolves to utils/example_assets.py), runs the
initial refresh, opens the audio sink and runs the configured workflow:
the manual one (workflows/ui.py: render, normalize, play and the time
controls) or the stream one (workflows/stream.py: floww packets on stdin;
TERMDAW_STREAM_IDLE=<seconds> ends it after that long without input).

Under a launcher that starts one process a rank (WORLD_SIZE > 1, with
RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT, as torchrun sets them),
each rank joins the process group (NCCL on `cuda:<local rank>`, gloo on
the CPU) and builds the State on its own device with that Mesh. Rank 0
runs the workflow; the others follow its refresh, render and normalize
commands (parallel/follow.py), so renders and scans shard across the
ranks (engine/state.py). A one-card host runs one rank.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch.distributed as dist

from .config import Config, WorkFlow
from .engine.sink import make_sink
from .utils.term import DEFAULT, BLUE, RED

from .device import resolve_device
from .engine.state import State
from .parallel import follow as follow_mod
from .parallel.mesh import mesh_from_env
from .workflows.stream import run_stream_workflow
from .workflows.ui import run_ui_workflow


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m termdaw_tpu_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on: cuda (default) or cpu")
    ap.add_argument("workdir", nargs="?", default="./")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    wdir = args.workdir
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"{RED}Error: {e}{DEFAULT}")
        return 1
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = mesh_from_env("nccl" if device.type == "cuda" else "gloo",
                             device.type)
        device = mesh.device
    try:
        config = Config.read(Path(wdir) / "project.toml")
    except (OSError, KeyError, ValueError) as e:
        print(f"{RED}Error: could not read project.toml: {e}{DEFAULT}")
        return 1

    print(
        f'{DEFAULT}TermDaw: loading {BLUE}"{config.project.name}"{DEFAULT} '
        f"with \n\tbuffer_length = {BLUE}{config.settings.buffer_length}"
        f"{DEFAULT} \n\tproject_samplerate = "
        f"{BLUE}{config.settings.project_samplerate}{DEFAULT} \n\tworkflow = "
        f"{BLUE}{config.settings.workflow}{DEFAULT} \n\tworkdir = "
        f"{BLUE}{wdir}{DEFAULT} \n\tmain = "
        f'{BLUE}"{config.settings.main}"{DEFAULT} \n\tdevice = '
        f"{BLUE}{device}{DEFAULT}"
    )
    # build-on-first-run assets: a project dir may ship a make_assets.py
    # that synthesizes its fixtures (idempotent by contract)
    gen = Path(wdir) / "make_assets.py"
    if gen.exists():
        _run_asset_hook(gen)

    main_path = Path(wdir) / config.settings.main
    if not main_path.exists():
        print(
            f'{RED}Error: could not open main lua file: {BLUE}"{main_path}"'
            f"{RED}.{DEFAULT}"
        )
        return 1

    state = State(config, wdir, device=device, mesh=mesh)
    state.refresh()
    if mesh is None:
        _run_workflow(config, state)
        return 0
    try:
        group = follow_mod.control_group()
        if mesh.rank != 0:
            follow_mod.follow(state, group)
            return 0
        leader = follow_mod.Leader(state, group)
        try:
            _run_workflow(config, leader)
        finally:
            leader.close()
    finally:
        dist.destroy_process_group()
    return 0


def _run_asset_hook(gen: Path) -> None:
    """Run a project's make_assets.py. The shipped examples' hooks do
    `import _gen; _gen.ensure()` (examples/_gen.py, which writes through
    the JAX package): while the hook runs, `_gen` is the port's copy
    (utils/example_assets.py) bound to the assets directory beside the
    project, where the examples' Lua reads `../assets/`. The previous
    `sys.modules["_gen"]` entry, or its absence, is restored after."""
    import runpy
    import types

    from .utils import example_assets

    assets = gen.parent.resolve().parent / "assets"
    shim = types.ModuleType("_gen", example_assets.__doc__)
    shim.ASSETS = assets
    shim.ensure = lambda: example_assets.ensure(assets)
    missing = object()
    prev = sys.modules.get("_gen", missing)
    sys.modules["_gen"] = shim
    try:
        runpy.run_path(str(gen), run_name="__main__")
    finally:
        if prev is missing:
            sys.modules.pop("_gen", None)
        else:
            sys.modules["_gen"] = prev


def _run_workflow(config: Config, state) -> None:
    proj_sr = config.settings.project_samplerate
    sink = make_sink(proj_sr)
    if config.settings.workflow == WorkFlow.MANUAL:
        run_ui_workflow(proj_sr, config.settings.buffer_length, state, sink)
    else:
        idle = os.environ.get("TERMDAW_STREAM_IDLE")
        run_stream_workflow(proj_sr, config.settings.buffer_length, state,
                            sink, max_idle_s=float(idle) if idle else None)


if __name__ == "__main__":
    raise SystemExit(main())
