"""Ranks, collectives and the sharded render entry point.

Port of termdaw_tpu/parallel/mesh.py:1-35. The reference drives a 1-D
`jax.sharding.Mesh` from one process through `shard_map`; the port runs
one process per rank on `torch.distributed` (one host thread dispatching
to several cards would multiply the host dispatch that sets the walls),
and each rank holds its own `State` of the same project on its own
device:

* `Mesh` is a rank's view of the default process group: its rank, the
  world size, its device and the backend, plus the count and host seconds
  of the collectives it ran. A `State` shards only when its caller hands
  it a Mesh (engine/state.py). `make_mesh` builds it from an initialised
  process group; `mesh_from_env` initialises one from a launcher's
  RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT first;
  `launch` spawns the ranks itself (`torch.multiprocessing`, the `spawn`
  start method, a TCP store on 127.0.0.1 at a free port, a timeout).
* Transport and device are the caller's choice, never a fallback: NCCL
  with a card for each rank (`cuda:<local rank>`); gloo on the CPU; gloo
  with every rank on `cuda:0` only when the caller asks for the shared
  card (`share_device=True`; NCCL refuses two ranks on one card).
* The render's collectives are the list form of `dist.all_gather`
  (`all_gather`, stacked to [n, *shape]), `dist.all_reduce` with MAX
  (`pmax`) and, for the audio only rank 0 writes, `dist.gather` to rank 0
  (`gather`), which gloo and NCCL all carry.
* `sharded_render` (mesh.py:24-35) renders blocks from the current time
  as one sharded window, after `seed_caps(..., prebake=False)`: a sharded
  window bakes live, so a stored chain could never be served.

A failure in any rank fails the whole `launch`: the other ranks are
stopped and the error is raised in the caller. No rank carries on alone
after a collective fails.
"""

from __future__ import annotations

import os
import socket
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclass
class Mesh:
    rank: int
    size: int
    device: torch.device
    backend: str
    # collectives run through all_gather / pmax / gather, and the host
    # seconds they took (with NCCL the host only enqueues them)
    collective_calls: int = 0
    collective_s: float = 0.0


def make_mesh(device: str | torch.device) -> Mesh:
    """This rank's Mesh over the initialised default process group,
    rendering on `device`."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no torch.distributed process group "
                           "is initialised")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(),
                device=torch.device(device), backend=str(dist.get_backend()))


def _check_transport(backend: str, dev_type: str, share_device: bool,
                     n_ranks: int) -> None:
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use 'nccl' or 'gloo'")
    if dev_type not in ("cpu", "cuda"):
        raise ValueError(f"device type {dev_type!r}: use 'cuda' or 'cpu'")
    if dev_type == "cpu" and backend != "gloo":
        raise ValueError("CPU ranks need the gloo backend")
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA ranks requested but "
                               "torch.cuda.is_available() is false")
        if share_device and backend == "nccl":
            raise ValueError("NCCL refuses two ranks on one card: share a "
                             "card over gloo")
        if not share_device and torch.cuda.device_count() < n_ranks:
            raise RuntimeError(
                f"{n_ranks} ranks need {n_ranks} cards, "
                f"{torch.cuda.device_count()} visible (share_device=True "
                "puts every rank on cuda:0 over gloo)")


def _rank_device(dev_type: str, share_device: bool,
                 local_rank: int) -> torch.device:
    if dev_type == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", 0 if share_device else local_rank)
    torch.cuda.set_device(dev)
    return dev


def mesh_from_env(backend: str, device: str = "cuda") -> Mesh:
    """Initialise the process group from a launcher's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, as torchrun sets
    them) and return this rank's Mesh, on `cuda:<local rank>` or the
    CPU."""
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev_type = torch.device(device).type
    _check_transport(backend, dev_type, False, n)
    dev = _rank_device(dev_type, False,
                       int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=n)
    return make_mesh(dev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, fn: Callable, args: tuple, backend: str,
               dev_type: str, share_device: bool, port: int,
               timeout_s: float, queue) -> None:
    timeout = timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", port, n, rank == 0, timeout=timeout)
    dev = _rank_device(dev_type, share_device, rank)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=timeout)
    try:
        mesh = make_mesh(dev)
        out = fn(mesh, *args)
        # every rank is past its last collective before any leaves (rank
        # 0 holds the store the others still read)
        pmax(torch.zeros((), device=dev), mesh)
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_ranks: int, *args, backend: str,
           device: str = "cuda", share_device: bool = False,
           timeout_s: float = 600.0) -> list:
    """Run `fn(mesh, *args)` in `n_ranks` spawned processes, one rank
    each, and return what each returned, in rank order. `fn` must be
    importable by its module path (a module-level function) and return a
    picklable host value. Ranks render on `cuda:<rank>`, on `cuda:0` for
    all when `share_device`, or on the CPU (`device="cpu"`, gloo). Any
    rank's failure, or `timeout_s` passing, stops every rank and raises
    here."""
    if n_ranks < 1:
        raise ValueError(f"launch: n_ranks must be >= 1, got {n_ranks}")
    dev_type = torch.device(device).type
    _check_transport(backend, dev_type, share_device, n_ranks)
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, args=(n_ranks, fn, args, backend, dev_type, share_device,
                          _free_port(), timeout_s, queue),
        nprocs=n_ranks, join=False, start_method="spawn")
    results: dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        done = False
        while not done:
            # drain before joining: a rank blocks in put() until read
            while not queue.empty():
                r, out = queue.get()
                results[r] = out
            done = ctx.join(timeout=0.1)
            if not done and time.monotonic() > deadline:
                raise TimeoutError(f"launch: {n_ranks} ranks did not end "
                                   f"within {timeout_s} s")
        while not queue.empty():
            r, out = queue.get()
            results[r] = out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    missing = sorted(set(range(n_ranks)) - set(results))
    if missing:
        raise RuntimeError(f"launch: ranks {missing} returned no result")
    return [results[r] for r in range(n_ranks)]


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x stacked in rank order, [n, *x.shape], on every
    rank."""
    t0 = time.perf_counter()
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x)
    res = torch.stack(out)
    mesh.collective_calls += 1
    mesh.collective_s += time.perf_counter() - t0
    return res


def gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor | None:
    """Every rank's x stacked in rank order, [n, *x.shape], on rank 0;
    None on the other ranks."""
    t0 = time.perf_counter()
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)] \
        if mesh.rank == 0 else None
    dist.gather(x, out, dst=0)
    res = torch.stack(out) if out is not None else None
    mesh.collective_calls += 1
    mesh.collective_s += time.perf_counter() - t0
    return res


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of x over the ranks, on every rank."""
    t0 = time.perf_counter()
    out = x.clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    mesh.collective_calls += 1
    mesh.collective_s += time.perf_counter() - t0
    return out


def sharded_render(state, nb_total: int, mesh: Mesh) -> torch.Tensor:
    """Render `nb_total` blocks of `state`'s compiled graph across the
    ranks, from the current time, as one sharded window (nb_total must be
    a multiple of the world size). Returns the window's audio
    [nb_total*bl, 2] on every rank."""
    cg = state.compiled
    state.fb.set_time(cg.get_time())
    cg.seed_caps(state.fb, max(state.cs, nb_total), nb_total, prebake=False)
    local = cg.render_window_sharded(state.fb, nb_total, mesh)
    state.fb.advance_blocks(nb_total)
    return all_gather(local, mesh).reshape(-1, 2)
