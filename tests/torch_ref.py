"""What the mirrors of the reference's behaviour suites
(tests/test_torch_ref_*.py) share: the device parameter, the check of
which hand-written kernels a case launched, and the device-to-host read.

Imports nothing of JAX or termdaw_tpu, so the mirrors run where only the
port is installed (the card's machine): `python -m pytest -m cuda
tests/test_torch_ref_<suite>.py`."""

import contextlib
import gc

import numpy as np
import pytest
import torch

from termdaw_tpu_torch.graph.compile import _kernel_counts

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def device(request):
    """`cpu` always; `cuda` on a card (marked `cuda`, skipped without)."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(request.param)


@contextlib.contextmanager
def launched(device, *kernels):
    """The body's hand-written kernel launches (names of
    graph.compile._kernel_counts): on the card exactly `kernels` must
    have launched, on the CPU none (the wrappers run the plain versions
    there). A captured program counts its warm-up and capture, not its
    replays."""
    before = _kernel_counts()
    yield
    grew = {k for k, v in _kernel_counts().items() if v > before[k]}
    want = set(kernels) if device.type == "cuda" else set()
    assert grew == want, f"kernels launched {sorted(grew)}, expected " \
                         f"{sorted(want)}"


def host(x) -> np.ndarray:
    """A render's audio (a device tensor) as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pool_segment_bytes(pool) -> int:
    """Bytes the card's allocator still holds in the graph memory pool
    `pool` (a CompiledGraph's `_graph_pool` handle), after the cached
    blocks of released pools are returned to the device."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool))


def captured_programs(cg) -> list:
    """cg's program-cache entries; on the card each must hold its
    captured CUDAGraph (a failed or skipped capture leaves none)."""
    progs = cg.programs()
    if cg.device.type == "cuda":
        assert all(p.graph is not None for p in progs), \
            "a program of the card ran without its captured graph"
    return progs
