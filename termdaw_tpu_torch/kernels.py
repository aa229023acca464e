"""Build and bind the port's CUDA kernels (nvcc + ctypes).

Each `csrc/*.cu` file exports a plain `extern "C"` launcher. At first use
it is compiled with nvcc for Hopper (`sm_90a`) into a shared library under
`termdaw_tpu_torch/build/`, named by a hash of its source and the shared
headers (`csrc/*.cuh`), and loaded with ctypes; `build_all` compiles
several sources in parallel. Nothing is built when the module is
imported, so the CPU tests can import everything without nvcc.

The two tiled scans (affine_scan.cu, complex_scan.cu on
csrc/scan_tile.cuh) take their tiling from `scan_plan`, and their
scratch planes from the launch functions here.

nvcc is looked up in `$CUDA_HOME/bin`, then `/usr/local/cuda/bin`, then
`PATH`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# every csrc/<name>.cu of the port
KERNELS = ("voice_mix", "affine_scan", "max_decay_scan", "complex_scan")

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA toolkit is needed to build the port's kernels"
    )


def _lib_path(name: str) -> Path:
    """build/lib<name>-<hash>.so, the hash over csrc/<name>.cu, every
    csrc/*.cuh (any of them may be included) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, Path]:
    """Compile each csrc/<name>.cu into build/lib<name>-<hash>.so unless
    that file exists, one nvcc process per source, all started together;
    returns the paths. The compiler's output (ptxas register and
    shared-memory counts) is kept beside each library as a .log file."""
    libs = {name: _lib_path(name) for name in names}
    procs = {}
    for name, lib in libs.items():
        if lib.exists() or name in procs:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu (exit "
                          f"{proc.returncode}):\n{out}")
            continue
        libs[name].with_suffix(".log").write_text(out)
        # atomic: a concurrent build never sees a partial file
        os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """build_all for one source."""
    return build_all([name])[name]


def _load(name: str, fn_name: str, argtypes: list) -> ctypes.CDLL:
    """The built csrc/<name>.cu, loaded once, with its launcher's argtypes
    declared (c_void_p for every pointer and the stream, so none is cut to
    32 bits) and an int return code."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def voice_mix_lib() -> ctypes.CDLL:
    vp = ctypes.c_void_p
    return _load("voice_mix", "voice_mix_stereo_launch",
                 [vp, ctypes.c_longlong, vp, vp, vp, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, vp, vp])


def affine_scan_lib() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load("affine_scan", "affine_scan_launch",
                 [vp] * 5 + [ctypes.c_longlong, ci, ci, ci, vp])


def max_decay_scan_lib() -> ctypes.CDLL:
    vp = ctypes.c_void_p
    return _load("max_decay_scan", "max_decay_scan_launch",
                 [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp])


def complex_scan_lib() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load("complex_scan", "complex_scan_launch",
                 [vp] * 9 + [ctypes.c_longlong, ci, ci, ci, vp])


SCAN_THREADS = 256            # scan_tile.cuh kThreads
SCAN_SHARED_BYTES = 48 * 1024  # scan_tile.cuh kSharedBytes
_WIDE_MAP_BYTES = {1: 16, 2: 32}  # sizeof(Op::DMap): affine, complex


class ScanPlan(NamedTuple):
    """How csrc/scan_tile.cuh cuts a [T, C] scan into tiles."""
    cl: int          # lanes per tile: the power of two >= C, at most 32
    k: int           # frames per run, one thread's share of one lane
    s: int           # frames per tile, (SCAN_THREADS // cl) * k
    tiles: int       # tiles along the timeline
    lane_tiles: int  # tiles across the lanes
    smem: int        # dynamic shared memory per CTA, bytes
    scratch: int     # scratch floats (0 with one tile along the timeline)


@functools.lru_cache(maxsize=256)
def scan_plan(T: int, C: int, planes: int) -> ScanPlan:
    """The tiling of a scan with `planes` input planes (1 affine, 2
    complex), as measured fastest on an H100 (PERF.md). Below 32
    lanes runs are odd, so the threads of a warp, K * CL floats apart in
    shared memory, fall on 32 different banks. A timeline of at most 16
    frames a run is one tile, one kernel (the delay line's 67 rows).
    Longer ones are cut into tiles of about 2048 frames for at most 4
    lanes (runs of 8 * CL - 1 frames, fewer where shared memory ends)
    and runs of 7 frames for wider rows, combined reduce-then-scan with
    planes * tiles * C floats of scratch."""
    cl = 1
    while cl < C and cl < 32:
        cl *= 2
    runs = SCAN_THREADS // cl
    totals = 8 * cl * _WIDE_MAP_BYTES[planes]  # WarpTotals, static
    k_max = (SCAN_SHARED_BYTES - totals) // (SCAN_THREADS * 4 * planes)
    k_max -= 1 - k_max % 2
    k = -(-T // runs)
    if k > 16:
        k = min(8 * cl - 1, k_max) if cl <= 4 else 7
    elif cl < 32:
        k |= 1
    s = runs * k
    tiles = -(-T // s)
    return ScanPlan(cl, k, s, tiles, -(-C // cl),
                    SCAN_THREADS * k * 4 * planes,
                    planes * tiles * C if tiles > 1 else 0)


def _scratch(plan: ScanPlan, like: torch.Tensor):
    """The plan's scratch floats on `like`'s device and the pointer to
    pass (None, None without scratch). The caller holds the buffer until
    the launch is queued; the caching allocator orders its reuse after
    the kernels on the same stream."""
    if not plan.scratch:
        return None, None
    buf = torch.empty(plan.scratch, dtype=torch.float32, device=like.device)
    return buf, buf.data_ptr()


def voice_mix_launch(
    sample_padded: torch.Tensor, begins: torch.Tensor, amp_l: torch.Tensor,
    amp_r: torch.Tensor, out: torch.Tensor, nb: int, bl: int,
) -> None:
    """Launch csrc/voice_mix.cu on the tensors' device and current stream.
    The caller (ops/voices.voice_mix_stereo) has checked devices, dtypes,
    shapes and contiguity; raises if the launch is refused."""
    lib = voice_mix_lib()
    with torch.cuda.device(out.device):
        rc = lib.voice_mix_stereo_launch(
            sample_padded.data_ptr(), sample_padded.shape[1],
            begins.data_ptr(), amp_l.data_ptr(), amp_r.data_ptr(), nb,
            begins.shape[1], bl, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"voice_mix kernel launch failed: CUDA error {rc}")


def affine_scan_launch(b: torch.Tensor, a: torch.Tensor, y0: torch.Tensor,
                       y: torch.Tensor) -> None:
    """Launch csrc/affine_scan.cu on the tensors' device and current
    stream, with the tiling of scan_plan and its scratch. The caller
    (ops/scan.affine_scan) has checked devices, dtypes, shapes and
    contiguity; raises if the launch is refused."""
    lib = affine_scan_lib()
    T, C = b.shape
    plan = scan_plan(T, C, 1)
    with torch.cuda.device(y.device):
        scratch, ptr = _scratch(plan, y)
        rc = lib.affine_scan_launch(
            b.data_ptr(), a.data_ptr(), y0.data_ptr(), y.data_ptr(), ptr,
            T, C, plan.cl, plan.k, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"affine_scan kernel launch failed: CUDA error {rc}")


def max_decay_scan_launch(x: torch.Tensor, r: torch.Tensor, y0: torch.Tensor,
                          y: torch.Tensor) -> None:
    """Launch csrc/max_decay_scan.cu on the tensors' device and current
    stream. The caller (ops/scan.max_decay_scan) has checked devices,
    dtypes, shapes and contiguity; raises if the launch is refused."""
    lib = max_decay_scan_lib()
    with torch.cuda.device(y.device):
        rc = lib.max_decay_scan_launch(
            x.data_ptr(), r.data_ptr(), y0.data_ptr(), y.data_ptr(),
            x.shape[0], x.shape[1], torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"max_decay_scan kernel launch failed: CUDA error {rc}")


def complex_scan_launch(f_r: torch.Tensor, f_i: torch.Tensor,
                        p_r: torch.Tensor, p_i: torch.Tensor,
                        s_r: torch.Tensor, s_i: torch.Tensor,
                        u_r: torch.Tensor, u_i: torch.Tensor) -> None:
    """Launch csrc/complex_scan.cu on the tensors' device and current
    stream, with the tiling of scan_plan and its scratch. The caller
    (ops/scan.complex_affine_scan) has checked devices, dtypes, shapes and
    contiguity; raises if the launch is refused."""
    lib = complex_scan_lib()
    T, C = f_r.shape
    plan = scan_plan(T, C, 2)
    with torch.cuda.device(u_r.device):
        scratch, ptr = _scratch(plan, u_r)
        rc = lib.complex_scan_launch(
            f_r.data_ptr(), f_i.data_ptr(), p_r.data_ptr(), p_i.data_ptr(),
            s_r.data_ptr(), s_i.data_ptr(), u_r.data_ptr(), u_i.data_ptr(),
            ptr, T, C, plan.cl, plan.k,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"complex_scan kernel launch failed: CUDA error {rc}")
