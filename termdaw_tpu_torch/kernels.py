"""Build and bind the port's CUDA kernels (nvcc + ctypes).

Each `csrc/*.cu` file exports a plain `extern "C"` launcher. At first use
it is compiled with nvcc for Hopper (`sm_90a`) into a shared library under
`termdaw_tpu_torch/build/`, named by a hash of its source, and loaded with
ctypes; `build_all` compiles several sources in parallel. Nothing is
built when the module is imported, so the CPU tests can import
everything without nvcc.

nvcc is looked up in `$CUDA_HOME/bin`, then `/usr/local/cuda/bin`, then
`PATH`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


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
    vp = ctypes.c_void_p
    return _load("affine_scan", "affine_scan_launch",
                 [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp])


def max_decay_scan_lib() -> ctypes.CDLL:
    vp = ctypes.c_void_p
    return _load("max_decay_scan", "max_decay_scan_launch",
                 [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp])


def complex_scan_lib() -> ctypes.CDLL:
    vp = ctypes.c_void_p
    return _load("complex_scan", "complex_scan_launch",
                 [vp] * 8 + [ctypes.c_longlong, ctypes.c_int, vp])


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
    stream. The caller (ops/scan.affine_scan) has checked devices, dtypes,
    shapes and contiguity; raises if the launch is refused."""
    lib = affine_scan_lib()
    with torch.cuda.device(y.device):
        rc = lib.affine_scan_launch(
            b.data_ptr(), a.data_ptr(), y0.data_ptr(), y.data_ptr(),
            b.shape[0], b.shape[1], torch.cuda.current_stream().cuda_stream,
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
    stream. The caller (ops/scan.complex_affine_scan) has checked devices,
    dtypes, shapes and contiguity; raises if the launch is refused."""
    lib = complex_scan_lib()
    with torch.cuda.device(u_r.device):
        rc = lib.complex_scan_launch(
            f_r.data_ptr(), f_i.data_ptr(), p_r.data_ptr(), p_i.data_ptr(),
            s_r.data_ptr(), s_i.data_ptr(), u_r.data_ptr(), u_i.data_ptr(),
            f_r.shape[0], f_r.shape[1],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"complex_scan kernel launch failed: CUDA error {rc}")
