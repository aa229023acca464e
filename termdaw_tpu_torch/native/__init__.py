"""ctypes loader for the native C++ host library, carried over from
termdaw_tpu/native/__init__.py so that the port imports nothing of
termdaw_tpu. Same API and argtypes: `get_lib()`, `unpack24(raw)`,
`pack24(vals)`, `scan_frames(buf, max_frames=4096)`, except that
`pack24` returns the uint8 array it fills, not that array's `bytes`
(a file takes the array as it is). Each returns None
when the library is not loaded, and the callers in `fileio/` then take
their numpy paths, which give the same bytes and packets (a missing
toolchain costs speed only). TERMDAW_NATIVE=0 disables it, read at the
first `get_lib()` as the reference reads it.

Two things differ from the reference:

* Where it builds. At first use `$CXX` (else `g++`) compiles wavio.cpp and
  packets.cpp with the reference's flags into
  `termdaw_tpu_torch/build/libtermdaw_native-<hash>.so`, the hash over
  both sources, the compiler and the flags (as `kernels._lib_path`). The
  build writes a temp file and `os.replace`s it into place, so processes
  that build at once each load a whole library. Nothing is built into the
  source tree.
* A failed build is not silent. `load_error` keeps the reason (the
  compiler's output), written once to stderr; `calls` counts the calls of
  each entry point that reached the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = ("wavio.cpp", "packets.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
BUILD_DIR = _DIR.parent / "build"

_lib = None
_tried = False
load_error = ""          # why get_lib() returned None; "" once loaded
build_seconds = None     # the compile's wall of this process, None if cached
calls = {"unpack24": 0, "pack24": 0, "scan_frames": 0}


def compiler() -> list[str]:
    """The compiler command: $CXX split as a shell would, else g++."""
    return shlex.split(os.environ.get("CXX", "")) or ["g++"]


def lib_path() -> Path:
    """build/libtermdaw_native-<hash>.so, the hash over both sources, the
    compiler command and the flags."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + (_DIR / name).read_bytes())
    h.update(" ".join((*compiler(), *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libtermdaw_native-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> str:
    """Compile the sources into `lib`; returns "" or why it failed."""
    global build_seconds
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [*compiler(), *CXX_FLAGS, *(str(_DIR / s) for s in SOURCES),
             "-o", str(tmp)],
            capture_output=True, text=True, timeout=120,
        )
    except (subprocess.SubprocessError, OSError) as e:
        return f"{' '.join(compiler())} could not run: {e}"
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        return (f"{' '.join(compiler())} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}".rstrip())
    # atomic: a concurrent build never sees a partial file
    os.replace(tmp, lib)
    build_seconds = time.perf_counter() - t0
    return ""


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried, load_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("TERMDAW_NATIVE", "1") == "0":
        load_error = "disabled by TERMDAW_NATIVE=0"
        return None
    lib_file = lib_path()
    err = "" if lib_file.exists() else _build(lib_file)
    if not err:
        try:
            lib = ctypes.CDLL(str(lib_file))
        except OSError as e:
            err = f"could not load {lib_file}: {e}"
    if err:
        load_error = err
        print(f"termdaw_tpu_torch.native: {err}\n(the numpy paths run "
              f"instead)", file=sys.stderr)
        return None
    c_i64 = ctypes.c_int64
    lib.unpack24.argtypes = [ctypes.c_void_p, c_i64, ctypes.c_void_p]
    lib.pack24.argtypes = [ctypes.c_void_p, c_i64, ctypes.c_void_p]
    lib.quantize16.argtypes = [
        ctypes.c_void_p, c_i64, ctypes.c_float, ctypes.c_void_p
    ]
    lib.quantize32.argtypes = [
        ctypes.c_void_p, c_i64, ctypes.c_double, ctypes.c_void_p
    ]
    lib.interleave2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, c_i64, ctypes.c_void_p
    ]
    lib.deinterleave2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, c_i64, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.scan_frames.argtypes = [ctypes.c_void_p, c_i64, ctypes.c_void_p, c_i64]
    lib.scan_frames.restype = c_i64
    _lib = lib
    load_error = ""
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def unpack24(raw: bytes) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    n = len(raw) // 3
    src = np.frombuffer(raw, dtype=np.uint8, count=n * 3)
    dst = np.empty(n, np.int32)
    lib.unpack24(_ptr(src), n, _ptr(dst))
    calls["unpack24"] += 1
    return dst


def pack24(vals: np.ndarray) -> np.ndarray | None:
    """The 24-bit packing into a fresh uint8 array, 3 bytes a sample."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(vals, np.int32)
    dst = np.empty(len(src) * 3, np.uint8)
    lib.pack24(_ptr(src), len(src), _ptr(dst))
    calls["pack24"] += 1
    return dst


def scan_frames(buf: bytes | bytearray, max_frames: int = 4096):
    """Return list of (offset, length) complete frames, or None if the
    native library is unavailable. Raises ValueError on malformed data.
    Reads `buf` in place (the reference scans a copy); the view is
    released before this returns or raises (a traceback would keep it),
    so a bytearray may be resized after."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(buf, dtype=np.uint8)
    spans = np.empty(max_frames * 2, np.int64)
    n = lib.scan_frames(_ptr(src), len(src), _ptr(spans), max_frames)
    del src
    calls["scan_frames"] += 1
    if n < 0:
        raise ValueError(f"malformed packet stream (code {n})")
    return [tuple(s) for s in spans[: 2 * n].reshape(n, 2).tolist()]
