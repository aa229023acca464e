"""Build and bind the port's CUDA kernels (nvcc + ctypes).

Each `csrc/*.cu` file exports a plain `extern "C"` launcher. At first use
it is compiled with nvcc for Hopper (`sm_90a`) into a shared library under
`termdaw_tpu_torch/build/`, named by a hash of its source and the shared
headers (`csrc/*.cuh`), and loaded with ctypes; `build_all` compiles
several sources in parallel. Nothing is built when the module is
imported, so the CPU tests can import everything without nvcc.

The three tiled scans (affine_scan.cu, complex_scan.cu and
max_decay_scan.cu on csrc/scan_tile.cuh) take their tiling from
`scan_plan`, and their scratch planes from the launch functions here;
the voice mix takes its regime, grid and shared memory from
`voice_mix_plan`; the exact biquad lane (biquad_seq.cu) plans its own
one-CTA-per-32-channels grid; the SampSyn arm (sampsyn.cu) takes the
envelope's and the table's constants as a `SampSynParams`, the Synth arm
(synth.cu) its oscillators', envelopes' and sine's as a `SynthParams`
(both share csrc/note_env.cuh's envelope); the eq3's
crossover tree (eq3.cu, four stages of the tiled scan) takes its run
length from `scan_plan(T, 4, "eq3")` and its scratch from `eq3_launch`;
the vertex epilogue (vertex_post.cu) takes its pan factors, wet and gain
as device pointers and its three flags as ints.

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
KERNELS = ("voice_mix", "affine_scan", "max_decay_scan", "complex_scan",
           "biquad_seq", "sampsyn", "eq3", "synth", "vertex_post")

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
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load("voice_mix", "voice_mix_stereo_launch",
                 [vp, ctypes.c_longlong, vp, vp, vp, ci, ci, ci, vp, ci, ci,
                  ci, ci, vp])


def affine_scan_lib() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load("affine_scan", "affine_scan_launch",
                 [vp] * 5 + [ctypes.c_longlong, ci, ci, ci, vp])


def max_decay_scan_lib() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load("max_decay_scan", "max_decay_scan_launch",
                 [vp] * 5 + [ctypes.c_longlong, ci, ci, ci, vp])


def complex_scan_lib() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load("complex_scan", "complex_scan_launch",
                 [vp] * 9 + [ctypes.c_longlong, ci, ci, ci, vp])


def biquad_seq_lib() -> ctypes.CDLL:
    vp = ctypes.c_void_p
    return _load("biquad_seq", "biquad_seq_launch",
                 [vp] * 9 + [ctypes.c_longlong, ctypes.c_int, vp])


# csrc/note_env.cuh's envelope constants (ops/synthv._env_fields)
_ENV_FLOATS = ("att_base", "att_slope", "att_div", "dec_base", "dec_slope",
               "dec_div", "sus_base", "sus_slope", "sus_div", "a32", "d32",
               "ad", "ads_end", "sustain_vel", "release_vel", "release_div")
_ENV_INTS = ("att_on", "dec_on", "sus_on", "release_on")


class SampSynParams(ctypes.Structure):
    """csrc/sampsyn.cu's SampSynParams: the envelope's segments (base,
    slope and f32 duration, and whether the duration is positive), its
    f32 edges, the sustain and release velocities, the release's f32
    duration, the amplitude and the table's W / 2^32, as the plain
    version's f32 operands (ops/synthv._sampsyn_params)."""
    _fields_ = [(n, ctypes.c_float) for n in _ENV_FLOATS + (
        "amp", "wscale")] + [(n, ctypes.c_int) for n in _ENV_INTS]


class SynthEnv(ctypes.Structure):
    """csrc/synth.cu's SynthEnv: one oscillator's envelope constants."""
    _fields_ = [(n, ctypes.c_float) for n in _ENV_FLOATS] + [
        (n, ctypes.c_int) for n in _ENV_INTS]


class SynthParams(ctypes.Structure):
    """csrc/synth.cu's SynthParams, oscillators square, top-flat and
    triangle: each one's envelope, on flag, the first oscillator on whose
    envelope equals its own, f32 volume and shape constants (z, 1/z,
    (1-z)/2, 2/(1+z)); the amplitude; ops/osc.sin_f32's constants (1/2pi,
    2pi's three terms, the reduction's bound, 2pi), as the plain
    version's f32 operands (ops/synthv._synth_params)."""
    _fields_ = [("env", SynthEnv * 3), ("on", ctypes.c_int * 3),
                ("env_of", ctypes.c_int * 3)] + [
        (n, ctypes.c_float * 3) for n in (
            "vol", "z", "inv_z", "half_1mz", "two_1pz")] + [
        (n, ctypes.c_float) for n in (
            "amp", "inv_2pi", "pi2_hi", "pi2_mid", "pi2_lo", "reduce_max",
            "two_pi")]


def sampsyn_lib() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load("sampsyn", "sampsyn_launch",
                 [vp] * 13 + [ci] * 6 + [vp, vp, vp])


def synth_lib() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load("synth", "synth_launch", [vp] * 12 + [ci] * 4 + [vp] * 3)


def eq3_lib() -> ctypes.CDLL:
    vp = ctypes.c_void_p
    return _load("eq3", "eq3_launch",
                 [vp] * 15 + [ctypes.c_longlong, ctypes.c_int, vp])


def vertex_post_lib() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load("vertex_post", "vertex_post_launch",
                 [vp] * 5 + [ci] * 3 + [ctypes.c_longlong, vp, vp])


def load_all(device: torch.device) -> None:
    """Build every kernel (in parallel) and load its library on `device`:
    what a CUDA-graph capture needs done before it starts, since nothing
    may be compiled or loaded while a stream captures. Cheap once done."""
    if len(_LIBS) == len(KERNELS):
        return
    build_all(KERNELS)
    with torch.cuda.device(device):
        for name in KERNELS:
            globals()[f"{name}_lib"]()


SCAN_THREADS = 256            # scan_tile.cuh kThreads
SCAN_SHARED_BYTES = 48 * 1024  # scan_tile.cuh kSharedBytes
# each tiled scan's op: (input planes, bytes of one per-warp total, the
# larger of sizeof(Op::Map) and sizeof(Op::DMap)); "eq3" is a stage of
# csrc/eq3.cu, whose tiles' totals keep 4 planes of scratch (its
# SCAN_AGG_PLANES), the others as many as they have input planes
SCAN_OPS = {"affine": (1, 16), "max_decay": (1, 16), "complex": (2, 32),
            "eq3": (1, 80)}
SCAN_AGG_PLANES = {"eq3": 4}
# an op's run length on long timelines where it is not scan_plan's rule:
# an eq3 stage at c8's window (T = 384,000) took 82.7 us a call with runs
# of 23 frames, 91.3 with 31, 119.9 with 15 and 106.3 with 45 (H100,
# PERF.md): its tiles' carry-in, not its bytes, sets the time
SCAN_RUNS = {"eq3": 23}


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
def scan_plan(T: int, C: int, op: str) -> ScanPlan:
    """The tiling of a scan by `op` (a key of SCAN_OPS), as measured
    fastest on an H100 (PERF.md). Below 32 lanes runs are odd, so the
    threads of a warp, K * CL floats apart in shared memory, fall on 32
    different banks. A timeline of at most 16 frames a run is one tile,
    one kernel (the delay line's 67 rows). Longer ones are cut into tiles
    of about 2048 frames for at most 4 lanes (runs of 8 * CL - 1 frames,
    fewer where shared memory ends) and runs of 7 frames for wider rows,
    combined reduce-then-scan with planes * tiles * C floats of scratch
    (SCAN_AGG_PLANES's count of planes where an op keeps another) and
    SCAN_RUNS's run where an op has its own;
    a timeline that one such tile covers takes the shortest odd run that
    covers it."""
    planes, total_bytes = SCAN_OPS[op]
    cl = 1
    while cl < C and cl < 32:
        cl *= 2
    runs = SCAN_THREADS // cl
    totals = 8 * cl * total_bytes  # WarpTotals, static
    k_max = (SCAN_SHARED_BYTES - totals) // (SCAN_THREADS * 4 * planes)
    k_max -= 1 - k_max % 2
    k = -(-T // runs)
    if k > 16:
        run = min(SCAN_RUNS.get(op, 8 * cl - 1 if cl <= 4 else 7), k_max)
        k = k | 1 if k <= run else run
    elif cl < 32:
        k |= 1
    s = runs * k
    tiles = -(-T // s)
    agg = SCAN_AGG_PLANES.get(op, planes)
    return ScanPlan(cl, k, s, tiles, -(-C // cl),
                    SCAN_THREADS * k * 4 * planes,
                    agg * tiles * C if tiles > 1 else 0)


def _scratch(plan: ScanPlan, like: torch.Tensor):
    """The plan's scratch floats on `like`'s device and the pointer to
    pass (None, None without scratch). The caller holds the buffer until
    the launch is queued; the caching allocator orders its reuse after
    the kernels on the same stream."""
    if not plan.scratch:
        return None, None
    buf = torch.empty(plan.scratch, dtype=torch.float32, device=like.device)
    return buf, buf.data_ptr()


VOICE_MIX_TILE = 256      # voice_mix.cu kTile: frames of one work item
VOICE_MIX_MAX_WARPS = 32  # voice_mix.cu kMaxWarps: a CTA's most warps
VOICE_MIX_MIN_STAGING_WARPS = 8  # a staged CTA's fewest warps (all copy)
# dynamic shared memory the staged regime may take for the [2, lpad]
# buffer (8 * lpad bytes, plus 16 to copy it as aligned float4s); with
# the 16 KB of slot tables (static) a CTA stays within the 227 KB it may
# use
VOICE_MIX_RESIDENT_BYTES = 200 * 1024
VOICE_MIX_RESIDENT_LPAD = (VOICE_MIX_RESIDENT_BYTES - 16) // 8
H100_SMS = 132


class VoiceMixPlan(NamedTuple):
    """How csrc/voice_mix.cu runs one mix."""
    resident: bool  # the buffer staged in shared memory, else streamed
    grid: int       # CTAs, at most one an SM
    threads: int    # threads per CTA, a warp per item at a time
    smem: int       # dynamic shared memory per CTA, bytes (0 streamed)
    items: int      # (block, 256-frame tile) work items


def voice_mix_plan(lpad: int, nb: int, bl: int,
                   sms: int = H100_SMS) -> VoiceMixPlan:
    """The regime of a mix of nb blocks of bl frames from a [2, lpad]
    buffer (lpad >= 256), on a card of `sms` SMs. Resident (the
    buffer staged in shared memory) when it fits VOICE_MIX_RESIDENT_BYTES
    (lpad up to VOICE_MIX_RESIDENT_LPAD), else streamed from global
    memory. Either way each warp mixes one item at a time, and a CTA has
    as few warps as spread the items over the SMs in one round (up to 32;
    at least 8 when staged, since every thread helps copy the buffer).
    The number of slots does not change the plan: a warp stages its slot
    table 32 entries at a time."""
    tiles = -(-bl // VOICE_MIX_TILE)
    items = nb * tiles
    resident = lpad <= VOICE_MIX_RESIDENT_LPAD
    least = VOICE_MIX_MIN_STAGING_WARPS if resident else 1
    warps = max(least, min(VOICE_MIX_MAX_WARPS, -(-items // sms)))
    grid = max(1, min(sms, -(-items // warps)))
    return VoiceMixPlan(resident, grid, 32 * warps,
                        8 * lpad + 16 if resident else 0, items)


def voice_mix_launch(
    sample_padded: torch.Tensor, begins: torch.Tensor, amp_l: torch.Tensor,
    amp_r: torch.Tensor, out: torch.Tensor, nb: int, bl: int,
) -> None:
    """Launch csrc/voice_mix.cu on the tensors' device and current stream,
    in the regime of voice_mix_plan. The caller
    (ops/voices.voice_mix_stereo) has checked devices, dtypes, shapes and
    contiguity; raises if the launch is refused."""
    lib = voice_mix_lib()
    lpad, P = sample_padded.shape[1], begins.shape[1]
    with torch.cuda.device(out.device):
        props = torch.cuda.get_device_properties(out.device)
        plan = voice_mix_plan(lpad, nb, bl, props.multi_processor_count)
        rc = lib.voice_mix_stereo_launch(
            sample_padded.data_ptr(), lpad, begins.data_ptr(),
            amp_l.data_ptr(), amp_r.data_ptr(), nb, P, bl, out.data_ptr(),
            int(plan.resident), plan.grid, plan.threads, plan.smem,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"voice_mix kernel launch failed: CUDA error {rc}")


def _scan_launch(lib, name: str, op: str, ins: tuple, outs: tuple) -> None:
    """Launch the tiled scan csrc/<name>.cu (its library from `lib`) on
    the tensors' device and current stream, with the tiling of
    scan_plan(T, C, op) and its scratch: pointers ins (sequences, then
    per-lane values), outs, the scratch, then T, C, cl, k and the
    stream."""
    fn = getattr(lib(), f"{name}_launch")
    T, C = ins[0].shape
    plan = scan_plan(T, C, op)
    with torch.cuda.device(outs[0].device):
        scratch, ptr = _scratch(plan, outs[0])
        rc = fn(*(t.data_ptr() for t in ins + outs), ptr, T, C, plan.cl,
                plan.k, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def affine_scan_launch(b: torch.Tensor, a: torch.Tensor, y0: torch.Tensor,
                       y: torch.Tensor) -> None:
    """Launch csrc/affine_scan.cu (see _scan_launch). The caller
    (ops/scan.affine_scan) has checked devices, dtypes, shapes and
    contiguity; raises if the launch is refused."""
    _scan_launch(affine_scan_lib, "affine_scan", "affine", (b, a, y0),
                 (y,))


def max_decay_scan_launch(x: torch.Tensor, r: torch.Tensor, y0: torch.Tensor,
                          y: torch.Tensor) -> None:
    """Launch csrc/max_decay_scan.cu (see _scan_launch). The caller
    (ops/scan.max_decay_scan) has checked devices, dtypes, shapes and
    contiguity; raises if the launch is refused."""
    _scan_launch(max_decay_scan_lib, "max_decay_scan", "max_decay",
                 (x, r, y0), (y,))


def complex_scan_launch(f_r: torch.Tensor, f_i: torch.Tensor,
                        p_r: torch.Tensor, p_i: torch.Tensor,
                        s_r: torch.Tensor, s_i: torch.Tensor,
                        u_r: torch.Tensor, u_i: torch.Tensor) -> None:
    """Launch csrc/complex_scan.cu (see _scan_launch). The caller
    (ops/scan.complex_affine_scan) has checked devices, dtypes, shapes and
    contiguity; raises if the launch is refused."""
    _scan_launch(complex_scan_lib, "complex_scan", "complex",
                 (f_r, f_i, p_r, p_i, s_r, s_i), (u_r, u_i))


def biquad_seq_launch(x: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor,
                      b2: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
                      state: torch.Tensor, y: torch.Tensor,
                      new_state: torch.Tensor) -> None:
    """Launch csrc/biquad_seq.cu on the tensors' device and current
    stream: x, y [T, C], coefficients [C], states [4, C], all float32 and
    contiguous. The caller (ops/filters.biquad_apply_sequential) has
    checked them; raises if the launch is refused."""
    T, C = x.shape
    fn = biquad_seq_lib().biquad_seq_launch
    with torch.cuda.device(y.device):
        rc = fn(*(t.data_ptr() for t in (x, b0, b1, b2, a1, a2, state, y,
                                         new_state)),
                T, C, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"biquad_seq kernel launch failed: CUDA error {rc}")


def sampsyn_launch(frames: torch.Tensor, ib: torch.Tensor, cols: tuple,
                   times: torch.Tensor, waves: torch.Tensor,
                   params: SampSynParams, out: torch.Tensor, nb: int,
                   bl: int) -> None:
    """Launch csrc/sampsyn.cu on the tensors' device and current stream:
    `cols` the bake's idx, on_f, off_f, dead_f, vels, cyc, rel_t, env_ads0
    and env_rel0, in that order. The caller (ops/synthv.sampsyn) has
    checked devices, dtypes, shapes and contiguity; raises if the launch
    is refused."""
    fn = sampsyn_lib().sampsyn_launch
    idx, on_f = cols[0], cols[1]
    K, W = waves.shape
    with torch.cuda.device(out.device):
        rc = fn(frames.data_ptr(), ib.data_ptr(),
                *(t.data_ptr() for t in cols), times.data_ptr(),
                waves.data_ptr(), nb, bl, idx.shape[1], on_f.shape[0], K, W,
                ctypes.addressof(params), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sampsyn kernel launch failed: CUDA error {rc}")


def synth_launch(frames: torch.Tensor, time2d: torch.Tensor,
                 ib: torch.Tensor, cols: tuple, params: SynthParams,
                 out: torch.Tensor, nb: int, bl: int) -> None:
    """Launch csrc/synth.cu on the tensors' device and current stream:
    `cols` the bake's idx, on_f, off_f, dead_f, vels, hz, rel_t, env_ads0
    and env_rel0, in that order. The caller (ops/synthv.synth) has checked
    devices, dtypes, shapes and contiguity; raises if the launch is
    refused."""
    fn = synth_lib().synth_launch
    idx, on_f = cols[0], cols[1]
    with torch.cuda.device(out.device):
        rc = fn(frames.data_ptr(), time2d.data_ptr(), ib.data_ptr(),
                *(t.data_ptr() for t in cols), nb, bl, idx.shape[1],
                on_f.shape[0], ctypes.addressof(params), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"synth kernel launch failed: CUDA error {rc}")


def eq3_launch(x: torch.Tensor, sections: torch.Tensor, states: tuple,
               gains_db: tuple, t01: torch.Tensor, t1: torch.Tensor,
               y: torch.Tensor, state_out: torch.Tensor) -> None:
    """Launch csrc/eq3.cu's four stages on the tensors' device and current
    stream: x, y [T, 2]; sections [2, 7, 4]; states four [4, 4]; gains_db
    three 0-d gains in dB; t01, t1 [T, 4] the stages' outputs; state_out
    [4, 4, 4]; all float32 and contiguous, runs of scan_plan(T, 4, "eq3")
    with its scratch. The caller (ops/fx.eq3_crossover) has checked them;
    raises if a launch is refused."""
    T = x.shape[0]
    plan = scan_plan(T, 4, "eq3")
    fn = eq3_lib().eq3_launch
    with torch.cuda.device(y.device):
        scratch, ptr = _scratch(plan, y)
        rc = fn(x.data_ptr(), sections[0].data_ptr(), sections[1].data_ptr(),
                *(t.data_ptr() for t in states + tuple(gains_db)),
                t01.data_ptr(), t1.data_ptr(), y.data_ptr(),
                state_out.data_ptr(), ptr, T, plan.k,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eq3 kernel launch failed: CUDA error {rc}")


def vertex_post_launch(y: torch.Tensor, x: torch.Tensor | None,
                       pan: torch.Tensor, wet: torch.Tensor,
                       gain: torch.Tensor, blend: bool, pan_on: bool,
                       gain_on: bool, out: torch.Tensor) -> None:
    """Launch csrc/vertex_post.cu on the tensors' device and current
    stream: y, x (None where it does not blend) and out [T, 2], pan [2],
    wet and gain 0-d, all float32, y, x and out contiguous. The caller
    (ops/mix.vertex_post) has checked them; raises if the launch is
    refused."""
    fn = vertex_post_lib().vertex_post_launch
    with torch.cuda.device(out.device):
        rc = fn(y.data_ptr(), None if x is None else x.data_ptr(),
                pan.data_ptr(), wet.data_ptr(), gain.data_ptr(), int(blend),
                int(pan_on), int(gain_on), y.shape[0], out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vertex_post kernel launch failed: CUDA error "
                           f"{rc}")
