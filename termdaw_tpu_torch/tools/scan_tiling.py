"""Device time of the tiled scan kernels (csrc/scan_tile.cuh) at the
shapes of a c3/c4 window under several run lengths, beside the one
kernels.scan_plan picks; and of the voice mix (csrc/voice_mix.cu) at
c5's shapes from several buffers, in its two regimes and on other
grids, beside kernels.voice_mix_plan's; and of the exact biquad lane
(csrc/biquad_seq.cu) at an eq3 stage's shape under other batch sizes
and stager counts than the source's. Needs a CUDA card:

    python3 -m termdaw_tpu_torch.tools.scan_tiling

Prints the card (nvidia-smi name and power limit), then one JSON line a
shape: for each run length K the tiles along the timeline, the kernels a
call launches and the device ms per call (torch.profiler over 40 calls
after a warm-up), with the plan's K marked; for the voice mix, the ms of
the plan's regime and grid, of 32 warps a CTA on fewer CTAs, and (for a
buffer the plan stages) of the same buffer streamed; for the exact
lane, each (kBatch, kThreads) variant of the source, built beside it
with the port's nvcc flags, and its bit-exactness to the source's
build. The runs go through the kernels' launchers directly, so the
wrappers' host time is not in them.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from .. import kernels

# (name, [T, C], op, run lengths tried besides the plan's)
SHAPES = (
    ("eq3_stage", (384000, 4), "complex", (7, 15)),
    ("band_pass", (384000, 4), "affine", (15, 47)),
    ("damping", (384000, 2), "affine", (7, 31)),
    ("smoothing", (384000, 1), "affine", (3, 15)),
    ("compressor", (384000, 1), "max_decay", (3, 15, 31)),
    ("max_decay_4", (1025, 4), "max_decay", (7, 17)),
    ("comb_1785", (216, 1785), "affine", (15, 27)),
    ("comb_1215", (317, 1215), "affine", (15, 40)),
    ("allpass_605", (635, 1210), "affine", (15, 31)),
    ("allpass_245", (1568, 490), "affine", (15, 31)),
    ("delay", (67, 11520), "affine", (5,)),
)
# the voice mix at c5's shapes (375 blocks of 1024 frames, 16 slots) from
# padded buffers of c5's hit, c4's snare, chip_smoke's two-segment concat,
# the resident budget's last frame and a 30 s sample: lpad
MIXES = (("c5", 6144), ("c4_snare", 9504), ("chip_smoke", 10448),
         ("budget", kernels.VOICE_MIX_RESIDENT_LPAD),
         ("30s_sample", 30 * 48000 + 2 * 1024 + 256))
MIX_NB, MIX_BL, MIX_P = 375, 1024, 16
# the exact lane at one eq3 stage: (kBatch, kThreads) variants
BIQUAD_T, BIQUAD_C = 384000, 4
BIQUAD_VARIANTS = ((8, 128), (16, 128), (32, 128), (16, 256), (32, 256))


def device_ms(fn, reps: int = 40, tries: int = 3) -> tuple[float, float]:
    """(device ms per call, device kernels per call) of fn. torch.profiler
    now and then returns a trace without device rows: such a trace is
    taken again, up to `tries` traces in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if rows:
            return (sum(e.device_time_total for e in rows) / 1e3 / reps,
                    len(rows) / reps)
    raise RuntimeError(f"the profiler saw no device rows in {tries} traces")


def biquad_variants(rng, cuda) -> dict:
    """Build every BIQUAD_VARIANTS copy of csrc/biquad_seq.cu (kBatch and
    kThreads replaced) in parallel and time each at [BIQUAD_T, BIQUAD_C]
    with stable coefficients; each variant's output must equal the
    source's build bit for bit."""
    src = (kernels.CSRC / "biquad_seq.cu").read_text()
    own = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                for k in ("kBatch", "kThreads"))
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kb, kt in BIQUAD_VARIANTS:
        v = src.replace(f"constexpr int kBatch = {own[0]};",
                        f"constexpr int kBatch = {kb};").replace(
            f"constexpr int kThreads = {own[1]};",
            f"constexpr int kThreads = {kt};")
        cu = out_dir / f"biquad_seq_{kb}x{kt}.cu"
        cu.write_text(v)
        procs[(kb, kt)] = subprocess.Popen(
            [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    x = torch.from_numpy(rng.normal(size=(BIQUAD_T, BIQUAD_C)).astype(
        np.float32)).to(cuda)
    coefs = [torch.full((BIQUAD_C,), v, device=cuda)
             for v in (0.2, 0.4, 0.2, -0.9, 0.3)]
    state = torch.zeros((4, BIQUAD_C), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(lib):
        y, s_out = torch.empty_like(x), torch.empty_like(state)
        ptrs = [t.data_ptr() for t in (x, *coefs, state, y, s_out)]

        def call():
            rc = lib.biquad_seq_launch(*ptrs, BIQUAD_T, BIQUAD_C, stream)
            if rc:
                raise RuntimeError(f"biquad_seq variant: CUDA error {rc}")
        return call, y

    ref_call, ref_y = runner(kernels.biquad_seq_lib())
    ref_call()
    runs = {}
    for (kb, kt), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {kb}x{kt}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"biquad_seq_{kb}x{kt}.so"))
        lib.biquad_seq_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p])
        lib.biquad_seq_launch.restype = ctypes.c_int
        call, y = runner(lib)
        call()
        torch.cuda.synchronize()
        ms, _ = device_ms(call, reps=10)
        runs[f"kBatch={kb},kThreads={kt}"] = {
            "ms": ms, "bit_exact": bool(torch.equal(y, ref_y)),
            "source": (kb, kt) == own}
    return {"shape": "biquad_seq_eq3_stage", "T": BIQUAD_T, "C": BIQUAD_C,
            "runs": runs}


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_tiling: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    cuda = torch.device("cuda", 0)
    launchers = {"affine": kernels.affine_scan_lib().affine_scan_launch,
                 "max_decay":
                     kernels.max_decay_scan_lib().max_decay_scan_launch,
                 "complex": kernels.complex_scan_lib().complex_scan_launch}
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (T, C), op, ks in SHAPES:
        planes = kernels.SCAN_OPS[op][0]
        plan = kernels.scan_plan(T, C, op)
        x = [torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32))
             .to(cuda) for _ in range(planes)]
        # a, y0 or r, y0 or p_r, p_i, s_r, s_i: a stable pole, a zero state
        lanes = [torch.full((C,), v, device=cuda)
                 for v in ((0.9, 0.0) if planes == 1 else
                           (0.9, 0.1, 0.0, 0.0))]
        y = [torch.empty_like(x[0]) for _ in range(planes)]
        runs = {}
        for k in sorted({plan.k, *ks}):
            tiles = -(-T // ((kernels.SCAN_THREADS // plan.cl) * k))
            scratch = torch.empty(max(1, planes * tiles * C), device=cuda)
            # the launcher's order: inputs, lanes, outputs, scratch
            ptrs = [t.data_ptr() for t in (*x, *lanes, *y, scratch)]
            launch = launchers[op]

            def call():
                rc = launch(*ptrs, T, C, plan.cl, k, stream)
                if rc:
                    raise RuntimeError(f"{name} K={k}: CUDA error {rc}")

            ms, n = device_ms(call)
            runs[f"K={k}"] = {"tiles": tiles, "kernels": n, "ms": ms,
                              "plan": k == plan.k}
        print(json.dumps({"shape": name, "T": T, "C": C, "op": op,
                          "cl": plan.cl, "runs": runs}), flush=True)
    mix = kernels.voice_mix_lib().voice_mix_stereo_launch
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name, lpad in MIXES:
        plan = kernels.voice_mix_plan(lpad, MIX_NB, MIX_BL, sms)
        padded = torch.from_numpy(
            rng.normal(size=(2, lpad)).astype(np.float32)).to(cuda)
        begins = torch.from_numpy(rng.integers(
            0, lpad - MIX_BL + 1, (MIX_NB, MIX_P)).astype(np.int32)).to(cuda)
        al, ar = (torch.from_numpy(rng.uniform(
            -1, 1, (MIX_NB, MIX_P)).astype(np.float32)).to(cuda)
            for _ in range(2))
        out = torch.empty((MIX_NB * MIX_BL, 2), device=cuda)
        ptrs = (padded.data_ptr(), lpad, begins.data_ptr(), al.data_ptr(),
                ar.data_ptr(), MIX_NB, MIX_P, MIX_BL, out.data_ptr())
        # (regime, staged, CTAs, threads, dynamic shared memory): the
        # plan's, 32 warps a CTA on fewer CTAs, and the buffer streamed
        few = -(-plan.items // kernels.VOICE_MIX_MAX_WARPS)
        regime = "resident" if plan.resident else "streamed"
        tries = [(regime, int(plan.resident), plan.grid, plan.threads,
                  plan.smem),
                 (f"{regime}_32_warps", int(plan.resident), few, 1024,
                  plan.smem)]
        if plan.resident:
            tries.append(("streamed", 0, plan.grid, plan.threads, 0))
        runs = {}
        for label, staged, grid, threads, smem in tries:
            def call():
                rc = mix(*ptrs, staged, grid, threads, smem, stream)
                if rc:
                    raise RuntimeError(f"voice mix {label}: CUDA error {rc}")

            ms, _ = device_ms(call)
            runs[label] = {"grid": grid, "threads": threads, "ms": ms,
                           "plan": (bool(staged), grid, threads, smem) == (
                               plan.resident, plan.grid, plan.threads,
                               plan.smem)}
        print(json.dumps({"shape": f"voice_mix_{name}", "lpad": lpad,
                          "nb": MIX_NB, "bl": MIX_BL, "P": MIX_P,
                          "runs": runs}), flush=True)
    print(json.dumps(biquad_variants(rng, cuda)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
