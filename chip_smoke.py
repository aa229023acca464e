#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (termdaw_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero without
the final line:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
2. build: compiles every kernel (csrc/voice_mix.cu, affine_scan.cu,
   max_decay_scan.cu, complex_scan.cu) with nvcc for sm_90a, one nvcc
   process each, all in parallel;
3. the voice-mix kernel against its plain PyTorch version on the card at
   the c5 render's shapes (375 blocks of 1024 frames, 16 slots, a
   two-sample concat buffer), tolerance 1e-6;
4. the affine-scan kernel against its plain version at c3's band-pass
   shape (one window of 375 blocks x 1024 frames, 4 lanes, the gammas of
   8000 Hz and 30 Hz at 48 kHz, a seeded input): both within 1e-4 of a
   float64 recurrence and within 1e-5 of each other, relative to max |y|;
   and a slow pole (a = 0.9999, same shape), where the kernel must be
   within 1e-4 of float64 relative to max |y| (the plain version's
   distance is printed, not gated);
5. c5 end to end (64 streamed SampleMulti tracks, 48 kHz / 1024, 40 s,
   32-bit, a 96 kHz hit resampled on import): refresh + render on cuda,
   the kernel launch counts of that run, and the WAV against the port's
   CPU render of the same project (|diff| <= max(1, 1e-5 * 2^(bd-1)));
6. c1 end to end (two SampleLoops -> Normalize, 48 kHz -> 44.1 kHz
   16-bit), with the same comparison;
7. c2 end to end (SampleLerp kick, an Adsr envelope ducking a looping
   pad, 48 kHz / 1024, 40 s, 16-bit) and c3 end to end (Synth and SampSyn
   through a BandPass, same format), with the same comparison; the c3 run
   must launch the affine-scan kernel;
8. playback: the port's Player on cuda with c2 and a capturing sink;
   play() queues the 16-block prebuffer, equal to the CPU render of the
   same blocks (atol 1e-5); a few tick()s queue more finite audio;
9. the effects' scans at c4's shapes, each kernel against its plain
   version and a float64 recurrence (the rules of phase 4): max-decay at
   one compressor window (375 x 1024 frames, 1 lane, release 250 ms at
   48 kHz), complex-scan at one eq3 stage (375 x 1024 frames, 4 lanes,
   the poles of the 180 Hz and 4 kHz crossovers), affine-scan at the
   feedback lines (the longest reverb comb, D = 1785, 1 lane; the delay,
   D = 5760, 2 lanes); and complex-scan at a slow pole (|p| = 0.9999, the
   conjugate pair at 20 Hz), checked as phase 4's slow pole;
10. c4 end to end (the reference's demo project with the reverb ->
   compressor -> eq3 -> delay chain, 48 kHz / 1024, 40 s -> 44.1 kHz
   16-bit): refresh + render on cuda, which must launch all four kernels,
   and the WAV against the port's CPU render, as in phase 5;
11. timings after one warm-up: render_device wall time (synchronized),
   the median of 5, for c5, c1, c2, c3 and c4; each kernel against its
   plain version (CUDA events per wrapper call); and each kernel's device
   time per call (torch.profiler, all the kernels a call launches) beside
   its bound (bytes read and written once at 3.35 TB/s, or f32 operations
   at 67 TFLOP/s) and the share of the bound it reaches, the scans at
   every shape c3 and c4 run them at;
12. torch.profiler traces of two c4 renders: the first as it runs
   (device time in all and in each kernel, device kernel launches, device
   busy share of the wall), the second with each effect fenced by
   synchronizes (the effects' device time).

Then the card line, the kernels line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BL, SR, SECONDS = 1024, 48000, 40.0           # every project's format
C5_NB, C5_P, C5_HIT_FRAMES = 375, 16, 3840   # a 0.08 s hit at 48 kHz
KERNEL_ATOL = 1e-6
SCAN_T, SCAN_C = 375 * BL, 4                  # one c3 band-pass window
SCAN_F64_RTOL, SCAN_PLAIN_RTOL = 1e-4, 1e-5   # relative to max |y|
PLAYER_ATOL = 1e-5
COMB_D, DELAY_D = 1785, 5760                  # c4's feedback lines at 48 kHz
SLOW_POLE, SLOW_HZ = 0.9999, 20.0             # phases 4 and 9's slow poles
# one H100 SXM, published peaks: HBM3 bytes/s, f32 flop/s
PEAK_BYTES_S, PEAK_F32_FLOPS = 3.35e12, 67e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def kernel_inputs(device: torch.device):
    """c5-shaped voice-mix inputs from numpy seed 0: a concat buffer of two
    padded samples, begins in concat coordinates including 0 and each
    segment's largest in-bounds begin (L + bl), and empty slots."""
    rng = np.random.default_rng(0)
    lens = (C5_HIT_FRAMES, 2000)
    segs = [np.pad(rng.uniform(-1, 1, (2, L)).astype(np.float32),
                   ((0, 0), (BL, BL + 256))) for L in lens]
    base = (0, segs[0].shape[1])
    padded = np.ascontiguousarray(np.concatenate(segs, axis=1))
    seg = rng.integers(0, 2, (C5_NB, C5_P))
    begins = (rng.integers(0, np.asarray(lens)[seg] + BL + 1)
              + np.asarray(base)[seg]).astype(np.int32)
    begins[0, 0] = 0
    begins[1, 0] = base[1] + lens[1] + BL
    begins[2, 0] = lens[0] + BL
    amp_l = rng.uniform(-1, 1, (C5_NB, C5_P)).astype(np.float32)
    amp_r = rng.uniform(-1, 1, (C5_NB, C5_P)).astype(np.float32)
    amp_l[:, C5_P // 2:] = amp_r[:, C5_P // 2:] = 0.0  # empty slots
    begins[:, C5_P // 2:] = 0
    return tuple(torch.from_numpy(a).to(device)
                 for a in (padded, begins, amp_l, amp_r))


def scan_inputs(device: torch.device):
    """c3's band-pass lanes (low/high x L/R) for one window: b = g * x, a =
    1 - g, from a seeded input x; y0 = the first sample (priming)."""
    from termdaw_tpu_torch.ops.filters import gamma_from_cutoff

    lg, hg = gamma_from_cutoff(8000.0, SR), gamma_from_cutoff(30.0, SR)
    g = np.asarray([lg, lg, hg, hg], np.float32)
    x = np.random.default_rng(1).normal(size=(SCAN_T, 2)).astype(np.float32)
    b = (g * np.concatenate([x, x], axis=1)).astype(np.float32)
    y0 = np.concatenate([x[0], x[0]])
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for v in (b, np.float32(1.0) - g, y0))


def recurrence64(b: np.ndarray, a: np.ndarray, y0: np.ndarray) -> np.ndarray:
    y = np.empty(b.shape, np.float64)
    prev = y0.astype(np.float64)
    a64 = a.astype(np.float64)
    for t in range(b.shape[0]):
        prev = a64 * prev + b[t]
        y[t] = prev
    return y


def max_decay64(x: np.ndarray, r: np.ndarray, y0: np.ndarray) -> np.ndarray:
    y = np.empty(x.shape, np.float64)
    prev = y0.astype(np.float64)
    r64 = r.astype(np.float64)
    for t in range(x.shape[0]):
        prev = np.maximum(x[t], r64 * prev)
        y[t] = prev
    return y


def complex64(f: np.ndarray, p: np.ndarray, s: np.ndarray) -> np.ndarray:
    u = np.empty(f.shape, np.complex128)
    prev = s.astype(np.complex128)
    p128 = p.astype(np.complex128)
    for t in range(f.shape[0]):
        prev = p128 * prev + f[t]
        u[t] = prev
    return u


def slow_pole_inputs(device: torch.device) -> dict:
    """Slow poles at T = 384,000, 4 lanes, from a seeded input x (numpy
    seed 3), states 0: the affine scan at a = 0.9999, and the complex scan
    at |p| = 0.9999, the conjugate pair at 20 Hz on lanes [p, conj p, p,
    conj p]. Every tile composes the same power of the pole, so this is
    where the tiles' shared rounding error would compound. As (host
    arrays, device tensors) per scan."""
    x = np.random.default_rng(3).normal(size=(SCAN_T, SCAN_C))
    x = x.astype(np.float32)
    zero = np.zeros(SCAN_C, np.float32)
    p = SLOW_POLE * np.exp(2j * np.pi * SLOW_HZ / SR)
    p = np.asarray([p, np.conj(p)] * (SCAN_C // 2)).astype(np.complex64)
    out = {"affine": (x, np.full(SCAN_C, SLOW_POLE, np.float32), zero),
           "complex": (x, np.zeros_like(x), p.real.copy(), p.imag.copy(),
                       zero, zero)}
    return {k: (v, [torch.from_numpy(a).to(device) for a in v])
            for k, v in out.items()}


def slow_check(name, got, plain, y64) -> dict:
    """The kernel within SCAN_F64_RTOL of float64 relative to max |y| (no
    floor); the plain version's distance is reported, not gated. got,
    plain and y64 are sequences of parts (re, im) of one output."""
    scale = max(float(np.abs(y).max()) for y in y64)
    err = max(float(np.abs(np.asarray(g) - y).max())
              for g, y in zip(got, y64))
    perr = max(float(np.abs(np.asarray(w) - y).max())
               for w, y in zip(plain, y64))
    check(all(bool(np.isfinite(np.asarray(g)).all()) for g in got),
          f"{name} kernel output not finite")
    check(err <= SCAN_F64_RTOL * scale,
          f"{name} kernel vs float64 max |diff| {err} > {SCAN_F64_RTOL} * "
          f"{scale}")
    return {"max_abs_y": scale, "kernel_vs_f64": err,
            "kernel_vs_f64_rel": err / scale, "plain_vs_f64": perr,
            "plain_vs_f64_rel": perr / scale}


def affine_shapes() -> dict:
    """Every [T, C] the affine-scan kernel runs at in a c3 or c4 window
    (375 blocks of 1024 frames at 48 kHz): the band-pass, the reverb's
    input damping, the compressor's smoothing, each reverb comb (mono,
    [rows, D]) and allpass (stereo, [rows, 2D]), the delay ([rows, 2D])."""
    from termdaw_tpu_torch.ops import fx

    combs, allp = fx._reverb_lines(SR)
    shapes = {"band_pass": (SCAN_T, 4), "damping": (SCAN_T, 2),
              "smoothing": (SCAN_T, 1)}
    shapes.update({f"comb_{d}": (-(-SCAN_T // d), d) for d in combs})
    shapes.update({f"allpass_{d}": (-(-SCAN_T // d), 2 * d) for d in allp})
    shapes["delay"] = (-(-SCAN_T // DELAY_D), 2 * DELAY_D)
    return shapes


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the bytes read once and
    written once over HBM's rate, or the f32 operations over the peak
    f32 rate, whichever is larger."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return {"bound_ms": max(tb, tf) * 1e3,
            "bound_by": "bytes" if tb >= tf else "operations"}


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of fn: the CUDA rows of a torch.profiler trace
    of `reps` calls after a warm-up (all the kernels a call launches)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == cuda_t)
    check(total > 0, "the profiler saw no device time")
    return total / 1e3 / reps


def timed(fn, plain, nbytes: float, flops: float) -> dict:
    """A kernel's device ms per call beside its bound, the wrapper's
    CUDA-event ms per call (host dispatch included when that is longer)
    and the plain version's."""
    ms = device_ms(fn)
    b = bound(nbytes, flops)
    return {"ms": ms, "call_ms": event_ms(fn, 50),
            "plain_ms": event_ms(plain, 20), **b,
            "bound_share": b["bound_ms"] / ms}


def fx_scan_inputs(device: torch.device) -> dict:
    """The effects' scans at c4's shapes, from numpy seeds, as (host
    arrays, device tensors) per scan:
    * max_decay: the compressor's level max|x| of one window, r of the
      250 ms release at 48 kHz computed as the effect computes it;
    * complex: the second pole of one eq3 stage, lanes [L, R] at the
      180 Hz crossover and [L, R] at 4 kHz, fed the float64 first cascade
      of a seeded input through each section's feed-forward taps;
    * comb / delay: feedback_line's [rows, D*C] layout of a seeded input,
      a = the comb's feedback (room 0.84 * 0.94) or the delay's 0.35."""
    from termdaw_tpu_torch.ops.filters import biquad_coefs

    rng = np.random.default_rng(2)
    x = rng.normal(size=(SCAN_T, 2)).astype(np.float32)
    out = {}
    rel = torch.tensor(250.0, dtype=torch.float32)
    r = torch.exp(-1.0 / (rel * 0.001 * SR)).reshape(1).numpy()
    out["max_decay"] = (np.abs(x).max(axis=1, keepdims=True), r,
                        np.zeros(1, np.float32))
    p1, f = [], []
    for fc in (180.0, 180.0, 4000.0, 4000.0):
        b0, b1, b2, a1, a2 = biquad_coefs("lowpass", fc, SR)
        p1.append((-a1 + 1j * np.sqrt(4 * a2 - a1 * a1)) / 2)
        xx = x[:, len(f) % 2].astype(np.float64)
        f.append(b0 * xx + b1 * np.r_[0.0, xx[:-1]]
                 + b2 * np.r_[0.0, 0.0, xx[:-2]])
    p1 = np.asarray(p1)
    u = complex64(np.stack(f, 1), p1, np.zeros(4)).astype(np.complex64)
    p2 = np.conj(p1).astype(np.complex64)
    out["complex"] = (np.ascontiguousarray(u.real),
                      np.ascontiguousarray(u.imag), p2.real.copy(),
                      p2.imag.copy(), np.zeros(4, np.float32),
                      np.zeros(4, np.float32))
    for name, D, C, g in (("comb", COMB_D, 1, np.float32(0.84) *
                           np.float32(0.94)), ("delay", DELAY_D, 2, 0.35)):
        rows = -(-SCAN_T // D)
        xp = np.zeros((rows * D, C), np.float32)
        xp[:SCAN_T] = x[:, :C]
        out[name] = (xp.reshape(rows, D * C), np.full(D * C, g, np.float32),
                     rng.normal(size=D * C).astype(np.float32))
    return {k: (v, [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in v]) for k, v in out.items()}


def scan_check(name, got, want, y64) -> dict:
    """Kernel and plain within SCAN_F64_RTOL of float64 and within
    SCAN_PLAIN_RTOL of each other, relative to max |y|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(y64).max()))
    check(bool(np.isfinite(got).all()), f"{name} kernel output not finite")
    err = float(np.abs(got - want).max())
    err64 = float(np.abs(got - y64).max())
    plain64 = float(np.abs(want - y64).max())
    check(err64 <= SCAN_F64_RTOL * scale,
          f"{name} kernel vs float64 max |diff| {err64} > {SCAN_F64_RTOL} "
          f"* {scale}")
    check(plain64 <= SCAN_F64_RTOL * scale,
          f"{name} plain vs float64 max |diff| {plain64} > {SCAN_F64_RTOL} "
          f"* {scale}")
    check(err <= SCAN_PLAIN_RTOL * scale,
          f"{name} kernel vs plain max |diff| {err} > {SCAN_PLAIN_RTOL} * "
          f"{scale}")
    return {"max_abs_y": scale, "kernel_vs_plain": err,
            "kernel_vs_f64": err64, "plain_vs_f64": plain64}


def profiled_render(st, fenced: bool):
    """One render_device under torch.profiler (CPU + CUDA): (wall seconds,
    device rows, {effect: [(start_us, end_us), ...]}). With `fenced`, each
    effect's process runs between two synchronizes inside a host range
    "fx:<kind>", so every device row that starts inside that range is the
    effect's own work."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile, record_function

    from termdaw_tpu_torch.ops import fx

    def fenced_process(kind, process):
        def run(*a, **k):
            torch.cuda.synchronize()
            with record_function(f"fx:{kind}"):
                out = process(*a, **k)
                torch.cuda.synchronize()
            return out
        return run

    saved = dict(fx.EFFECTS)
    if fenced:
        for k, e in saved.items():
            fx.EFFECTS[k] = dataclasses.replace(
                e, process=fenced_process(k, e.process))
    try:
        st.fb.set_time(st.compiled.get_time())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st.render_device()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st.compiled.set_time(0)
    finally:
        fx.EFFECTS.update(saved)
    # device rows: kernels, copies and fills; a host range also shows as a
    # device-side annotation of the same name, left out of the rows
    cuda_t = torch.autograd.DeviceType.CUDA
    events = prof.events()
    dev = [e for e in events
           if e.device_type == cuda_t and not e.name.startswith("fx:")]
    ranges: dict[str, list] = {}
    for e in events:
        if e.device_type != cuda_t and e.name.startswith("fx:"):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return wall, dev, ranges


def profile_render(st) -> dict:
    """Two profiled c4 renders. The first, as the render runs: device time
    in all and in each of the port's kernels, device launches, and the
    device busy share of the profiled wall. The second with each effect
    fenced (see profiled_render): the effects' device time."""
    from termdaw_tpu_torch.engine.state import render_chunk_blocks

    def ms(rows) -> float:
        return sum(e.device_time_total for e in rows) / 1e3

    wall, dev, _ = profiled_render(st, fenced=False)
    device_ms = ms(dev)
    check(device_ms > 0, "the profiler saw no device time")
    mine = {}
    for k, name in (("voice_mix", "voice_mix_kernel"),
                    ("affine_scan", "AffineScanOp"),
                    ("max_decay_scan", "max_decay_scan_kernel"),
                    ("complex_scan", "ComplexScanOp")):
        ks = [e for e in dev if name in e.name]
        mine[k] = {"ms": ms(ks), "device_kernels": len(ks)}
    _, fdev, ranges = profiled_render(st, fenced=True)
    fx_ms = {name: ms(e for e in fdev if any(
        lo <= e.time_range.start < hi for lo, hi in spans))
        for name, spans in ranges.items()}
    eq3_complex = ms(e for e in fdev if "ComplexScanOp" in e.name)
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "effects_device_ms": fx_ms,
            "effects_share_of_device": sum(fx_ms.values()) / ms(fdev),
            # every complex scan of c4 runs in the eq3: a check of the
            # attribution
            "eq3_holds_complex_scans": fx_ms.get("fx:eq3", 0.0) >=
            eq3_complex,
            "device_launches": len(dev),
            "windows": -(-st.cs // render_chunk_blocks(st.cs)),
            "kernels": mine}


def render_wav(fixtures, d, device, packets, wav):
    st = fixtures.load_state(d, device, packets)
    st.render()
    torch.cuda.synchronize()
    return st, *fixtures.read_wav_ints(wav)


def compare(name, gpu, cpu, bd, rate, want_rate, want_len) -> dict:
    check(rate == want_rate, f"{name} WAV rate {rate} != {want_rate}")
    check(gpu.shape == cpu.shape == (want_len,),
          f"{name} WAV lengths {gpu.shape} / {cpu.shape} != {want_len}")
    full = 2 ** (bd - 1)
    peak = int(np.abs(gpu).max())
    check(peak > full // 2, f"{name} peak {peak} is not near full scale "
                            f"after Normalize")
    diff = int(np.abs(gpu - cpu).max())
    bound = max(1, int(1e-5 * full))
    check(diff <= bound, f"{name} GPU vs CPU max |diff| {diff} > {bound}")
    return {"ints": int(gpu.size), "peak": peak, "max_abs_diff": diff,
            "bound": bound, "bit_exact": diff == 0}


def wall_render(st, reps: int) -> list[float]:
    """Seconds of render_device + synchronize, after one warm-up."""
    out = []
    for i in range(reps + 1):
        st.fb.set_time(st.compiled.get_time())
        t0 = time.perf_counter()
        chunks = st.render_device()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(len(chunks) == 1, "render_device returned no chunk")
        st.compiled.set_time(0)
        if i:
            out.append(dt)
    return out


def event_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    # 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    count = torch.cuda.device_count()
    kind = torch.cuda.get_device_name(0)
    emit("environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device_count=count, kind=kind)

    from termdaw_tpu_torch.engine.sink import Sink

    from termdaw_tpu_torch import kernels
    from termdaw_tpu_torch.engine.player import Player
    from termdaw_tpu_torch.ops import scan, voices
    from termdaw_tpu_torch.utils import fixtures

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")

    def reset_counts():
        voices.launches = scan.launches = 0
        scan.max_decay_launches = scan.complex_launches = 0

    # 2. build
    t0 = time.perf_counter()
    libs = kernels.build_all(kernels.KERNELS)
    for name in kernels.KERNELS:
        getattr(kernels, f"{name}_lib")()
    emit("build", seconds=time.perf_counter() - t0, ptxas={
        f"termdaw_tpu_torch/csrc/{name}.cu": [
            ln.strip() for ln in lib.with_suffix(".log").read_text()
            .splitlines() if "registers" in ln or "spill" in ln]
        for name, lib in libs.items()})

    # 3. kernel vs plain at c5's shapes
    args = kernel_inputs(cuda)
    got = voices.voice_mix_stereo(*args, C5_NB, BL)
    torch.cuda.synchronize()
    want = voices.voice_mix_stereo_plain(*args, C5_NB, BL)
    max_err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    check(max_err <= KERNEL_ATOL,
          f"kernel vs plain max |diff| {max_err} > {KERNEL_ATOL}")
    emit("kernel_vs_plain", nb=C5_NB, bl=BL, P=C5_P, max_abs_err=max_err,
         atol=KERNEL_ATOL, bit_exact=bool(torch.equal(got, want)))

    # 4. scan kernel vs plain at c3's band-pass shape
    sargs = scan_inputs(cuda)
    sgot = scan.affine_scan(*sargs)
    torch.cuda.synchronize()
    swant = scan.affine_scan_plain(*sargs)
    y64 = recurrence64(*(v.cpu().numpy() for v in sargs))
    scale = max(1.0, float(np.abs(y64).max()))
    check(bool(torch.isfinite(sgot).all()), "scan kernel output not finite")
    scan_err = float((sgot - swant).abs().max())
    err64 = float(np.abs(sgot.cpu().numpy() - y64).max())
    plain64 = float(np.abs(swant.cpu().numpy() - y64).max())
    check(err64 <= SCAN_F64_RTOL * scale,
          f"scan kernel vs float64 max |diff| {err64} > {SCAN_F64_RTOL} * "
          f"{scale}")
    check(plain64 <= SCAN_F64_RTOL * scale,
          f"scan plain vs float64 max |diff| {plain64} > {SCAN_F64_RTOL} * "
          f"{scale}")
    check(scan_err <= SCAN_PLAIN_RTOL * scale,
          f"scan kernel vs plain max |diff| {scan_err} > {SCAN_PLAIN_RTOL} "
          f"* {scale}")
    slow = slow_pole_inputs(cuda)
    host, dev = slow["affine"]
    sgot_slow = scan.affine_scan(*dev)
    torch.cuda.synchronize()
    affine_slow = slow_check(
        "affine slow pole", [sgot_slow.cpu()],
        [scan.affine_scan_plain(*dev).cpu()], [recurrence64(*host)])
    emit("scan_kernel_vs_plain", T=SCAN_T, C=SCAN_C, max_abs_y=scale,
         kernel_vs_plain=scan_err, kernel_vs_f64=err64, plain_vs_f64=plain64,
         rtol_f64=SCAN_F64_RTOL, rtol_plain=SCAN_PLAIN_RTOL,
         slow_pole=dict(a=SLOW_POLE, **affine_slow))

    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        tmp = Path(tmp)
        # 5. c5 end to end
        d5 = tmp / "c5"
        packets = fixtures.write_c5_project(d5, SECONDS, SR, BL, n_tracks=64,
                                            hit_sr=96000, bd=32)
        reset_counts()
        t0 = time.perf_counter()
        st5, gpu5, rate5 = render_wav(fixtures, d5, cuda, packets,
                                      d5 / "mix.wav")
        c5_wall = time.perf_counter() - t0
        launches = voices.launches
        check(launches > 0, "the c5 render launched no voice-mix kernel")
        _, cpu5, _ = render_wav(fixtures, d5, cpu, packets, d5 / "mix.wav")
        emit("c5_end_to_end", tracks=64, seconds=SECONDS, sr=SR, bd=32,
             voice_mix_launches=launches,
             fused_slots=[c["pf"] for k, c in st5.compiled.bake_caps.items()
                          if k.startswith("fused")],
             first_render_wall_s=c5_wall,
             **compare("c5", gpu5, cpu5, 32, rate5, SR,
                       2 * st5.cs * BL))

        # 6. c1 end to end
        d1 = tmp / "c1"
        fixtures.write_c1_project(d1, SECONDS, SR, BL, render_sr=44100,
                                  bd=16)
        st1, gpu1, rate1 = render_wav(fixtures, d1, cuda, b"",
                                      d1 / "outp.wav")
        _, cpu1, _ = render_wav(fixtures, d1, cpu, b"", d1 / "outp.wav")
        emit("c1_end_to_end", seconds=SECONDS, sr=SR, render_sr=44100,
             bd=16,
             **compare("c1", gpu1, cpu1, 16, rate1, 44100,
                       2 * -(-st1.cs * BL * 147 // 160)))

        # 7. c2 and c3 end to end
        st23 = {}
        for cfg, write in (("c2", fixtures.write_c2_project),
                           ("c3", fixtures.write_c3_project)):
            d = tmp / cfg
            write(d, SECONDS, SR, BL)
            reset_counts()
            t0 = time.perf_counter()
            st, gpu, rate = render_wav(fixtures, d, cuda, b"",
                                       d / "outp.wav")
            wall = time.perf_counter() - t0
            counts = {"voice_mix": voices.launches,
                      "affine_scan": scan.launches}
            if cfg == "c3":
                scan_launches = scan.launches
                check(scan_launches > 0,
                      "the c3 render launched no affine-scan kernel")
            _, cpu_ints, _ = render_wav(fixtures, d, cpu, b"",
                                        d / "outp.wav")
            emit(f"{cfg}_end_to_end", seconds=SECONDS, sr=SR, bd=16,
                 launches=counts, first_render_wall_s=wall,
                 **compare(cfg, gpu, cpu_ints, 16, rate, SR,
                           2 * st.cs * BL))
            st23[cfg] = st

        # 8. playback on the card
        class CaptureSink(Sink):
            def __init__(self) -> None:
                self.chunks: list[np.ndarray] = []

            def queue_audio(self, interleaved: np.ndarray) -> None:
                self.chunks.append(np.array(interleaved, np.float32))

        sink = CaptureSink()
        player = Player(fixtures.load_state(tmp / "c2", cuda), sink, SR, BL)
        player.play()
        check(len(sink.chunks) == 1, "play() did not queue one prebuffer")
        nb = Player.PREBUFFER_BLOCKS
        ref_st = fixtures.load_state(tmp / "c2", cpu)
        want = ref_st.compiled.render_window(ref_st.fb, nb).numpy()
        pre_err = float(np.abs(sink.chunks[0] - want.reshape(-1)).max())
        check(pre_err <= PLAYER_ATOL,
              f"prebuffer vs CPU max |diff| {pre_err} > {PLAYER_ATOL}")
        ticked = 0
        for _ in range(4):
            time.sleep(0.05)
            ticked += player.tick()
        check(ticked >= 1, "tick() rendered nothing while playing")
        check(all(np.isfinite(c).all() for c in sink.chunks),
              "playback queued non-finite audio")
        player.stop()
        emit("playback", project="c2", prebuffer_blocks=nb,
             prebuffer_max_abs_diff=pre_err, atol=PLAYER_ATOL,
             ticked_blocks=ticked, chunks=len(sink.chunks))

        # 9. the effects' scans at c4's shapes
        fxin = fx_scan_inputs(cuda)
        host, dev = fxin["max_decay"]
        mgot = scan.max_decay_scan(*dev)
        torch.cuda.synchronize()
        mres = scan_check("max_decay", mgot.cpu(),
                          scan.max_decay_scan_plain(*dev).cpu(),
                          max_decay64(*host))
        host, dev = fxin["complex"]
        cgot = scan.complex_affine_scan(*dev)
        torch.cuda.synchronize()
        cwant = scan.complex_affine_scan_plain(*dev)
        c64 = complex64(host[0] + 1j * host[1].astype(np.float64),
                        host[2] + 1j * host[3].astype(np.float64),
                        np.zeros(4))
        cres = {part: scan_check(f"complex_{part}", g.cpu(), w.cpu(), y)
                for part, g, w, y in (("re", cgot[0], cwant[0], c64.real),
                                      ("im", cgot[1], cwant[1], c64.imag))}
        host, dev = slow["complex"]
        sgot_slow = scan.complex_affine_scan(*dev)
        torch.cuda.synchronize()
        s64 = complex64(host[0] + 1j * host[1].astype(np.float64),
                        host[2] + 1j * host[3].astype(np.float64),
                        np.zeros(SCAN_C))
        cres["slow_pole"] = dict(
            abs_p=SLOW_POLE, hz=SLOW_HZ,
            **slow_check("complex slow pole", [g.cpu() for g in sgot_slow],
                         [w.cpu() for w in
                          scan.complex_affine_scan_plain(*dev)],
                         [s64.real, s64.imag]))
        fres = {}
        for name in ("comb", "delay"):
            host, dev = fxin[name]
            fgot = scan.affine_scan(*dev)
            torch.cuda.synchronize()
            fres[name] = scan_check(name, fgot.cpu(),
                                    scan.affine_scan_plain(*dev).cpu(),
                                    recurrence64(*host))
        emit("fx_scans_vs_plain", T=SCAN_T, max_decay=mres, complex=cres,
             comb_D=COMB_D, comb=fres["comb"], delay_D=DELAY_D,
             delay=fres["delay"], rtol_f64=SCAN_F64_RTOL,
             rtol_plain=SCAN_PLAIN_RTOL)

        # 10. c4 end to end
        d4 = tmp / "c4"
        fixtures.write_c4_project(d4, SECONDS, SR, BL, render_sr=44100,
                                  bd=16)
        reset_counts()
        t0 = time.perf_counter()
        st4, gpu4, rate4 = render_wav(fixtures, d4, cuda, b"",
                                      d4 / "outp.wav")
        c4_wall = time.perf_counter() - t0
        c4_counts = {"voice_mix": voices.launches,
                     "affine_scan": scan.launches,
                     "max_decay_scan": scan.max_decay_launches,
                     "complex_scan": scan.complex_launches}
        for k, n in c4_counts.items():
            check(n > 0, f"the c4 render launched no {k} kernel")
        _, cpu4, _ = render_wav(fixtures, d4, cpu, b"", d4 / "outp.wav")
        emit("c4_end_to_end", seconds=SECONDS, sr=SR, render_sr=44100,
             bd=16, launches=c4_counts, first_render_wall_s=c4_wall,
             **compare("c4", gpu4, cpu4, 16, rate4, 44100,
                       2 * -(-st4.cs * BL * 147 // 160)))

        # 11. timings
        c5_s = wall_render(st5, 5)
        c1_s = wall_render(st1, 5)
        c2_s = wall_render(st23["c2"], 5)
        c3_s = wall_render(st23["c3"], 5)
        c4_s = wall_render(st4, 5)
        # each kernel at its main-path shape, and the tiled scans at every
        # shape c3 and c4 run them at: device time beside the bound
        vm_bytes = sum(a.numel() * a.element_size() for a in args) + \
            C5_NB * BL * 2 * 4
        dev = fxin["max_decay"][1]
        T, C = dev[0].shape
        per_kernel = {
            "voice_mix_stereo": timed(
                lambda: voices.voice_mix_stereo(*args, C5_NB, BL),
                lambda: voices.voice_mix_stereo_plain(*args, C5_NB, BL),
                vm_bytes, 2 * C5_NB * C5_P * BL * 2),
            "max_decay_scan": timed(
                lambda: scan.max_decay_scan(*dev),
                lambda: scan.max_decay_scan_plain(*dev),
                (2 * T * C + 2 * C) * 4, 2 * T * C),
        }
        gen = np.random.default_rng(4)
        affine_t = {}
        for name, (T, C) in affine_shapes().items():
            ab = [torch.from_numpy(v).to(cuda) for v in (
                gen.normal(size=(T, C)).astype(np.float32),
                np.full(C, 0.9, np.float32), np.zeros(C, np.float32))]
            affine_t[name] = dict(shape=[T, C], **timed(
                lambda: scan.affine_scan(*ab),
                lambda: scan.affine_scan_plain(*ab),
                (2 * T * C + 2 * C) * 4, 2 * T * C))
        dev = fxin["complex"][1]
        T, C = dev[0].shape
        complex_t = {"eq3_stage": dict(shape=[T, C], **timed(
            lambda: scan.complex_affine_scan(*dev),
            lambda: scan.complex_affine_scan_plain(*dev),
            (4 * T * C + 4 * C) * 4, 8 * T * C))}
        per_kernel["affine_scan"] = affine_t["band_pass"]
        per_kernel["complex_affine_scan"] = complex_t["eq3_stage"]
        emit("timings", card=card,
             c5_render_device_s=c5_s, c5_median_s=statistics.median(c5_s),
             c1_render_device_s=c1_s, c1_median_s=statistics.median(c1_s),
             c2_render_device_s=c2_s, c2_median_s=statistics.median(c2_s),
             c3_render_device_s=c3_s, c3_median_s=statistics.median(c3_s),
             c4_render_device_s=c4_s, c4_median_s=statistics.median(c4_s),
             voice_mix_stereo=per_kernel["voice_mix_stereo"],
             max_decay_scan=per_kernel["max_decay_scan"],
             affine_scan=affine_t, complex_affine_scan=complex_t)

        # 12. a profile of one c4 render
        emit("c4_profile", card=card, **profile_render(st4))

    print(card, flush=True)
    rows = (
        ("voice_mix_stereo", "voice_mix", "termdaw_tpu/ops/pallas_voices.py:50",
         launches, max_err),
        ("affine_scan", "affine_scan", "termdaw_tpu/ops/filters.py:72",
         scan_launches, scan_err),
        ("max_decay_scan", "max_decay_scan", "termdaw_tpu/ops/fx.py:63",
         c4_counts["max_decay_scan"], mres["kernel_vs_plain"]),
        ("complex_affine_scan", "complex_scan",
         "termdaw_tpu/ops/filters.py:316", c4_counts["complex_scan"],
         max(cres[p]["kernel_vs_plain"] for p in ("re", "im"))),
    )
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"termdaw_tpu_torch/csrc/{src}.cu",
        "replaces": replaces,
        "launches": n,
        "max_abs_err": err,
        "ms": per_kernel[name]["ms"],
        "plain_ms": per_kernel[name]["plain_ms"],
        "bound_ms": per_kernel[name]["bound_ms"],
        "bound_by": per_kernel[name]["bound_by"],
        # no single PyTorch call computes a first-order recurrence, a
        # max-decay scan or the voice mix
        "library_ms": None,
    } for name, src, replaces, n, err in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
