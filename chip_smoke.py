#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (termdaw_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero without
the final line:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
2. build: compiles csrc/voice_mix.cu and csrc/affine_scan.cu with nvcc
   for sm_90a, one nvcc process each, in parallel;
3. the voice-mix kernel against its plain PyTorch version on the card at
   the c5 render's shapes (375 blocks of 1024 frames, 16 slots, a
   two-sample concat buffer), tolerance 1e-6;
4. the affine-scan kernel against its plain version at c3's band-pass
   shape (one window of 375 blocks x 1024 frames, 4 lanes, the gammas of
   8000 Hz and 30 Hz at 48 kHz, a seeded input): both within 1e-4 of a
   float64 recurrence and within 1e-5 of each other, relative to max |y|;
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
9. timings after one warm-up: render_device wall time (synchronized) for
   c5, c1, c2 and c3, and each kernel against its plain version (CUDA
   events).

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

    from termdaw_tpu.engine.sink import Sink

    from termdaw_tpu_torch import kernels
    from termdaw_tpu_torch.engine.player import Player
    from termdaw_tpu_torch.ops import scan, voices
    from termdaw_tpu_torch.utils import fixtures

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")

    def reset_counts():
        voices.launches = scan.launches = 0

    # 2. build
    t0 = time.perf_counter()
    libs = kernels.build_all(["voice_mix", "affine_scan"])
    kernels.voice_mix_lib()
    kernels.affine_scan_lib()
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
    emit("scan_kernel_vs_plain", T=SCAN_T, C=SCAN_C, max_abs_y=scale,
         kernel_vs_plain=scan_err, kernel_vs_f64=err64, plain_vs_f64=plain64,
         rtol_f64=SCAN_F64_RTOL, rtol_plain=SCAN_PLAIN_RTOL)

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

        # 9. timings
        c5_s = wall_render(st5, 5)
        c1_s = wall_render(st1, 5)
        c2_s = wall_render(st23["c2"], 5)
        c3_s = wall_render(st23["c3"], 5)
        kernel_ms = event_ms(
            lambda: voices.voice_mix_stereo(*args, C5_NB, BL), 50)
        plain_ms = event_ms(
            lambda: voices.voice_mix_stereo_plain(*args, C5_NB, BL), 20)
        scan_ms = event_ms(lambda: scan.affine_scan(*sargs), 50)
        scan_plain_ms = event_ms(lambda: scan.affine_scan_plain(*sargs), 20)
        emit("timings", card=card,
             c5_render_device_s=c5_s, c5_median_s=statistics.median(c5_s),
             c1_render_device_s=c1_s, c1_median_s=statistics.median(c1_s),
             c2_render_device_s=c2_s, c2_median_s=statistics.median(c2_s),
             c3_render_device_s=c3_s, c3_median_s=statistics.median(c3_s),
             voice_mix_kernel_ms=kernel_ms, voice_mix_plain_ms=plain_ms,
             affine_scan_kernel_ms=scan_ms,
             affine_scan_plain_ms=scan_plain_ms)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "voice_mix_stereo",
        "route": "cuda",
        "source": "termdaw_tpu_torch/csrc/voice_mix.cu",
        "replaces": "termdaw_tpu/ops/pallas_voices.py:50",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "affine_scan",
        "route": "cuda",
        "source": "termdaw_tpu_torch/csrc/affine_scan.cu",
        "replaces": "termdaw_tpu/ops/filters.py:72",
        "launches": scan_launches,
        "max_abs_err": scan_err,
        "ms": scan_ms,
        "plain_ms": scan_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
