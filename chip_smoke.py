#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (termdaw_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero without
the final line. Every single-device window replays a CUDA graph captured
from the window program (graph/compile.py's program cache), so a kernel
wrapper counts each program's eager warm-up and its capture, never a
replay. Each render below is gated on replays == windows (`replays`,
`captures`) and on its wrapper counts being twice its programs' captured
launches; the launches it reports are what ran on the card, the captured
launches times the replays plus the warm-ups (`path_launches`), and
phase 12 gates those of a replayed c4 render against its device rows.

1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
2. build: compiles every kernel (csrc/voice_mix.cu, affine_scan.cu,
   max_decay_scan.cu, complex_scan.cu, biquad_seq.cu, sampsyn.cu, eq3.cu,
   synth.cu) with nvcc for
   sm_90a, one nvcc process each, all in parallel, and prints each
   compiled kernel's registers, shared memory and spills (ptxas); the
   exact lane's SASS (cuobjdump) must hold no FFMA;
3. the voice-mix kernel against its plain PyTorch version on the card at
   the c5 render's shapes (375 blocks of 1024 frames, 16 slots), in both
   regimes of kernels.voice_mix_plan: a two-sample concat buffer staged
   in shared memory, and a 30 s sample streamed from global memory; both
   bit-exact;
4. the affine-scan kernel against its plain version at c3's band-pass
   shape (one window of 375 blocks x 1024 frames, 4 lanes, the gammas of
   8000 Hz and 30 Hz at 48 kHz, a seeded input): both within 1e-4 of a
   float64 recurrence and within 1e-5 of each other, relative to max |y|;
   and a slow pole (a = 0.9999, same shape), where the kernel must be
   within 1e-4 of float64 relative to max |y| (the plain version's
   distance is printed, not gated); then the SampSyn kernel
   (csrc/sampsyn.cu) against its plain version at c4's chord shape (375
   blocks of 1024 frames, 8 slots over 64 notes, the default 2 x 2048
   wavetable; utils/fixtures.sampsyn_window), within 2e-6 (only the
   order of the sum over slots differs); phase 11
   prints its line: the max |diff|, the kernel's device ms, the plain
   version's ms and the bytes bound at 3.35 TB/s;
5. c5 end to end (64 streamed SampleMulti tracks, 48 kHz / 1024, 40 s,
   32-bit, a 96 kHz hit resampled on import): refresh + render on cuda,
   the kernel launch counts of that run, its replays and captures, and
   the WAV against the port's CPU render of the same project (|diff| <=
   max(1, 1e-5 * 2^(bd-1)));
6. c1 end to end (two SampleLoops -> Normalize, 48 kHz -> 44.1 kHz
   16-bit), with the same comparison;
7. c2 end to end (SampleLerp kick, an Adsr envelope ducking a looping
   pad, 48 kHz / 1024, 40 s, 16-bit) and c3 end to end (Synth and SampSyn
   through a BandPass, same format), with the same comparison; the c3 run
   must launch the affine-scan, SampSyn and Synth kernels;
8. playback: the port's Player on cuda with c2 and a capturing sink;
   play() queues the 16-block prebuffer, equal to the CPU render of the
   same blocks (atol 1e-5); a few tick()s queue more finite audio;
9. the effects' scans at c4's shapes, each kernel against its plain
   version and a float64 recurrence (the rules of phase 4): max-decay at
   one compressor window (375 x 1024 frames, 1 lane, release 250 ms at
   48 kHz), and a long slow decay (that release from one peak over
   100,003 frames) within 1e-5 of float64 relative to max |y|;
   complex-scan at one eq3 stage (375 x 1024 frames, 4 lanes, the poles
   of the 180 Hz and 4 kHz crossovers), affine-scan at the
   feedback lines (the longest reverb comb, D = 1785, 1 lane; the delay,
   D = 5760, 2 lanes); and complex-scan at a slow pole (|p| = 0.9999, the
   conjugate pair at 20 Hz), checked as phase 4's slow pole;
10. c4 end to end (the reference's demo project with the reverb ->
   compressor -> eq3 -> delay chain, 48 kHz / 1024, 40 s -> 44.1 kHz
   16-bit): refresh + render on cuda, which must launch all six kernels
   of its path (the voice mix, affine and max-decay scans, SampSyn, the
   Synth and the eq3; the complex scan only runs sharded), and the WAV
   against the port's CPU render, as in phase 5; then the
   project's own SampSyn windows, run eager (375 blocks each, the whole
   40 s): each window's sampsyn call on the card (the kernel) against
   sampsyn_plain on the same bake, frames and in-block clock, within
   phase 4's 2e-6, the chords' slots filled 3 deep at least;
11. timings after one warm-up: render_device wall time (synchronized),
   the median of 5, for c5, c1, c2, c3 and c4; each kernel against its
   plain version (CUDA events per wrapper call); and each kernel's device
   time per call (torch.profiler, all the kernels a call launches; a
   trace that lost rows is taken again) beside
   its bound (the (flops, bytes) its wrapper records, the `*_work`
   functions beside the wrappers: bytes read and written once at one H100
   SXM's 3.35 TB/s, or f32 operations at its 67 TFLOP/s, from
   utils/roofline.chip_peaks) and the share of the bound it reaches: the
   scans at
   every shape c3 and c4 run them at, the max-decay also at [1025, 4],
   the voice mix in both regimes;
12. torch.profiler traces of three c4 renders: replayed from graphs and
   eager (`render_window(..., eager=True)`), each as it runs (device time
   in all and in each kernel, device rows, device busy share of the wall;
   in the replayed one each kernel's calls on the card must equal its
   programs' captured launches times their replays), then
   eager with each effect fenced by synchronizes (the effects' device
   time);
13. the exact biquad lane's kernel (csrc/biquad_seq.cu) against its plain
   version with the c4 eq3's stage coefficients (lowpass and highpass at
   the 180 Hz and 4 kHz crossovers, 48 kHz) on a seeded input: bit-exact
   over two consecutive [48,000, 4] windows, the state carried; at the
   full [384,000, 4] stage shape bit-exact too, and within 5e-5 of max
   |y| of a float64 lfilter; device ms per call (between CUDA events:
   torch.profiler loses some of this kernel's rows) beside its bound, the
   latency of its serial chain (12 cycles a frame at 1.98 GHz);
14. c4 with TERMDAW_EXACT_BIQUAD=1 on the card: the render's replays
   launch the kernel 20 times (its programs' captured launches times
   their replays) and the complex scan and the eq3 kernel never; the
   median of 5 walls;
   the distance in 16-bit counts to phase 10's default-lane render
   (gated at 2e-3 of full scale); the project cut to 1 s rendered on the
   card and on the CPU within one count;
15. a stream session on c4 with two live streams (full project, cuda):
   a writer thread feeds an os.pipe with drum and note packets every
   100 ms for 10 s; a sink that drains in real time captures the audio;
   the Player is paused after 30 s of wall, since a 1-block window
   slower than a block keeps tick() catching up for good. Gated: the
   events were appended, the audio is finite and non-zero after the
   first event, every window a replay. Printed: blocks rendered, the
   window sizes tick() picked, underruns, the queued lead, the session's
   wall and whether the deadline paused it, render_window walls at nb =
   1, 4 and 32, the programs cached and the memory their captures added
   to the graph's one pool;
16. chains: c5 and c3 rendered twice each with chains (the default) and
   with TERMDAW_PREBAKE=0, the WAVs bit-identical; windows served, host
   bake ms a render and the median walls each way; then c5 under
   TERMDAW_VOICE_CAP=2: finite, every voice table at most 2 voices a
   (block, member);
17. TERMDAW_PROFILE: one c4 render with it set writes a Chrome trace
   that holds the whole render's program spans (render.device, window,
   fetch, wav write, ...) as user annotations; the trace's top host ops
   by self CPU time and the device busy share;
18. sharded scans and renders (termdaw_tpu_torch/tools/shard_render.py)
   on 4 ranks, one process each (parallel/mesh.launch): NCCL with a card
   a rank where the machine has 4 cards, else gloo with the 4 ranks on
   cuda:0 (the lines name which). First the sharded primitives with CUDA
   tensors at c4's shard shapes (131,072 and 86,016 frames a rank): the
   one-pole scan, the max-decay, the eq3's two biquad cascades and c4's
   21 feedback lines (comb, allpass and delay lengths; offset
   (rank*T) mod D != 0 on ranks 1-3), each against the plain scans over
   the whole input on the CPU: within 1e-5 of max |y| (the cascade
   1e-4), final states equal on every rank and within 1e-4 (the cascade
   1e-3), and every rank launching the kernel twice a sharded scan (the
   summary from the identity seed, then the seeded scan); the line gives
   each kernel's max |diff|. Then c4 and c5 at the full shape. Gated:
   every rank launches the voice mix, affine, max-decay and complex kernels on c4
   (the voice mix on c5), each render is 4 sharded windows (3 x 512 +
   336 blocks) and 1 window of 3 blocks every rank renders alone, rank
   0's WAV is within 2/32768 of full scale of the single-rank card
   render (phases 5 and 10), each rank's sharded program entries are
   captured over NCCL and eager over gloo (a gloo collective cannot be
   captured), and a failure in any rank fails the phase. Printed: which
   the entries are, the median of 3 sharded walls (rank 0's
   render_device) through the program cache and with every sharded
   window eager (`render_window_sharded(..., eager=True)`), in turns,
   beside the single-rank medians served from a chain and live
   (TERMDAW_PREBAKE=0), and the host seconds rank 0 spent in collectives;
19. the program cache: c5, c1, c2, c3 and c4 each loaded and rendered
   four times, eager (`eager=True`), from graphs, from graphs,
   eager, in one process: the WAVs bit-identical, every graph window a
   replay. Printed for each run: the median of 5 render_device walls,
   the host's enqueue rows a window (cudaLaunchKernel, cudaGraphLaunch,
   copies and fills under torch.profiler) and the device rows a window;
   for graphs, each program's window size, warm-up and capture ms (its
   first window), the MB its capture added to the graph's pool and its
   captured kernel launches; for c4, the render_window walls at nb = 1, 4
   and 32 and the pool with those programs in. Gated: c4's replayed windows
   enqueue at most 8 operations each. Then phase 15's stream session
   again on the eager program, both sessions' underruns, leads and
   window sizes side by side;
20. the native host library (termdaw_tpu_torch/native/, compiled with
   g++ in phase 2 into termdaw_tpu_torch/build/): the compiler's version,
   the build's seconds (or "cached") and the .so; c4 at 24 bits on the
   card from graphs (all six default-path kernels launched), its WAV
   written through the native pack24 (counted in `native.calls`) and
   through the numpy body in turns, 3 renders each, byte-identical, and
   within phase 5's bound of the port's CPU render; the program's
   `fetch` + `wav write` spans (utils/prof, recorded) and the render()
   wall each way beside the median of 5 render_device walls; the
   render's ints packed and unpacked native and numpy (medians of 5, in
   turns). Then phase 15's stream bytes
   decoded in 4096-byte reads and in one blob, native (scans counted)
   and numpy, the same packets; the two headers whose declared size the
   scanner rejects (2^25 events, 2^29 bytes of text) raising PacketError;
   a 30 s 24-bit sample loaded by SampleBank both ways (unpacks counted),
   the same samples;
21. sharded windows from captured graphs: a 1-rank NCCL world on cuda:0
   (`tools/shard_render.replay_check`; NCCL refuses two ranks on one
   card), where c4 and c5 at the full shape render the windows of a
   4-rank render (3 x 512 + 336 blocks, from t = 0) through
   `render_window_sharded`, one State through the program cache and one
   eager, in lockstep, then 5 more passes each way in turns. Gated: the
   audio and the numeric state bit-identical eager against replayed,
   every window a replay, every program captured with all its collectives
   (as many as the eager program issues a window) and, on c4, the six
   kernels of its sharded path (c5: the voice mix), each launched in the first
   pass (wrapper counts set to 0 just before it). Printed: the window
   walls (medians eager and
   replayed), the host's enqueue rows a window each way, each program's
   warm-up and capture ms, pool MB and captured collectives;
22. the shipped examples and the stream pipe through the port's CLI, in
   child processes that block jax and the JAX package and fail if any
   of their modules was loaded: a fresh copy of examples/ without
   assets/; project, sample-project, neg-adsr-env, synth-adsr-fx and
   generative each opened by `python -m termdaw_tpu_torch` on cuda with
   `render` and `quit` on stdin (TERMDAW_SINK=null; the first run's
   make_assets.py hook generates the assets through
   utils/example_assets.py), the WAV within phase 5's bound of the port's
   CPU render at full length (40 s, generative 16 s); each also rendered
   in this process on the card, within that bound too, every window a
   replay, and the five together launching the voice mix, affine,
   max-decay, SampSyn and Synth kernels (`path_launches`). Printed: each example's CLI wall,
   render_device median of 5 and launches, and the assets' generation
   seconds. Then `python -m termdaw_tpu_torch.tools.stream_gen --duration
   12 --streams kick,snare,hihat,ride,bass,chords` (paced) piped into
   the CLI on the copy of examples/stream (TERMDAW_SINK=file:...,
   TERMDAW_STREAM_IDLE=3): both exit 0, and the capture passes
   tools/test_stream.sh's checks (more than 3 s, peak above 0.2, a
   nonzero-frame ratio above 0.25). Printed: the captured seconds, the
   peak, the ratio and the session's wall;
23. the roofline (utils/roofline.py): c5, c1, c2, c3 and c4 each loaded
   fresh on the card (rendered once, so its window programs are captured)
   and on the CPU; CompiledGraph.window_cost at every window size of the
   render, counted on both devices, must give equal flops, bytes accessed
   and arg, out and temp bytes (a mismatch names the aten ops whose counts
   differ); then config_roofline over phase 19's graph and eager
   render_device medians. Printed: each window's counts (op calls, the
   kernels' records, the top ops by bytes), each config's dicts with the
   card's name and power limit (GFLOP/s, logical and phys-est GB/s, their
   shares of the card's peaks where chip_peaks knows the card, and the
   bound), the reference's analytic floor beside them, and the phase's
   seconds;
24. c6_stream256 and c7_stream1024 (utils/fixtures.py's BUILDERS: c5's
   project with 256 and 1024 streamed tracks) rendered on the card from
   fresh States (the voice mix launched, every window a replay), each WAV
   within phase 5's bound of the port's CPU render; and the voice mix at
   c6's and c7's shapes (the arguments of each one's first 375-block
   window, recorded from an eager window: 64 and 128 slots at 40 s, c7's
   four 32-slot chunks) bit-exact to its plain version and timed beside
   its bound (at 128 slots the operations bound it).
25. parity with the float64 per-frame oracle (tests/oracle.py):
   `python -m termdaw_tpu_torch.tools.parity_report` with --device cuda
   --full with --device cuda and with --device cpu, in two children
   started together with jax and the JAX package blocked: its five toy
   configs (4 kHz, 128-frame blocks, 24 blocks), config1 at 48 kHz / 1024
   over 40 s and config3 at 48 kHz / 1024 over 564 blocks. Gated: both
   exit 0; every entry within its gate (parity_report.GATES, the
   tolerances of tests/test_torch_oracle.py: config1 2e-4, config2 1e-3,
   config3 2e-3, config4's 8- against 3-block invariance 1e-4, config5
   2e-3 on the fused voice-mix path) and under its drift ceiling
   (parity_report.DRIFT_CEILING_DBFS, 10 dB over its reading); the card's
   max |err| within PARITY_CARD_VS_CPU times the CPU's for each entry; on
   the card config3 (both shapes) launched the affine scan, config4 the
   affine and max-decay scans, config5 the voice mix. Printed: each
   entry's dBFS figures, race frames, max |err| and the card's launches,
   card and CPU side by side.
26. the reference's behaviour suites (tests/test_engine.py and the eight
   others, mirrored in tests/test_torch_ref_*.py): (a) c4 at 40 s twice,
   one State with TERMDAW_EXACT_BIQUAD=1 and one without, each rendered
   alone, then in two rounds two fresh States rendered from two threads
   at once after the program cache is cleared (both capture together):
   each WAV bit-identical to its lane's render alone, the exact lane's
   programs holding csrc/biquad_seq.cu, the cascade's csrc/eq3.cu;
   (b) 30 feed/render cycles on c5 (one event fed to a stream each): every
   render finite, the chains within their budget, a capture only in the
   first cycle or where the bake caps grew, and the reserved memory over
   cycles 11-30 at or under its most over cycles 1-10 plus what later
   captures added; (c) `python -m pytest -m cuda` over the mirrors in a
   child with jax and the JAX package blocked: exit 0, every collected
   card case passed, none skipped. Printed: the walls, captures and
   capture ms, the reserved MB a cycle, the pytest counts and wall.
27. the eq3 kernel (csrc/eq3.cu, fx.eq3_crossover): at c8's and c4's window
   ([384,000, 2] in; one of c8's crossover pairs and c4's), two windows
   with the state carried, against the plain composition (fx.eq3_plain:
   biquad_apply and the complex scan), within 1e-4 of max |y|, audio and
   state; its device ms (20 calls captured in a CUDA graph, replayed
   between CUDA events) beside its bound (the wrapper's work, the four
   stages' [T, 4] read and written once, at 3.35 TB/s; and the floor of x
   read and y written once) and the plain composition's ms. Then c8
   (benchmark/projects/mix_session.py, its 64 tracks and master eq3) on the
   card: each pass of its window program, the eager warm-up and the
   capture, adds 65 to `eq3_launches` and nothing to `complex_launches`
   (every program captured 65 eq3 launches, one an eq3 arm), and so does
   an eager window.
28. the Synth kernel (csrc/synth.cu, synthv.synth): at c9's window (375
   blocks of 1024 frames, 32 slots half of them empty, all three
   oscillators on the session's ADSR; utils/fixtures.synth_window) and at
   c4's bass (2 slots, square and top-flat on two ADSRs, the triangle
   off) against synthv.synth_plain on the card, within 1e-5 and 2e-6
   (each slot's value is the plain version's; only the order of the sum
   over slots differs); its device ms (20 calls captured in a CUDA graph,
   replayed between CUDA events) beside its bound (the wrapper's work, f32
   operations at 67 TFLOP/s or bytes at 3.35 TB/s) and the plain
   version's ms. Then c9 (benchmark/projects/poly_session.py, 16 Synths
   and 16 SampSyns) on the card: each pass of its window program, the
   eager warm-up and the capture, adds 16 to `synth_launches` (every
   program captured 16 synth launches, one a Synth arm), and so does an
   eager window; the median of 5 render_device walls.

Then the card line, the kernels line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import struct
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
LONG_SAMPLE_FRAMES = 30 * SR                   # a 30 s user sample
SCAN_T, SCAN_C = 375 * BL, 4                  # one c3 band-pass window
SCAN_F64_RTOL, SCAN_PLAIN_RTOL = 1e-4, 1e-5   # relative to max |y|
PLAYER_ATOL = 1e-5
COMB_D, DELAY_D = 1785, 5760                  # c4's feedback lines at 48 kHz
SLOW_POLE, SLOW_HZ = 0.9999, 20.0             # phases 4 and 9's slow poles
SLOW_DECAY_T = 100003                         # phase 9's long slow decay
# the per-kernel bounds are held against one H100 SXM's published peaks
# (utils/roofline.chip_peaks of this name)
BOUND_CARD = "NVIDIA H100 80GB HBM3"
# phase 4: the SampSyn kernel at c4's chord shape (the chords' 8 slots),
# how far from its plain version it may read, and the chords' envelope
# (ops/adsr.hit_conf(0.01, 0.1, 0.8, 5.0, 0.2, 0.5), the fixtures')
SAMPSYN_P, SAMPSYN_N, SAMPSYN_ATOL = 8, 64, 2e-6
SAMPSYN_CONF = (0.0, 0.01, 1.0, 0.1, 0.8, 5.0, 0.2, 0.5, 0.0)
# the exact lane's latency bound: 3 dependent FP32 operations of 4 cycles
# a frame at the H100 SXM's 1.98 GHz boost clock
BIQUAD_CYCLES_A_FRAME, BOOST_HZ = 12, 1.98e9
BIQUAD_F64_RTOL = 5e-5                        # phase 13, of max |y|
LANES_RTOL = 2e-3                             # phase 14, of full scale
STREAM_SECONDS, STREAM_PERIOD_S = 10.0, 0.1   # phase 15's writer
# phase 15's session is paused at this wall, as a user would stop it: a
# Player whose 1-block window costs more than a block never leaves its
# catch-up loop (as in the reference), so the session has no end of its own
STREAM_DEADLINE_S = 30.0
SHARD_RANKS = 4                               # phase 18
NATIVE_RENDERS = 4           # phase 20: renders each way, one cold
# phase 22: the manual examples, and the stream pipe's generator
EXAMPLES = ("project", "sample-project", "neg-adsr-env", "synth-adsr-fx",
            "generative")
PIPE_SECONDS, PIPE_STREAMS = 12, "kick,snare,hihat,ride,bass,chords"
# phase 25: the kernels each card entry of the parity report (run with
# --full, all seven entries) must launch, and how many times the CPU's
# max |err| the card's may be (the readings differ by 2 dB at most)
PARITY_KERNELS = {"config3_synths_bandpass": ("affine_scan", "sampsyn",
                                              "synth"),
                  "config4_fx_chain_invariance": ("affine_scan",
                                                  "max_decay_scan"),
                  "config5_multitrack_fused": ("voice_mix",),
                  "config3_full_48k": ("affine_scan", "sampsyn", "synth")}
PARITY_CARD_VS_CPU = 10.0
PARITY_TIMEOUT_S = 300
# phase 26: the concurrent renders' rounds, the feed/render cycles, and the
# time the mirrored suites' card cases may take in their child
REF_ROUNDS, REF_CYCLES, REF_TESTS_TIMEOUT_S = 2, 30, 600
# torch.profiler now and then returns a trace without device rows: a
# trace is taken again up to this many times, and the empty ones counted
PROFILE_TRIES = 5
empty_traces = 0
# a kernel's trace whose device rows are not a whole multiple of its calls
# lost some rows (seen on biquad_seq: 3 or 4 of 5 calls): taken again too
short_traces = 0


def ptxas_summary(log: str) -> list[str]:
    """One line a compiled kernel of an `nvcc -Xptxas=-v` log: its name
    (the tiled scans' kernel and lane count CL), then ptxas's registers,
    barriers and shared memory, and its stack and spills."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            name = next((k for k in ("voice_mix_kernel", "tile_reduce",
                                     "tile_scan", "biquad_seq_kernel")
                         if k in mangled), mangled)
            cl = re.search(r"(?:OpE|biquad_seq_kernelI)Li(\d+)E", mangled)
            staged = re.search(r"voice_mix_kernelILb([01])E", mangled)
            name += f"<CL={cl.group(1)}>" if cl else ""
            name += f"<staged={staged.group(1)}>" if staged else ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return out


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def kernel_inputs(device: torch.device, lens=(C5_HIT_FRAMES, 2000),
                  seed: int = 0):
    """c5-shaped voice-mix inputs from numpy seed `seed`: a concat buffer
    of padded samples of `lens` frames, begins in concat coordinates
    including 0 and the first and last segments' largest in-bounds begins
    (L + bl), and empty slots."""
    rng = np.random.default_rng(seed)
    segs = [np.pad(rng.uniform(-1, 1, (2, L)).astype(np.float32),
                   ((0, 0), (BL, BL + 256))) for L in lens]
    base = np.cumsum([0] + [g.shape[1] for g in segs[:-1]])
    padded = np.ascontiguousarray(np.concatenate(segs, axis=1))
    seg = rng.integers(0, len(lens), (C5_NB, C5_P))
    begins = (rng.integers(0, np.asarray(lens)[seg] + BL + 1)
              + np.asarray(base)[seg]).astype(np.int32)
    begins[0, 0] = 0
    begins[1, 0] = base[-1] + lens[-1] + BL
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


def release_r() -> np.ndarray:
    """r of the compressor's 250 ms release at 48 kHz, computed as the
    effect computes it: [1]."""
    rel = torch.tensor(250.0, dtype=torch.float32)
    return torch.exp(-1.0 / (rel * 0.001 * SR)).reshape(1).numpy()


def slow_decay_inputs(device: torch.device):
    """The long slow decay: the 250 ms release from one peak (3.0 at frame
    5) over SLOW_DECAY_T frames of low seeded noise (numpy seed 8), one
    lane, state 0. Every run and every tile multiplies the same r, so
    this is where a rounding error they share would compound. As (host
    arrays, device tensors)."""
    rng = np.random.default_rng(8)
    x = (0.01 * np.abs(rng.normal(size=(SLOW_DECAY_T, 1)))).astype(
        np.float32)
    x[5, 0] = 3.0
    host = (x, release_r(), np.zeros(1, np.float32))
    return host, [torch.from_numpy(a).to(device) for a in host]


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


def bound(work: tuple[float, float]) -> dict:
    """The least time the card could take for a kernel call's work, the
    (flops, bytes) its wrapper records (ops/scan.py, ops/voices.py,
    ops/filters.py `*_work`): the bytes read once and written once over
    HBM's rate, or the f32 operations over the peak f32 rate, whichever
    is larger."""
    from termdaw_tpu_torch.utils.roofline import chip_peaks

    tflops, gbps = chip_peaks(BOUND_CARD)
    flops, nbytes = work
    tb, tf = nbytes / (gbps * 1e9), flops / (tflops * 1e12)
    return {"bound_ms": max(tb, tf) * 1e3,
            "bound_by": "bytes" if tb >= tf else "operations"}


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of fn: the CUDA rows of a torch.profiler trace
    of `reps` calls after a warm-up (all the kernels a call launches). A
    trace whose row count is not a multiple of `reps` is taken again."""
    global empty_traces, short_traces
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e.device_time_total for e in prof.events()
                if e.device_type == cuda_t]
        if rows and len(rows) % reps == 0:
            return sum(rows) / 1e3 / reps
        if rows:
            short_traces += 1
        else:
            empty_traces += 1
    raise RuntimeError(f"chip_smoke: check failed: the profiler lost "
                       f"device rows in {PROFILE_TRIES} traces")


def timed(fn, plain, work: tuple[float, float]) -> dict:
    """A kernel's device ms per call beside its bound, the wrapper's
    CUDA-event ms per call (host dispatch included when that is longer)
    and the plain version's."""
    ms = device_ms(fn)
    b = bound(work)
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
    out = {"max_decay": (np.abs(x).max(axis=1, keepdims=True), release_r(),
                         np.zeros(1, np.float32))}
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

    global empty_traces
    saved = dict(fx.EFFECTS)
    if fenced:
        for k, e in saved.items():
            fx.EFFECTS[k] = dataclasses.replace(
                e, process=fenced_process(k, e.process))
    # device rows: kernels, copies and fills; a host range also shows as a
    # device-side annotation of the same name, left out of the rows
    cuda_t = torch.autograd.DeviceType.CUDA
    try:
        for _ in range(PROFILE_TRIES):
            st.fb.set_time(st.compiled.get_time())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                st.render_device()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            st.compiled.set_time(0)
            events = prof.events()
            dev = [e for e in events if e.device_type == cuda_t
                   and not e.name.startswith("fx:")]
            if dev:
                break
            empty_traces += 1
    finally:
        fx.EFFECTS.update(saved)
    ranges: dict[str, list] = {}
    for e in events:
        if e.device_type != cuda_t and e.name.startswith("fx:"):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return wall, dev, ranges


def profile_render(st) -> dict:
    """Three profiled c4 renders. The first replays the captured window
    programs, the second runs the eager program, each as the render runs:
    device time in all and in each of the port's kernels, device rows, and
    the device busy share of the profiled wall. In the replayed render
    each kernel's calls on the card (its device rows, a tiled scan's
    tile_scan rows: a call may add a tile_reduce; an eq3 call is four
    stages, a tile_scan each) must equal its programs'
    captured launches times their replays (path_launches); a trace that
    lost rows is taken again. The third, eager too, with each effect
    fenced (see profiled_render; a replay cannot synchronize inside an
    effect): the effects' device time."""
    from termdaw_tpu_torch.engine.state import render_chunk_blocks

    global short_traces

    def ms(rows) -> float:
        return sum(e.device_time_total for e in rows) / 1e3

    def summary(wall, dev) -> dict:
        device_ms = ms(dev)
        check(device_ms > 0, "the profiler saw no device time")
        mine = {}
        for k, name in (("voice_mix", "voice_mix_kernel"),
                        ("affine_scan", "AffineScanOp"),
                        ("max_decay_scan", "MaxDecayScanOp"),
                        ("eq3", "Eq3Stage"),
                        ("sampsyn", "sampsyn_kernel"),
                        ("synth", "synth_kernel")):
            ks = [e for e in dev if name in e.name]
            calls = [e for e in ks if k in ("voice_mix", "sampsyn", "synth")
                     or "tile_scan" in e.name]
            mine[k] = {"ms": ms(ks), "device_kernels": len(ks),
                       "device_calls": len(calls) // (4 if k == "eq3"
                                                      else 1)}
        return {"wall_ms": wall * 1e3, "device_ms": device_ms,
                "device_busy_share": device_ms / (wall * 1e3),
                "device_launches": len(dev), "kernels": mine}

    cg = st.compiled
    for _ in range(PROFILE_TRIES):
        since = {id(p): p.replays for p in cg.programs()}
        graphs = summary(*profiled_render(st, fenced=False)[:2])
        want = path_launches(cg, since)
        got = {k: v["device_calls"] for k, v in graphs["kernels"].items()}
        if got == {k: want.get(k, 0) for k in got}:
            break
        short_traces += 1
    graphs["replayed_launches"] = want
    for k, v in graphs["kernels"].items():
        check(want.get(k, 0) > 0 and v["device_calls"] == want[k],
              f"the replayed c4 render ran {v['device_calls']} {k} calls "
              f"on the card, its programs {want.get(k, 0)}")
    eager_windows(cg, True)
    try:
        eager = summary(*profiled_render(st, fenced=False)[:2])
        _, fdev, ranges = profiled_render(st, fenced=True)
    finally:
        eager_windows(cg, False)
    fx_ms = {name: ms(e for e in fdev if any(
        lo <= e.time_range.start < hi for lo, hi in spans))
        for name, spans in ranges.items()}
    eq3_kernel = ms(e for e in fdev if "Eq3Stage" in e.name)
    return {"graphs": graphs, "eager": eager,
            "effects_device_ms": fx_ms,
            "effects_share_of_device": sum(fx_ms.values()) / ms(fdev),
            # the eq3 kernel runs in the eq3: a check of the attribution
            "eq3_holds_its_kernel": fx_ms.get("fx:eq3", 0.0) >= eq3_kernel,
            "windows": -(-st.cs // render_chunk_blocks(st.cs))}


def render_wav(fixtures, d, device, packets, wav):
    st = fixtures.load_state(d, device, packets)
    st.render()
    torch.cuda.synchronize()
    return st, *fixtures.read_wav_ints(wav)


def c4_sampsyn_windows(fixtures, d, device) -> dict:
    """Phase 10: the c4 project's SampSyn windows on `device`, run eager
    after one render (graphs hold no arguments to keep): each window's
    sampsyn call (the kernel) with its arguments cloned, then
    sampsyn_plain on them. Returns the windows' max |diff|, max |y| and
    most live slots a block."""
    from termdaw_tpu_torch.ops import synthv

    st = fixtures.load_state(d, device)
    st.render()
    cg, calls, kernel = st.compiled, [], synthv.sampsyn

    def keep(*args):
        out = kernel(*args)
        calls.append(([{k: v.clone() for k, v in a.items()}
                       if isinstance(a, dict) else
                       a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args], out.clone()))
        return out

    synthv.sampsyn = keep
    try:
        st.fb.set_time(0)
        cg.set_time(0)
        left = st.cs
        while left > 0:
            nb = min(C5_NB, left)
            cg.render_window(st.fb, nb, eager=True)
            st.fb.advance_blocks(nb)
            left -= nb
    finally:
        synthv.sampsyn = kernel
    check(len(calls) == -(-st.cs // C5_NB),
          f"c4: {len(calls)} sampsyn calls in {st.cs} blocks")
    err = y = 0.0
    slots = 0
    for args, got in calls:
        want = synthv.sampsyn_plain(*args)
        err = max(err, float((got - want).abs().max()))
        y = max(y, float(want.abs().max()))
        slots = max(slots, int((args[0]["idx"] >= 0).sum(dim=1).max()))
    check(slots >= 3, f"c4's SampSyn windows hold no chord ({slots} slots)")
    check(y > 0.01, f"c4's SampSyn windows are silent (max |y| {y})")
    check(err <= SAMPSYN_ATOL,
          f"sampsyn kernel vs plain on c4's windows max |diff| {err} > "
          f"{SAMPSYN_ATOL}")
    return {"windows": len(calls), "max_live_slots": slots,
            "max_abs_y": y, "max_abs_err": err, "atol": SAMPSYN_ATOL}


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


def check_replays(st, what: str) -> dict:
    """Every window the graph rendered (served or live) replayed a
    captured program; its captures are its cache entries."""
    cg = st.compiled
    windows = cg.served_windows + cg.live_bakes
    check(cg.replays == windows > 0,
          f"{what}: {cg.replays} replays for {windows} windows")
    check(cg.captures == len(cg.programs()) > 0 and all(
        p.graph is not None for p in cg.programs()),
          f"{what}: {cg.captures} captures, {len(cg.programs())} programs")
    return {"windows": windows, "replays": cg.replays,
            "captures": cg.captures}


def path_launches(cg, since: dict | None = None,
                  warmups: bool = True) -> dict[str, int]:
    """The launches of each kernel the graph's windows ran on the card:
    each program's captured launches times its replays (those after
    `since`, a {program id: replays} snapshot), plus one eager warm-up's
    for each program captured in that time. The wrappers count only what
    they launch (the warm-up and the capture), never a replay."""
    since = since or {}
    out: dict[str, int] = {}
    for p in cg.programs():
        runs = p.replays - since.get(id(p), 0)
        if warmups and id(p) not in since:
            runs += 1
        for k, n in p.kernels.items():
            out[k] = out.get(k, 0) + n * runs
    return out


def check_wrapper_counts(cg, counts: dict[str, int], what: str) -> None:
    """The wrapper counts of a fresh graph's render are its programs'
    warm-ups and captures: twice the launches each captured."""
    captured: dict[str, int] = {}
    for p in cg.programs():
        for k, n in p.kernels.items():
            captured[k] = captured.get(k, 0) + n
    for k, n in counts.items():
        check(n == 2 * captured.get(k, 0),
              f"{what}: the {k} wrapper counted {n} launches, its programs "
              f"captured {captured.get(k, 0)}")


def eager_windows(cg, on: bool) -> None:
    """Run the graph's windows through the eager program (on) or its
    cached programs (off): the A/B's eager side, and profiles that
    synchronize inside the program."""
    import functools

    if on:
        cg.render_window = functools.partial(type(cg).render_window, cg,
                                             eager=True)
    else:
        cg.__dict__.pop("render_window", None)


def host_launches(st) -> dict:
    """One render's windows (render_device's loop, without its resample
    and quantize) under torch.profiler: the host's enqueue rows (kernel
    and graph launches, copies, fills) and the device rows, a window."""
    from torch.profiler import ProfilerActivity, profile

    from termdaw_tpu_torch.engine.state import render_chunk_blocks
    from termdaw_tpu_torch.tools.shard_render import ENQUEUES

    global empty_traces
    cg = st.compiled
    step = render_chunk_blocks(st.cs)
    wins = [min(step, st.cs - i) for i in range(0, st.cs, step)]
    cuda_t = torch.autograd.DeviceType.CUDA
    captures = cg.captures
    for _ in range(PROFILE_TRIES):
        cg.set_time(0)
        st.fb.set_time(0)
        cg.seed_caps(st.fb, st.cs, step)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for nb in wins:
                cg.render_window(st.fb, nb)
                st.fb.advance_blocks(nb)
            torch.cuda.synchronize()
        events = prof.events()
        calls: dict[str, int] = {}
        for e in events:
            if e.name in ENQUEUES and e.device_type != cuda_t:
                calls[e.name] = calls.get(e.name, 0) + 1
        dev = sum(1 for e in events if e.device_type == cuda_t)
        if calls and dev:
            break
        empty_traces += 1
    cg.set_time(0)
    st.fb.set_time(0)
    n = len(wins)
    return {"windows_profiled": n,
            "host_enqueues_a_window": sum(calls.values()) / n,
            "host_enqueues_by_call": calls, "device_rows_a_window": dev / n,
            "captures_while_profiled": cg.captures - captures}


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


def kernel_event_ms(fn, reps: int) -> float:
    """Device ms of a long kernel (milliseconds a call): the median gap
    between CUDA events recorded around each of `reps` back-to-back calls.
    The host queues a call far faster than the card runs it, so after the
    first gap the card runs call after call with no host time between."""
    for _ in range(3):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda.synchronize()
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms a call of a wrapper whose host dispatch outlasts its
    kernels: `reps` calls captured in one CUDA graph, replayed between
    CUDA events. The profiler loses rows of many-kernel calls late in
    this process, and back-to-back events would time the host."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def eq3_stage_inputs(T: int, seed: int):
    """The c4 eq3's stage coefficients over 4 channels (lowpass and
    highpass at the 180 Hz and 4 kHz crossovers, 48 kHz), [5, 4] f32, a
    seeded input [T, 4] and a zero state [4, 4]."""
    from termdaw_tpu_torch.ops.filters import biquad_coefs

    cs = np.asarray([biquad_coefs(k, f, SR) for k, f in (
        ("lowpass", 180.0), ("highpass", 180.0), ("lowpass", 4000.0),
        ("highpass", 4000.0))], np.float32).T
    x = np.random.default_rng(seed).normal(size=(T, 4)).astype(np.float32)
    return x, cs, np.zeros((4, 4), np.float32)


def biquad64(x: np.ndarray, cs: np.ndarray, state: np.ndarray) -> np.ndarray:
    """The float64 biquad per channel (scipy.signal.lfilter, its initial
    state from lfiltic of the carried (x1, x2, y1, y2))."""
    from scipy.signal import lfilter, lfiltic

    y = np.empty(x.shape, np.float64)
    for c in range(x.shape[1]):
        b0, b1, b2, a1, a2 = (float(v) for v in cs[:, c])
        b, a = [b0, b1, b2], [1.0, a1, a2]
        x1, x2, y1, y2 = (float(v) for v in state[:, c])
        zi = lfiltic(b, a, y=[y1, y2], x=[x1, x2])
        y[:, c] = lfilter(b, a, x[:, c].astype(np.float64), zi=zi)[0]
    return y


class DrainSink:
    """A sink that models a device draining its queue in real time: the
    queued level falls at the project rate while playing; the queue
    running dry while playing counts as an underrun. Keeps the audio and
    the level (ms) seen by each queued chunk."""

    def __init__(self, sr: int) -> None:
        self.sr = sr
        self.chunks: list[np.ndarray] = []
        self.level = 0.0      # frames queued, not yet played
        self.playing = False
        self.t_last: float | None = None
        self.underruns = 0
        self.leads_ms: list[float] = []

    def _drain(self) -> None:
        now = time.perf_counter()
        if self.playing and self.t_last is not None:
            self.level -= (now - self.t_last) * self.sr
            if self.level < 0:
                self.underruns += 1
                self.level = 0.0
        self.t_last = now

    def queue_audio(self, interleaved: np.ndarray) -> None:
        self._drain()
        self.leads_ms.append(self.level / self.sr * 1e3)
        self.chunks.append(np.array(interleaved, np.float32))
        self.level += interleaved.size // 2

    def resume(self) -> None:
        self._drain()
        self.playing = True

    def pause(self) -> None:
        self._drain()
        self.playing = False

    def clear(self) -> None:
        self.level = 0.0

    def close(self) -> None:
        self._drain()
        self.playing = False


def trace_breakdown(path: Path, top: int = 8) -> dict:
    """A torch.profiler Chrome trace's host ops by self time (each op's
    duration less its children's, per thread), the device rows' busy
    share of the traced wall, and their count."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    host = sorted((e for e in events if e.get("cat") in
                   ("cpu_op", "user_annotation", "python_function")),
                  key=lambda e: (e.get("tid"), e["ts"], -e["dur"]))
    self_us: dict[str, float] = {}
    stack: list[tuple] = []  # (tid, end, name)
    for e in host:
        while stack and (stack[-1][0] != e.get("tid")
                         or stack[-1][1] <= e["ts"]):
            stack.pop()
        self_us[e["name"]] = self_us.get(e["name"], 0.0) + e["dur"]
        if stack:
            parent = stack[-1][2]
            self_us[parent] = self_us.get(parent, 0.0) - e["dur"]
        stack.append((e.get("tid"), e["ts"] + e["dur"], e["name"]))
    dev = [e for e in events if e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in host)
    t1 = max(e["ts"] + e["dur"] for e in host)
    busy = sum(e["dur"] for e in dev)
    return {"wall_ms": (t1 - t0) / 1e3, "device_ms": busy / 1e3,
            "device_busy_share": busy / (t1 - t0), "device_rows": len(dev),
            "top_host_self_ms": [
                [n, us / 1e3] for n, us in sorted(
                    self_us.items(), key=lambda kv: -kv[1])[:top]]}


def stream_packets(k: int, at: np.float32) -> bytes:
    """The k-th write of phase 15's writer, its events at `at` seconds: a
    drum hit, and every fifth write a note on and off."""
    from termdaw_tpu_torch.fileio.packets import encode_events

    blob = encode_events("drums", np.asarray([[0.0, at, 38.0, 0.9]],
                                             np.float32))
    if k % 5 == 0:
        note = 48 + (k // 5) % 12
        blob += encode_events("keys", np.asarray(
            [[0.0, at, note, 0.8], [0.0, at + 0.4, note, 0.0]], np.float32))
    return blob


def stream_session(fixtures, d: Path, device, eager: bool = False) -> dict:
    """Phase 15: run_stream_workflow on `device` over the live c4 project
    in d, fed through an os.pipe by a writer thread (a drum hit every
    100 ms and a note every 500 ms, each 0.3 s ahead of the wall clock,
    for STREAM_SECONDS), into a DrainSink; the Player is paused once the
    session has run STREAM_DEADLINE_S. `eager` runs the eager program in
    place of the captured ones (phase 19). Returns the sink, the state,
    the window sizes the Player rendered, the writer's packet count, the
    session's wall and whether the deadline paused it."""
    import os
    import threading

    from termdaw_tpu_torch.engine.player import Player
    from termdaw_tpu_torch.workflows.stream import run_stream_workflow

    st = fixtures.load_state(d, device)
    eager_windows(st.compiled, eager)
    version = st.fb.version
    sink = DrainSink(SR)
    sizes: list[int] = []
    orig = Player._render_queue

    def counted(self, nb):
        sizes.append(nb)
        orig(self, nb)
        if self.playing and (time.perf_counter() - sent["t0"]
                             > STREAM_DEADLINE_S):
            sent["paused_at_deadline"] = True
            self.pause()

    r, w = os.pipe()
    sent = {"packets": 0, "first_event_s": None,
            "paused_at_deadline": False, "t0": time.perf_counter()}

    def writer() -> None:
        t0 = time.perf_counter()
        k = 0
        with os.fdopen(w, "wb", buffering=0) as out:
            while (now := time.perf_counter() - t0) < STREAM_SECONDS:
                at = np.float32(now + 0.3)
                blob = stream_packets(k, at)
                out.write(blob)
                sent["packets"] += 1
                if sent["first_event_s"] is None:
                    sent["first_event_s"] = float(at)
                k += 1
                time.sleep(STREAM_PERIOD_S)

    Player._render_queue = counted
    try:
        th = threading.Thread(target=writer, daemon=True)
        th.start()
        with os.fdopen(r, "rb", buffering=0) as src:
            run_stream_workflow(SR, BL, st, sink, input_stream=src,
                                max_idle_s=1.0)
        th.join(timeout=30)
    finally:
        Player._render_queue = orig
    sent["wall_s"] = time.perf_counter() - sent.pop("t0")
    return {"state": st, "sink": sink, "sizes": sizes,
            "version_before": version, **sent}


@contextlib.contextmanager
def native_off():
    """The native library unloaded for the body: the fileio modules take
    their numpy paths."""
    from termdaw_tpu_torch import native

    saved = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        yield
    finally:
        native._lib, native._tried = saved


def turns(fns: dict, reps: int = 5) -> dict:
    """Each fn called reps times, in turns (forward, then backward), its
    wall in ms: {name: (median ms, the last result)}."""
    ms: dict[str, list[float]] = {k: [] for k in fns}
    last = {}
    for i in range(reps):
        for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            t0 = time.perf_counter()
            last[k] = fns[k]()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    return {k: (statistics.median(v), last[k]) for k, v in ms.items()}


def native_render(fixtures, tmp: Path, cuda, reset_counts) -> dict:
    """Phase 20, the render: c4 at 24 bits on the card from graphs, two
    States of it rendered in lockstep, one writing its WAV through the
    native pack24 and one through the numpy body (a render's effect state
    carries into the next, so the k-th renders are compared), in turns:
    byte-identical; the program's `fetch` + `wav write` and
    `render.device` spans (utils/prof.recording) and the render() wall
    each way; the render's ints packed and unpacked both ways; the first
    WAV against the port's CPU render, as in phase 5."""
    from termdaw_tpu_torch import native
    from termdaw_tpu_torch.fileio import wav as wavio
    from termdaw_tpu_torch.utils import prof

    check(native.get_lib() is not None,
          f"the native library did not load: {native.load_error}")
    cxx = subprocess.run([*native.compiler(), "--version"],
                         capture_output=True, text=True, timeout=60)
    check(cxx.returncode == 0, f"{native.compiler()} --version failed")
    built = native.build_seconds
    lib = {"compiler": " ".join(native.compiler()),
           "compiler_version": cxx.stdout.splitlines()[0],
           "build_s": "cached" if built is None else built,
           "so": str(native.lib_path().relative_to(ROOT))}
    d = tmp / "c4_24"
    fixtures.write_c4_project(d, SECONDS, SR, BL, render_sr=44100, bd=24)
    wav = d / "outp.wav"
    reset_counts()
    sts = {way: fixtures.load_state(d, cuda) for way in ("native", "numpy")}

    def span_ms(t0: float, *names: str) -> float:
        # the program's spans of the render that began at t0
        got = [r for r in prof.records() if r.t0 >= t0 and r.name in names]
        check({r.name for r in got} == set(names),
              f"the render recorded {sorted({r.name for r in got})}, "
              f"not all of {names}")
        return sum(r.ms for r in got)

    runs: dict[str, list[dict]] = {"native": [], "numpy": []}
    wavs: dict[str, list[bytes]] = {"native": [], "numpy": []}
    with prof.recording():
        for i in range(NATIVE_RENDERS):
            for way in ("native", "numpy")[::1 if i % 2 == 0 else -1]:
                n0 = native.calls["pack24"]
                with (native_off() if way == "numpy" else
                      contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    sts[way].render()
                    wall = time.perf_counter() - t0
                check((native.calls["pack24"] > n0) == (way == "native"),
                      f"a {way} render's pack24 calls: "
                      f"{native.calls['pack24'] - n0}")
                wavs[way].append(wav.read_bytes())
                runs[way].append({
                    "render_wall_ms": wall * 1e3,
                    "fetch_write_ms": span_ms(t0, "fetch", "wav write"),
                    "windows_ms": span_ms(t0, "render.device")})
    for i, (a, b) in enumerate(zip(wavs["native"], wavs["numpy"])):
        check(a == b, f"render {i + 1}: the 24-bit c4 WAV written through "
                      f"the native pack24 differs from the numpy one")
    st = sts["native"]
    replays = check_replays(st, "c4 at 24 bits")
    launches = path_launches(st.compiled)
    for k in ("voice_mix", "affine_scan", "max_decay_scan", "eq3",
              "sampsyn", "synth"):
        check(launches.get(k, 0) > 0,
              f"the 24-bit c4 render launched no {k} kernel")
    device_s = wall_render(st, 5)
    first = d / "first.wav"
    first.write_bytes(wavs["native"][0])
    gpu, rate = fixtures.read_wav_ints(first)
    ints = gpu.astype(np.int32)
    raw = wavio._pack24_np(ints).tobytes()
    pack = turns({"native": lambda: native.pack24(ints),
                  "numpy": lambda: wavio._pack24_np(ints)})
    unpack = turns({"native": lambda: native.unpack24(raw),
                    "numpy": lambda: wavio._unpack24_np(raw)})
    check(all(pack[k][1].tobytes() == raw for k in pack) and
          wavs["native"][0].endswith(raw), "pack24 native and numpy disagree")
    check(all(np.array_equal(unpack[k][1], ints) for k in unpack),
          "unpack24 native and numpy disagree")
    _, cpu_ints, _ = render_wav(fixtures, d, torch.device("cpu"), b"", wav)
    # the first render of each State pays its captures: the medians are
    # of the warm ones
    return {
        "library": lib, "project": "c4", "bd": 24, "ints": int(ints.size),
        "launches": launches, **replays, "renders_each_way": NATIVE_RENDERS,
        "bytes_identical": True,
        **{f"{k}_{way}_ms": [r[k + "_ms"] for r in rs]
           for way, rs in runs.items()
           for k in ("fetch_write", "render_wall", "windows")},
        **{f"{k}_{way}_warm_median_ms": statistics.median(
            r[k + "_ms"] for r in rs[1:]) for way, rs in runs.items()
           for k in ("fetch_write", "render_wall")},
        "render_device_median_ms": statistics.median(device_s) * 1e3,
        "pack24_ms": {k: v[0] for k, v in pack.items()},
        "unpack24_ms": {k: v[0] for k, v in unpack.items()},
        **compare("c4 24-bit", gpu, cpu_ints, 24, rate, 44100,
                  2 * -(-st.cs * BL * 147 // 160))}


def example_renders(fixtures, tmp: Path, cuda, cpu) -> dict:
    """Phase 22 (a): a fresh copy of examples/ (no assets/), each manual
    example opened by the port's CLI on the card in a child process
    (`render`, `quit` on stdin, TERMDAW_SINK=null; the first one's hook
    generates the assets), its WAV within phase 5's bound of the port's
    CPU render; then each rendered in this process on the card: every
    window a replay, the kernels' path launches, the render_device
    median of 5, the WAV equal in bound to the CPU's too. Returns the
    examples' copy and the line's fields."""
    import shutil

    from termdaw_tpu_torch.utils import example_assets

    root = tmp / "examples"
    shutil.copytree(ROOT / "examples", root, ignore=shutil.ignore_patterns(
        "assets", "outp.wav", "__pycache__"))
    env = {**os.environ, "TERMDAW_SINK": "null"}
    out: dict = {}
    union: dict[str, int] = {}
    for name in EXAMPLES:
        d = root / name
        t0 = time.perf_counter()
        proc = subprocess.run(
            fixtures.alone_argv("termdaw_tpu_torch", str(d)), cwd=ROOT,
            input="render\nquit\n", capture_output=True, text=True,
            timeout=600, env=env)
        cli_wall = time.perf_counter() - t0
        check(proc.returncode == 0 and "done rendering" in proc.stdout,
              f"{name}: the CLI exited {proc.returncode}: "
              f"{(proc.stdout + proc.stderr)[-2000:]}")
        wav = d / "outp.wav"
        cli, rate = fixtures.read_wav_ints(wav)
        st, card, card_rate = render_wav(fixtures, d, cuda, b"", wav)
        replays = check_replays(st, name)
        launches = path_launches(st.compiled)
        for k, n in launches.items():
            union[k] = union.get(k, 0) + n
        walls = wall_render(st, 5)
        _, host, _ = render_wav(fixtures, d, cpu, b"", wav)
        n = 2 * st.cs * BL
        out[name] = {"cli_wall_s": cli_wall, **replays, "launches": launches,
                     "render_device_s": walls,
                     "median_s": statistics.median(walls),
                     "cli": compare(f"{name} (CLI)", cli, host, 16, rate, SR,
                                    n),
                     "in_process": compare(name, card, host, 16, card_rate,
                                           SR, n)}
    for k in ("voice_mix", "affine_scan", "max_decay_scan", "sampsyn",
              "synth"):
        check(union.get(k, 0) > 0, f"no example launched the {k} kernel")
    t0 = time.perf_counter()
    example_assets.ensure(tmp / "assets_timed")
    gen_s = time.perf_counter() - t0
    return root, {"examples": out, "launches": union,
                  "assets_files": len(list((root / "assets").iterdir())),
                  "assets_generate_s": gen_s}


def stream_pipe(fixtures, root: Path, tmp: Path) -> dict:
    """Phase 22 (b): the port's stream_gen, paced, piped into the port's
    CLI on the card on the examples' copy of examples/stream, both in
    children with the JAX package blocked; the capture gated by
    tools/test_stream.sh's checks."""
    from termdaw_tpu_torch.fileio.wav import read_wav

    cap = tmp / "capture.wav"
    env = {**os.environ, "TERMDAW_SINK": f"file:{cap}",
           "TERMDAW_STREAM_IDLE": "3"}
    t0 = time.perf_counter()
    gen = subprocess.Popen(
        fixtures.alone_argv("termdaw_tpu_torch.tools.stream_gen",
                            "--duration", str(PIPE_SECONDS), "--streams",
                            PIPE_STREAMS),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    try:
        daw = subprocess.run(
            fixtures.alone_argv("termdaw_tpu_torch", str(root / "stream")),
            cwd=ROOT, stdin=gen.stdout, capture_output=True, text=True,
            timeout=300, env=env)
    finally:
        gen.stdout.close()
        try:
            gen_rc = gen.wait(timeout=60)
        except subprocess.TimeoutExpired:
            gen.kill()
            gen_rc = gen.wait()
        gen_err = gen.stderr.read().decode()
        gen.stderr.close()
    wall = time.perf_counter() - t0
    check(gen_rc == 0, f"stream_gen exited {gen_rc}: {gen_err[-2000:]}")
    check(daw.returncode == 0, f"the stream CLI exited {daw.returncode}: "
                               f"{(daw.stdout + daw.stderr)[-2000:]}")
    a, spec = read_wav(cap, scale=True)
    secs = len(a) / spec.sample_rate
    peak = float(np.max(np.abs(a)))
    nz = float(np.mean(np.any(a != 0, axis=1)))
    check(bool(np.isfinite(a).all()), "the stream capture is not finite")
    check(secs > 3 and peak > 0.2 and nz > 0.25,
          f"stream pipe: captured {secs} s, peak {peak}, nonzero-frame "
          f"ratio {nz} (gates: > 3 s, > 0.2, > 0.25)")
    return {"generator_seconds": PIPE_SECONDS, "streams": PIPE_STREAMS,
            "captured_s": secs, "peak": peak, "nonzero_frame_ratio": nz,
            "session_wall_s": wall}


def roofline_check(fixtures, projects, ab: dict, cuda, cpu) -> dict:
    """Phase 23: each config on a fresh State on the card and on the CPU,
    from the same project. window_cost at every window size
    `_window_counts` gives, from time 0, must count the same flops, bytes
    and storages on both devices (a mismatch names the aten ops whose
    counts differ). Then the card's State renders once (its window
    programs captured: their pool is the peak) and config_roofline runs
    over phase 19's graph and eager render medians."""
    from termdaw_tpu_torch.utils import roofline

    out = {}
    for cfg, d, pk in projects:
        sts = {"cuda": fixtures.load_state(d, cuda, pk),
               "cpu": fixtures.load_state(d, cpu, pk)}
        counts = roofline._window_counts(sts["cuda"])
        check(counts == roofline._window_counts(sts["cpu"]),
              f"{cfg}: the window sizes differ on the card and the CPU")
        windows = {}
        for nb in sorted(counts):
            cost = {}
            for dev, st in sts.items():
                _, _, step = st._mesh_plan()
                st.compiled.seed_caps(st.fb, st.cs, step)
                st.compiled.set_time(0)
                st.fb.set_time(0)
                cost[dev] = st.compiled.window_cost(st.fb, nb)
            g, c = cost["cuda"], cost["cpu"]
            differ = sorted(op for op in set(g["ops"]) | set(c["ops"])
                            if g["ops"].get(op) != c["ops"].get(op))
            for k in ("flops", "bytes accessed"):
                check(g[k] == c[k], f"{cfg}, {nb}-block window: {k} "
                      f"{g[k]} on the card, {c[k]} on the CPU; ops that "
                      f"differ: {differ}")
            for k in ("arg_bytes", "out_bytes", "temp_bytes"):
                check(g["_mem"][k] == c["_mem"][k], f"{cfg}, {nb}-block "
                      f"window: {k} {g['_mem'][k]} on the card, "
                      f"{c['_mem'][k]} on the CPU; ops that differ: "
                      f"{differ}")
            ops = g["ops"]
            windows[str(nb)] = {
                "count": counts[nb], "flops": g["flops"],
                "bytes_accessed": g["bytes accessed"], **g["_mem"],
                "ops_equal": not differ,
                "op_calls": sum(r[0] for r in ops.values()),
                "kernels": {k: r for k, r in ops.items()
                            if k.startswith("kernel:")},
                "top_ops_by_bytes": dict(sorted(
                    ops.items(), key=lambda kv: -kv[1][2])[:8]),
            }
        median = {mode: statistics.median(
            r["median_s"] for r in ab[cfg]["runs"] if r["mode"] == mode)
            for mode in ("graphs", "eager")}
        floor = roofline._analytic_window_model(sts["cuda"].compiled, counts)
        sts["cuda"].render()
        torch.cuda.synchronize()
        out[cfg] = {
            "windows": windows, "render_device_median_s": median,
            **{mode: roofline.config_roofline(sts["cuda"], s, SECONDS)
               for mode, s in median.items()},
            "reference_analytic_floor": {"gflops": floor[0] / 1e9,
                                         "gbytes": floor[1] / 1e9},
        }
        for st in sts.values():
            st.compiled.release_chains()
    return out


def native_io(tmp: Path) -> dict:
    """Phase 20, the reader and the sample load: phase 15's stream bytes
    (two live streams, STREAM_SECONDS) decoded in 4096-byte reads and in
    one blob, native against the numpy loop; the two malformed headers
    the scanner rejects; a 24-bit 30 s sample loaded by SampleBank both
    ways."""
    from termdaw_tpu_torch import native
    from termdaw_tpu_torch.banks.samplebank import (SampleBank,
                                                    SampleLoadMethod)
    from termdaw_tpu_torch.fileio import packets as pk
    from termdaw_tpu_torch.fileio import wav as wavio

    blob = b"".join(stream_packets(k, np.float32(k * STREAM_PERIOD_S + 0.3))
                    for k in range(round(STREAM_SECONDS / STREAM_PERIOD_S)))

    def decode(chunk: int) -> list:
        dec = pk.PacketDecoder()
        return [(p.kind, p.name, p.text,
                 None if p.events is None else p.events.tobytes())
                for i in range(0, len(blob), chunk)
                for p in dec.feed(blob[i:i + chunk])]

    def plain(chunk: int) -> list:
        with native_off():
            return decode(chunk)

    n0 = native.calls["scan_frames"]
    dec = turns({"native_reads": lambda: decode(4096),
                 "native_blob": lambda: decode(len(blob)),
                 "numpy_reads": lambda: plain(4096),
                 "numpy_blob": lambda: plain(len(blob))})
    scans = native.calls["scan_frames"] - n0
    check(scans == 5 * (-(-len(blob) // 4096) + 1),
          f"{scans} native scans for 5 x (4096-byte reads + one blob)")
    want = dec["numpy_blob"][1]
    check(len(want) > 0 and all(v[1] == want for v in dec.values()),
          "the decoders' packets differ")
    malformed = {}
    for name, hdr in (("events_2^25", b"\x01\x01\x00a" +
                       struct.pack("<I", 2 ** 25)),
                      ("text_2^29", b"\x02" + struct.pack("<I", 2 ** 29))):
        try:
            pk.PacketDecoder().feed(hdr)
            malformed[name] = None
        except pk.PacketError as e:
            malformed[name] = str(e)
        check(malformed[name] == "malformed packet stream (code -2)",
              f"the {name} header gave {malformed[name]!r}")

    path = tmp / "sample24.wav"
    rng = np.random.default_rng(20)
    wavio.write_wav(path, rng.uniform(-0.9, 0.9, (LONG_SAMPLE_FRAMES, 2)),
                    SR, bits=24)

    def load():
        sb = SampleBank(SR)
        sb.add("s", str(path), SampleLoadMethod.STEREO)
        return sb.get_sample(0)

    def load_plain():
        with native_off():
            return load()

    n0 = native.calls["unpack24"]
    loads = turns({"native": load, "numpy": load_plain})
    check(native.calls["unpack24"] == n0 + 5,
          f"{native.calls['unpack24'] - n0} native unpacks for 5 loads")
    a, b = loads["native"][1], loads["numpy"][1]
    check(np.array_equal(a.l, b.l) and np.array_equal(a.r, b.r),
          "the 24-bit sample loads differ")
    return {"stream_bytes": len(blob), "packets": len(want),
            "scan_frames_calls": scans,
            "decode_ms": {k: v[0] for k, v in dec.items()},
            "malformed": malformed,
            "sample_frames": LONG_SAMPLE_FRAMES,
            "sample_load_ms": {k: v[0] for k, v in loads.items()},
            "calls": dict(native.calls)}


def window_mix_args(st, nb: int) -> tuple:
    """The voice mix's arguments (padded buffer, begins, left and right
    amps) in the first nb-block window of st's render, recorded from an
    eager run of that window as the window program passes them; the
    State is left at time 0."""
    from termdaw_tpu_torch.ops import voices

    seen = []
    real = voices.voice_mix_stereo

    def record(*a):
        seen.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x
                          for x in a))
        return real(*a)

    cg = st.compiled
    cg.set_time(0)
    st.fb.set_time(0)
    cg.seed_caps(st.fb, st.cs, nb)
    voices.voice_mix_stereo = record
    try:
        cg.render_window(st.fb, nb, eager=True)
        torch.cuda.synchronize()
    finally:
        voices.voice_mix_stereo = real
    cg.set_time(0)
    st.fb.set_time(0)
    check(len(seen) == 1 and seen[0][4:] == (nb, BL),
          f"an eager {nb}-block window made {len(seen)} voice-mix calls")
    return seen[0][:4]


def wide_configs(fixtures, tmp: Path, cuda, cpu, reset_counts) -> dict:
    """Phase 24: c6 and c7 (fixtures.BUILDERS) rendered on the card from
    fresh States, the wrapper counts set to 0 just before: every window a
    replay, the voice mix launched, the WAV within phase 5's bound of the
    port's CPU render. Then the voice mix at each one's shape, its first
    window's arguments: bit-exact to the plain version, timed beside its
    bound."""
    from termdaw_tpu_torch import kernels
    from termdaw_tpu_torch.ops import voices

    wide = {}
    for cfg, name in (("c6", "c6_stream256"), ("c7", "c7_stream1024")):
        d = tmp / cfg
        reset_counts()
        st = fixtures.build(name, d, SECONDS, cuda)
        st.render()
        torch.cuda.synchronize()
        gpu, rate = fixtures.read_wav_ints(d / "mix.wav")
        replays = check_replays(st, cfg)
        check_wrapper_counts(st.compiled, {"voice_mix": voices.launches},
                             cfg)
        n = path_launches(st.compiled).get("voice_mix", 0)
        check(n > 0, f"the {cfg} render launched no voice-mix kernel")
        fixtures.build(name, d, SECONDS, cpu).render()
        cpu_ints, _ = fixtures.read_wav_ints(d / "mix.wav")
        a = window_mix_args(fixtures.build(name, d, SECONDS, cuda), C5_NB)
        P = a[1].shape[1]
        check(P > 32, f"{cfg}'s voice mix has {P} slots")
        n0 = voices.launches
        got = voices.voice_mix_stereo(*a, C5_NB, BL)
        torch.cuda.synchronize()
        check(voices.launches == n0 + 1, f"{cfg}: no launch counted")
        want = voices.voice_mix_stereo_plain(*a, C5_NB, BL)
        err = float((got - want).abs().max())
        check(bool(torch.equal(got, want)), f"{cfg}'s voice mix vs plain "
              f"not bit-exact (max |diff| {err})")
        plan = kernels.voice_mix_plan(a[0].shape[1], C5_NB, BL)
        t = dict(P=P, lpad=a[0].shape[1], resident=plan.resident,
                 **timed(lambda: voices.voice_mix_stereo(*a, C5_NB, BL),
                         lambda: voices.voice_mix_stereo_plain(*a, C5_NB, BL),
                         voices.voice_mix_stereo_work(*a, C5_NB, BL)))
        wide[cfg] = {"launches": n, "max_abs_err": err, **replays,
                     "fused_slots": [c["pf"] for k, c in
                                     st.compiled.bake_caps.items()
                                     if k.startswith("fused")],
                     "voice_mix": t,
                     **compare(cfg, gpu, cpu_ints, 32, rate, SR,
                               2 * st.cs * BL)}
    return wide


def parity_run(fixtures, tmp: Path) -> dict:
    """Phase 25: the parity report (tools/parity_report.py --full) in two
    children with jax and the JAX package blocked, one on the card and one
    on the CPU, started together; both exit 0, and every entry of each is
    within its gate and under its drift ceiling (parity_report.
    gate_failures; config5 on the fused path). The card's max |err| must
    lie within PARITY_CARD_VS_CPU times the CPU's, entry by entry, and
    the card's entries must have launched their kernels (PARITY_KERNELS).
    Returns the two side by side, entry by entry."""
    from termdaw_tpu_torch.tools import parity_report

    names = [n for n, _, _ in parity_report.TOY + parity_report.FULL]
    procs = {}
    for dev in ("cuda", "cpu"):
        out = tmp / f"parity_{dev}.json"
        procs[dev] = (out, subprocess.Popen(
            fixtures.alone_argv(
                "termdaw_tpu_torch.tools.parity_report", "--full",
                "--device", dev, "--out", str(out)),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    reports, ended = {}, {}
    try:
        for dev, (out, proc) in procs.items():
            ended[dev] = proc.communicate(timeout=PARITY_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        check(False, f"the parity report took over {PARITY_TIMEOUT_S} s")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for dev, (out, proc) in procs.items():
        stdout, stderr = ended[dev]
        check(proc.returncode == 0 and out.exists(),
              f"the parity report on {dev} exited {proc.returncode}: "
              f"{stdout[-1500:]} {stderr[-2500:]}")
        reports[dev] = json.loads(out.read_text())
        bad = parity_report.gate_failures(reports[dev], names)
        check(not bad, f"the parity report on {dev}: {bad}")
    card_rep, cpu_rep = reports["cuda"], reports["cpu"]
    for name in names:
        card_err, cpu_err = card_rep[name]["max_err"], cpu_rep[name]["max_err"]
        check(card_err <= PARITY_CARD_VS_CPU * cpu_err,
              f"parity {name}: the card's max |err| {card_err} is over "
              f"{PARITY_CARD_VS_CPU} times the CPU's {cpu_err}")
    for name, need in PARITY_KERNELS.items():
        got = card_rep[name]["launches"]
        check(all(got[k] > 0 for k in need),
              f"parity {name} on the card launched {got}, needs {need}")
    keys = ("max_err_dbfs", "rms_err_dbfs", "sustained_max_err_dbfs",
            "isolated_boundary_race_frames", "max_err")
    return {"device": card_rep["device"], "gates": {
        n: parity_report.GATES[n] for n in names}, "drift_ceiling_dbfs": {
        n: parity_report.DRIFT_CEILING_DBFS[n] for n in names}, "entries": {
        n: {dev: {k: reports[dev][n][k] for k in keys}
            | {k: reports[dev][n][k] for k in ("launches", "fused_kernel")
               if k in reports[dev][n]}
            for dev in ("cuda", "cpu")} for n in names}}


def concurrent_renders(fixtures, tmp: Path, cuda) -> dict:
    """Phase 26 (a): c4 at the bench's shape twice, the exact biquad lane
    on one (TERMDAW_EXACT_BIQUAD=1, read at the refresh) and the pole
    cascade on the other. Each lane is rendered alone on a fresh State;
    then, in each of REF_ROUNDS rounds, two fresh States render from two
    threads at once after the program cache is cleared, so that both
    warm up and capture their programs together. Each WAV must be
    bit-identical to its lane's isolated render, every window a replay of
    a captured program, the exact lane's programs holding
    csrc/biquad_seq.cu and not csrc/eq3.cu, the cascade's the reverse."""
    import threading

    from termdaw_tpu_torch.graph import compile as gcompile

    lanes = {"exact": "1", "cascade": "0"}
    need = {"exact": ("biquad_seq", "eq3"),
            "cascade": ("eq3", "biquad_seq")}
    dirs = {lane: tmp / f"c4_{lane}" for lane in lanes}
    for d in dirs.values():
        fixtures.write_c4_project(d, SECONDS, SR, BL)

    def load(lane):
        old = os.environ.get("TERMDAW_EXACT_BIQUAD")
        os.environ["TERMDAW_EXACT_BIQUAD"] = lanes[lane]
        try:
            st = fixtures.load_state(dirs[lane], cuda)
        finally:
            if old is None:
                del os.environ["TERMDAW_EXACT_BIQUAD"]
            else:
                os.environ["TERMDAW_EXACT_BIQUAD"] = old
        check(st.compiled.exact_biquad is (lane == "exact"),
              f"c4 {lane}: the lane was not read at the refresh")
        return st

    def render(st, lane, what):
        t0 = time.perf_counter()
        st.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_replays(st, f"c4 {lane} ({what})")
        cg = st.compiled
        progs = cg.programs()
        ks = set().union(*(p.kernels for p in progs))
        has, lacks = need[lane]
        check(has in ks and lacks not in ks,
              f"c4 {lane} ({what}): its programs captured {sorted(ks)}")
        wav, _ = fixtures.read_wav_ints(st._resolve(st.output_file))
        return wav, {"wall_s": wall, "captures": cg.captures,
                     "capture_ms": [p.capture_ms for p in progs],
                     "kernels_captured": sorted(ks)}

    alone, out = {}, {"isolated": {}, "rounds": []}
    for lane in lanes:
        alone[lane], out["isolated"][lane] = render(load(lane), lane,
                                                    "alone")
    for rnd in range(REF_ROUNDS):
        sts = {lane: load(lane) for lane in lanes}
        gcompile._PROGRAM_CACHE.clear()
        barrier = threading.Barrier(len(sts))
        got, errors = {}, []

        def run(lane):
            try:
                barrier.wait()
                got[lane] = render(sts[lane], lane, f"round {rnd + 1}")
            except BaseException as e:  # raised below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=run, args=(lane,))
                   for lane in sts]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads),
              f"round {rnd + 1}: a render thread is still running")
        if errors:
            raise errors[0]
        rec = {"wall_s": time.perf_counter() - t0}
        for lane in lanes:
            wav, info = got[lane]
            check(np.array_equal(wav, alone[lane]),
                  f"round {rnd + 1}: c4 {lane} rendered beside the other "
                  f"lane is not bit-identical to its render alone (max "
                  f"|diff| {int(np.max(np.abs(wav - alone[lane])))})")
            rec[lane] = info
        out["rounds"].append(rec)
    out["bit_identical"] = True
    return out


def feed_render_cycles(fixtures, tmp: Path, cuda) -> dict:
    """Phase 26 (b): REF_CYCLES cycles on c5 at its stream shape (64
    streamed tracks, 40 s at 48 kHz / 1024), each feeding one event to a
    stream (a content-version bump: the chains go stale) and rendering.
    Gated: every render finite; the chains within their byte budget and
    record limit; a program captured in the first cycle and after it only
    where the bake caps grew; every program captured; the card's reserved
    memory over cycles 11-30 at or under its most over cycles 1-10, plus
    the pool bytes of programs captured after cycle 10."""
    from termdaw_tpu_torch.fileio.packets import PacketDecoder, encode_events

    d = tmp / "c5_cycles"
    packets = fixtures.write_c5_project(d, SECONDS, SR, BL, n_tracks=64)
    st = fixtures.load_state(d, cuda, packets)
    cg = st.compiled
    rng = np.random.default_rng(17)
    reserved, walls, captures, grew = [], [], [], []
    made_by_10: set = set()
    for cycle in range(REF_CYCLES):
        ev = np.array([[0.0, float(rng.uniform(0.1, 0.95 * SECONDS)), 36.0,
                        0.8]], np.float32)
        st.fb.append_streams(PacketDecoder().feed(
            encode_events(f"s{cycle % 64}", ev)))
        caps = {k: dict(v) for k, v in cg.bake_caps.items()}
        before = cg.captures
        st.fb.set_time(cg.get_time())
        t0 = time.perf_counter()
        chunks = st.render_device()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(all(bool(torch.isfinite(c.float()).all()) for c in chunks),
              f"cycle {cycle + 1}: a render that is not finite")
        cg.set_time(0)
        check(len(cg._recorded) <= cg._REC_MAX
              and 0 <= cg._prebake_used <= cg._prebake_budget,
              f"cycle {cycle + 1}: chains over their budget")
        if cycle == 0:
            check(cg.captures >= 1, "the first cycle captured nothing")
        elif cg.captures != before:
            check(cg.bake_caps != caps, f"cycle {cycle + 1} captured a "
                  "program with the bake caps unchanged")
            grew.append(cycle + 1)
        if cycle == 9:
            made_by_10 = set(cg.programs())
        captures.append(cg.captures)
        reserved.append(torch.cuda.memory_reserved(cuda))
    check_replays(st, "c5 feed/render cycles")
    progs = cg.programs()
    late = sum(p.pool_bytes for p in progs if p not in made_by_10)
    check(max(reserved[10:]) <= max(reserved[:10]) + late,
          f"reserved memory grew over cycles 11-30: {reserved}")
    return {"cycles": REF_CYCLES, "captures_after_each": captures,
            "captured_in_cycles_where_caps_grew": grew,
            "reserved_mb": [r / 1e6 for r in reserved],
            "late_pool_mb": late / 1e6,
            "render_ms_median": statistics.median(walls),
            "render_ms_max": max(walls),
            "chain_mb": cg._prebake_used / 1e6,
            "chain_budget_mb": cg._prebake_budget / 1e6,
            "recorded_chains": len(cg._recorded)}


def ref_suites_run(fixtures, tmp: Path) -> dict:
    """Phase 26 (c): the card cases of the mirrored reference suites,
    `python -m pytest -m cuda tests/test_torch_ref_*.py` (all but the
    parity file, which imports both packages) in a child with jax and
    the JAX package blocked in each of its processes. Gated: exit 0, no
    blocked import, and as many passed as the same files' card cases
    collected, none skipped, failed or in error."""
    import xml.etree.ElementTree as ET

    files = [str(p.relative_to(ROOT)) for p in
             sorted((ROOT / "tests").glob("test_torch_ref_*.py"))
             if p.name != "test_torch_ref_parity.py"]
    blk = fixtures.block_site(tmp / "ref_block")
    # the suite's session guard probes jax when a sitecustomize is on
    # PYTHONPATH; here jax is blocked on purpose
    env = dict(os.environ, PYTHONPATH=blk, TERMDAW_SKIP_BACKEND_GUARD="1")
    base = [sys.executable, "-m", "pytest", "-m", "cuda", "-p",
            "no:cacheprovider", *files]
    try:
        col = subprocess.run(base + ["--collect-only", "-q"], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        expected = sum("::" in ln for ln in col.stdout.splitlines())
        check(col.returncode == 0 and expected > 0,
              f"collecting the mirrored suites' card cases: "
              f"{col.stdout[-1500:]} {col.stderr[-1500:]}")
        xml = tmp / "ref_cuda.xml"
        t0 = time.perf_counter()
        run = subprocess.run(base + ["-q", "-rfEs", f"--junitxml={xml}"],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=REF_TESTS_TIMEOUT_S)
        wall = time.perf_counter() - t0
    except subprocess.TimeoutExpired as e:
        check(False, f"the mirrored suites' card cases took over "
              f"{e.timeout} s")
    root = ET.parse(xml).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    n = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors",
                                           "skipped")}
    passed = n["tests"] - n["failures"] - n["errors"] - n["skipped"]
    _, blocked = fixtures.block_log(blk)
    check(run.returncode == 0 and passed == expected and n["skipped"] == 0
          and not blocked,
          f"the mirrored suites on the card: rc {run.returncode}, "
          f"{passed} of {expected} passed, {n}, blocked {blocked[:3]}: "
          f"{run.stdout[-3000:]}")
    return {"files": files, "expected": expected, "passed": passed,
            **{k: n[k] for k in ("failures", "errors", "skipped")},
            "wall_s": wall, "summary": run.stdout.strip().splitlines()[-1]}


# phase 27: c8's crossovers (one of projects/mix_session.EQ_LOW x EQ_HIGH)
# and c4's, the gains of a strip, and the kernel's bound against the plain
# composition, relative to max |y| (tests/test_torch_cuda.py's from 100 Hz)
EQ3_PAIRS = {"c8": (150.0, 3000.0), "c4": (180.0, 4000.0)}
EQ3_DB = (3.0, -2.0, 1.5)
EQ3_RTOL = 1e-4
C8_EQ3S = 65  # 64 channel strips and the master


def eq3_phase(fixtures, tmp: Path, cuda, reset_counts) -> dict:
    """Phase 27: fx.eq3_crossover at [SCAN_T, 2] for each of EQ3_PAIRS,
    two windows chained, against fx.eq3_plain on the card (audio and
    states), timed beside its bound and the plain composition; then c8's
    window program: the wrapper's launches each pass."""
    from benchmark.projects import mix_session
    from termdaw_tpu_torch.engine.state import render_chunk_blocks
    from termdaw_tpu_torch.ops import fx, scan

    sr = SR
    eff = fx.EFFECTS["eq3"]
    gen = np.random.default_rng(27)
    db = tuple(torch.tensor(g, dtype=torch.float32, device=cuda)
               for g in EQ3_DB)
    out: dict = {"T": SCAN_T, "rtol_plain": EQ3_RTOL, "kernel": {}}
    for name, (lo, hi) in EQ3_PAIRS.items():
        static = fx.bind_static(eff, sr, {"low_freq": lo, "high_freq": hi},
                                cuda)
        xs = [torch.from_numpy((0.3 * gen.normal(size=(SCAN_T, 2)))
                               .astype(np.float32)).to(cuda)
              for _ in range(2)]
        sk = sp = eff.init_state(sr, static, cuda)
        err = serr = scale = 0.0
        for x in xs:
            yk, sk = fx.eq3_crossover(x, sk, db, static["coefs"],
                                      static["sections"])
            yp, sp = fx.eq3_plain(x, sp, fx._eq3_gains(db, x),
                                  static["coefs"])
            scale = max(scale, 1.0, float(yp.abs().max()))
            err = max(err, float((yk - yp).abs().max()))
            serr = max(serr, max(float((sk[k] - sp[k]).abs().max())
                                 for k in sp))
        check(err <= EQ3_RTOL * scale and serr <= EQ3_RTOL * scale,
              f"eq3 at {name}'s window: kernel vs plain {err} (state "
              f"{serr}) > {EQ3_RTOL} * {scale}")
        x, st = xs[0], eff.init_state(sr, static, cuda)
        call = (x, st, db, static["coefs"], static["sections"])
        ms = graph_ms(lambda: fx.eq3_crossover(*call))
        b = bound(fx.eq3_crossover_work(*call))
        io = bound((0.0, 2 * SCAN_T * 2 * 4.0))  # x read, y written
        out["kernel"][name] = dict(
            crossovers=[lo, hi], kernel_vs_plain=err, state_vs_plain=serr,
            max_abs_y=scale, ms=ms, call_ms=event_ms(
                lambda: fx.eq3_crossover(*call), 50),
            plain_ms=event_ms(lambda: fx.eq3_plain(
                x, st, fx._eq3_gains(db, x), static["coefs"]), 20),
            **b, bound_share=b["bound_ms"] / ms, io_bound_ms=io["bound_ms"],
            io_bound_share=io["bound_ms"] / ms)

    # c8's window program: every pass adds C8_EQ3S launches, none of the
    # complex scan
    cfg = json.loads((ROOT / "benchmark" / "configs" / "c8_mix64.json")
                     .read_text())
    d8 = tmp / "c8"
    mix_session.build(cfg, 27, d8)
    st8 = fixtures.load_state(d8, cuda)
    reset_counts()
    st8.render()
    torch.cuda.synchronize()
    cg = st8.compiled
    progs = cg.programs()
    replays = check_replays(st8, "c8")
    for p in progs:
        check(p.kernels.get("eq3") == C8_EQ3S == p.arms.get("pluginfx.eq3")
              and "complex_scan" not in p.kernels,
              f"a c8 program captured {p.kernels} for the arms {p.arms}")
    check(fx.eq3_launches == 2 * C8_EQ3S * len(progs) and
          scan.complex_launches == 0,
          f"c8: {fx.eq3_launches} eq3 and {scan.complex_launches} complex "
          f"launches over {len(progs)} programs' warm-ups and captures")
    passes = fx.eq3_launches
    st8.fb.set_time(0)
    cg.set_time(0)
    cg.render_window(st8.fb, render_chunk_blocks(st8.cs), eager=True)
    torch.cuda.synchronize()
    check(fx.eq3_launches == passes + C8_EQ3S and scan.complex_launches == 0,
          f"an eager c8 window added {fx.eq3_launches - passes} eq3 launches")
    out["c8"] = {"programs": len(progs), "eq3_a_pass": C8_EQ3S,
                 "captured": [p.kernels for p in progs],
                 "wrapper_launches": passes, "eager_window_added":
                 fx.eq3_launches - passes,
                 "complex_launches": scan.complex_launches,
                 "nodes": [p.nodes for p in progs], **replays}
    return out


# phase 28: the Synth kernel at c9's window (32 slots, half of them empty)
# and at c4's bass (2 slots), each with how far it may read from its
# plain version on the card (only the order of the sum over slots
# differs: 1e-5 at 32 slots, 2e-6 at 2), and c9's Synth arms a pass
SYNTH_SHAPES = {"c9": (dict(nb=375, bl=BL, P=32, N=128, empty=0.5), 1e-5),
                "c4_bass": (dict(nb=375, bl=BL, P=2, N=64), 2e-6)}
C9_SYNTHS = 16


def synth_phase(fixtures, tmp: Path, cuda, reset_counts) -> dict:
    """Phase 28: synthv.synth at each of SYNTH_SHAPES against
    synthv.synth_plain on the card, timed beside its bound and the plain
    version; then c9's window program: the wrapper's launches each pass,
    and its render_device walls."""
    from benchmark.projects import poly_session
    from termdaw_tpu_torch.engine.state import render_chunk_blocks
    from termdaw_tpu_torch.ops import synthv
    from termdaw_tpu_torch.ops.adsr import AdsrConf, hit_conf

    cfg = json.loads((ROOT / "benchmark" / "configs" / "c9_poly32.json")
                     .read_text())
    adsr, syn = hit_conf(*cfg["adsr"]), cfg["synth"]
    oscs = {"c9": (*syn["sq"], adsr, *syn["tf"], adsr, syn["tr"], adsr),
            "c4_bass": (0.4, 0.3, hit_conf(0.001, 0.02, 0.0, 0.0, 0.0, 0.0),
                        1.0, 0.8, hit_conf(0.01, 0.1, 0.8, 5.0, 0.2, 0.5),
                        0.0, AdsrConf())}
    out: dict = {"kernel": {}}
    for name, (w, atol) in SYNTH_SHAPES.items():
        bake, frames, time2d, ib = fixtures.synth_window(cuda, seed=28, **w)
        call = (bake, frames, w["nb"], w["bl"], *oscs[name], time2d, ib)
        n0 = synthv.synth_launches
        got = synthv.synth(*call)
        torch.cuda.synchronize()
        check(synthv.synth_launches == n0 + 1, "synth: no launch counted")
        want = synthv.synth_plain(*call)
        err = float((got - want).abs().max())
        y = float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and y > 0.05,
              f"synth at {name}'s window: not finite or silent ({y})")
        check(err <= atol, f"synth kernel vs plain at {name}'s window max "
                           f"|diff| {err} > {atol}")
        ms = graph_ms(lambda: synthv.synth(*call))
        b = bound(synthv.synth_work(*call))
        out["kernel"][name] = dict(
            nb=w["nb"], bl=w["bl"], P=w["P"],
            live_slots=float((bake["idx"] >= 0).float().mean()),
            kernel_vs_plain=err, atol=atol, max_abs_y=y, ms=ms,
            call_ms=event_ms(lambda: synthv.synth(*call), 50),
            plain_ms=event_ms(lambda: synthv.synth_plain(*call), 20), **b,
            bound_share=b["bound_ms"] / ms)

    # c9's window program: every pass adds C9_SYNTHS launches
    d9 = tmp / "c9"
    poly_session.build(cfg, 28, d9)
    st9 = fixtures.load_state(d9, cuda)
    reset_counts()
    st9.render()
    torch.cuda.synchronize()
    cg = st9.compiled
    progs = cg.programs()
    replays = check_replays(st9, "c9")
    for p in progs:
        check(p.kernels.get("synth") == C9_SYNTHS == p.arms.get("synth")
              and p.kernels.get("sampsyn") == C9_SYNTHS,
              f"a c9 program captured {p.kernels} for the arms {p.arms}")
    check(synthv.synth_launches == 2 * C9_SYNTHS * len(progs),
          f"c9: {synthv.synth_launches} synth launches over {len(progs)} "
          f"programs' warm-ups and captures")
    passes = synthv.synth_launches
    st9.fb.set_time(0)
    cg.set_time(0)
    cg.render_window(st9.fb, render_chunk_blocks(st9.cs), eager=True)
    torch.cuda.synchronize()
    check(synthv.synth_launches == passes + C9_SYNTHS,
          f"an eager c9 window added {synthv.synth_launches - passes} synth "
          f"launches")
    cg.set_time(0)
    walls = wall_render(st9, 5)
    out["c9"] = {"programs": len(progs), "synth_a_pass": C9_SYNTHS,
                 "captured": [p.kernels for p in progs],
                 "wrapper_launches": passes, "eager_window_added":
                 synthv.synth_launches - passes,
                 "nodes": [p.nodes for p in progs], **replays,
                 "render_device_s": walls,
                 "render_device_median_s": statistics.median(walls)}
    return out


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
    from termdaw_tpu_torch.graph import compile as gcompile
    from termdaw_tpu_torch.ops import filters, fx, scan, synthv, voices
    from termdaw_tpu_torch.ops.adsr import AdsrConf
    from termdaw_tpu_torch.utils import fixtures

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")

    def reset_counts():
        voices.launches = scan.launches = 0
        scan.max_decay_launches = scan.complex_launches = 0
        filters.biquad_seq_launches = synthv.sampsyn_launches = 0
        fx.eq3_launches = synthv.synth_launches = 0

    # 2. build
    t0 = time.perf_counter()
    libs = kernels.build_all(kernels.KERNELS)
    for name in kernels.KERNELS:
        getattr(kernels, f"{name}_lib")()
    # the native host library (g++), built here so that no later phase
    # pays its compile (phase 15's packet reader would); phase 20 checks it
    from termdaw_tpu_torch import native

    native.get_lib()
    # the exact lane rounds every multiply and add on its own: no fused
    # multiply-add may appear in its machine code
    sass = subprocess.run(
        [str(Path(kernels.find_nvcc()).parent / "cuobjdump"), "-sass",
         str(libs["biquad_seq"])], capture_output=True, text=True,
        timeout=120)
    check(sass.returncode == 0 and "FMUL" in sass.stdout,
          f"cuobjdump -sass of biquad_seq failed: {sass.stderr.strip()}")
    ffma = len(re.findall(r"\bFFMA", sass.stdout))
    check(ffma == 0, f"biquad_seq's SASS holds {ffma} FFMA")
    emit("build", seconds=time.perf_counter() - t0, ptxas={
        f"termdaw_tpu_torch/csrc/{name}.cu": ptxas_summary(
            lib.with_suffix(".log").read_text())
        for name, lib in libs.items()}, biquad_seq_sass_ffma=ffma)

    # 3. kernel vs plain at c5's shapes, in both regimes
    args = kernel_inputs(cuda)
    long_args = kernel_inputs(cuda, (LONG_SAMPLE_FRAMES,), seed=5)
    mix = {}
    for regime, a in (("resident", args), ("streamed", long_args)):
        plan = kernels.voice_mix_plan(a[0].shape[1], C5_NB, BL)
        check(plan.resident == (regime == "resident"),
              f"the {regime} buffer got the plan {plan}")
        n0 = voices.launches
        got = voices.voice_mix_stereo(*a, C5_NB, BL)
        torch.cuda.synchronize()
        check(voices.launches == n0 + 1, f"{regime}: no launch counted")
        want = voices.voice_mix_stereo_plain(*a, C5_NB, BL)
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()),
              f"{regime} kernel output not finite")
        check(bool(torch.equal(got, want)),
              f"{regime} kernel vs plain not bit-exact (max |diff| {err})")
        mix[regime] = {"lpad": a[0].shape[1], "grid": plan.grid,
                       "threads": plan.threads, "smem": plan.smem,
                       "max_abs_err": err,
                       "bit_exact": True}
    max_err = mix["resident"]["max_abs_err"]
    emit("kernel_vs_plain", nb=C5_NB, bl=BL, P=C5_P, **mix)

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
    ss_args = fixtures.sampsyn_window(cuda, C5_NB, BL, SAMPSYN_P, SAMPSYN_N)
    ss_bake, ss_frames, ss_ib, ss_times, ss_waves = ss_args
    ss_call = (ss_bake, ss_frames, C5_NB, BL, AdsrConf(*SAMPSYN_CONF),
               ss_times, ss_waves, ss_ib)
    n0 = synthv.sampsyn_launches
    ss_got = synthv.sampsyn(*ss_call)
    torch.cuda.synchronize()
    check(synthv.sampsyn_launches == n0 + 1, "sampsyn: no launch counted")
    ss_want = synthv.sampsyn_plain(*ss_call)
    ss_err = float((ss_got - ss_want).abs().max())
    check(bool(torch.isfinite(ss_got).all()), "sampsyn output not finite")
    check(ss_err <= SAMPSYN_ATOL,
          f"sampsyn kernel vs plain max |diff| {ss_err} > {SAMPSYN_ATOL}")

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
        c5_replays = check_replays(st5, "c5")
        check_wrapper_counts(st5.compiled, {"voice_mix": voices.launches},
                             "c5")
        launches = path_launches(st5.compiled).get("voice_mix", 0)
        check(launches > 0, "the c5 render launched no voice-mix kernel")
        _, cpu5, _ = render_wav(fixtures, d5, cpu, packets, d5 / "mix.wav")
        emit("c5_end_to_end", tracks=64, seconds=SECONDS, sr=SR, bd=32,
             voice_mix_launches=launches,
             voice_mix_wrapper_count=voices.launches, **c5_replays,
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
        c1_replays = check_replays(st1, "c1")
        _, cpu1, _ = render_wav(fixtures, d1, cpu, b"", d1 / "outp.wav")
        emit("c1_end_to_end", seconds=SECONDS, sr=SR, render_sr=44100,
             bd=16, **c1_replays,
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
            replays = check_replays(st, cfg)
            check_wrapper_counts(st.compiled, {
                "voice_mix": voices.launches, "affine_scan": scan.launches,
                "sampsyn": synthv.sampsyn_launches,
                "synth": synthv.synth_launches}, cfg)
            counts = path_launches(st.compiled)
            if cfg == "c3":
                for k in ("affine_scan", "sampsyn", "synth"):
                    check(counts.get(k, 0) > 0,
                          f"the c3 render launched no {k} kernel")
            _, cpu_ints, _ = render_wav(fixtures, d, cpu, b"",
                                        d / "outp.wav")
            emit(f"{cfg}_end_to_end", seconds=SECONDS, sr=SR, bd=16,
                 launches=counts, **replays, first_render_wall_s=wall,
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
        host, dev = slow_decay_inputs(cuda)
        sgot = scan.max_decay_scan(*dev)
        torch.cuda.synchronize()
        y64 = max_decay64(*host)
        scale = float(np.abs(y64).max())
        err = float(np.abs(sgot.cpu().numpy() - y64).max())
        check(bool(torch.isfinite(sgot).all()),
              "max_decay slow decay output not finite")
        check(err <= SCAN_PLAIN_RTOL * scale,
              f"max_decay slow decay vs float64 max |diff| {err} > "
              f"{SCAN_PLAIN_RTOL} * {scale}")
        mres["slow_decay"] = {"T": SLOW_DECAY_T, "r": float(host[1][0]),
                              "max_abs_y": scale, "kernel_vs_f64": err,
                              "kernel_vs_f64_rel": err / scale,
                              "rtol_f64": SCAN_PLAIN_RTOL}
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
        c4_replays = check_replays(st4, "c4")
        check_wrapper_counts(st4.compiled, {
            "voice_mix": voices.launches, "affine_scan": scan.launches,
            "max_decay_scan": scan.max_decay_launches,
            "complex_scan": scan.complex_launches, "eq3": fx.eq3_launches,
            "sampsyn": synthv.sampsyn_launches,
            "synth": synthv.synth_launches}, "c4")
        c4_counts = path_launches(st4.compiled)
        for k in ("voice_mix", "affine_scan", "max_decay_scan", "eq3",
                  "sampsyn", "synth"):
            check(c4_counts.get(k, 0) > 0,
                  f"the c4 render launched no {k} kernel")
        check(scan.complex_launches == 0,
              "the c4 render launched the complex scan off a mesh")
        _, cpu4, _ = render_wav(fixtures, d4, cpu, b"", d4 / "outp.wav")
        emit("c4_end_to_end", seconds=SECONDS, sr=SR, render_sr=44100,
             bd=16, launches=c4_counts, **c4_replays,
             first_render_wall_s=c4_wall,
             **compare("c4", gpu4, cpu4, 16, rate4, 44100,
                       2 * -(-st4.cs * BL * 147 // 160)),
             sampsyn_windows=c4_sampsyn_windows(fixtures, d4, cuda))

        # 11. timings
        c5_s = wall_render(st5, 5)
        c1_s = wall_render(st1, 5)
        c2_s = wall_render(st23["c2"], 5)
        c3_s = wall_render(st23["c3"], 5)
        c4_s = wall_render(st4, 5)
        # each kernel at its main-path shape, the voice mix in both regimes,
        # the max-decay also on 4 lanes, and the tiled scans at every shape
        # c3 and c4 run them at: device time beside the bound
        def mix_timed(a):
            return dict(lpad=a[0].shape[1], **timed(
                lambda: voices.voice_mix_stereo(*a, C5_NB, BL),
                lambda: voices.voice_mix_stereo_plain(*a, C5_NB, BL),
                voices.voice_mix_stereo_work(*a, C5_NB, BL)))

        mix_t = {"resident": mix_timed(args),
                 "streamed": mix_timed(long_args)}
        gen = np.random.default_rng(4)

        def max_decay_timed(dev):
            T, C = dev[0].shape
            return dict(shape=[T, C], **timed(
                lambda: scan.max_decay_scan(*dev),
                lambda: scan.max_decay_scan_plain(*dev),
                scan.max_decay_scan_work(*dev)))

        md_4 = [torch.from_numpy(v).to(cuda) for v in (
            np.abs(gen.normal(size=(1025, 4))).astype(np.float32),
            np.full(4, 0.999, np.float32), np.zeros(4, np.float32))]
        md_t = {"compressor": max_decay_timed(fxin["max_decay"][1]),
                "1025x4": max_decay_timed(md_4)}
        per_kernel = {"voice_mix_stereo": mix_t["resident"],
                      "max_decay_scan": md_t["compressor"]}
        affine_t = {}
        for name, (T, C) in affine_shapes().items():
            ab = [torch.from_numpy(v).to(cuda) for v in (
                gen.normal(size=(T, C)).astype(np.float32),
                np.full(C, 0.9, np.float32), np.zeros(C, np.float32))]
            affine_t[name] = dict(shape=[T, C], **timed(
                lambda: scan.affine_scan(*ab),
                lambda: scan.affine_scan_plain(*ab),
                scan.affine_scan_work(*ab)))
        dev = fxin["complex"][1]
        T, C = dev[0].shape
        complex_t = {"eq3_stage": dict(shape=[T, C], **timed(
            lambda: scan.complex_affine_scan(*dev),
            lambda: scan.complex_affine_scan_plain(*dev),
            scan.complex_affine_scan_work(*dev)))}
        per_kernel["affine_scan"] = affine_t["band_pass"]
        per_kernel["complex_affine_scan"] = complex_t["eq3_stage"]
        # phase 4's SampSyn window, timed last (the profiler's first
        # session of the process stays the voice mix's, as before)
        per_kernel["sampsyn"] = timed(
            lambda: synthv.sampsyn(*ss_call),
            lambda: synthv.sampsyn_plain(*ss_call),
            synthv.sampsyn_work(*ss_call))
        emit("sampsyn_vs_plain", nb=C5_NB, bl=BL, P=SAMPSYN_P, N=SAMPSYN_N,
             K=ss_waves.shape[0], W=ss_waves.shape[1], max_abs_err=ss_err, max_abs_y=float(ss_want.abs().max()),
             atol=SAMPSYN_ATOL, **per_kernel["sampsyn"])
        emit("timings", card=card,
             c5_render_device_s=c5_s, c5_median_s=statistics.median(c5_s),
             c1_render_device_s=c1_s, c1_median_s=statistics.median(c1_s),
             c2_render_device_s=c2_s, c2_median_s=statistics.median(c2_s),
             c3_render_device_s=c3_s, c3_median_s=statistics.median(c3_s),
             c4_render_device_s=c4_s, c4_median_s=statistics.median(c4_s),
             voice_mix_stereo=mix_t, max_decay_scan=md_t,
             affine_scan=affine_t, complex_affine_scan=complex_t,
             empty_traces=empty_traces, short_traces=short_traces)

        # 12. a profile of one c4 render
        emit("c4_profile", card=card, **profile_render(st4),
             empty_traces=empty_traces)

        # 13. the exact lane's kernel against its plain version
        x, cs, st0 = eq3_stage_inputs(2 * SR, seed=13)
        dev_cs = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(cuda)
                       for c in cs)
        cpu_cs = tuple(c.cpu() for c in dev_cs)
        gst, pst = torch.from_numpy(st0).to(cuda), torch.from_numpy(st0)
        for lo in (0, SR):
            win = torch.from_numpy(x[lo:lo + SR])
            n0 = filters.biquad_seq_launches
            gy, gst = filters.biquad_apply_sequential(win.to(cuda), dev_cs,
                                                      gst)
            torch.cuda.synchronize()
            check(filters.biquad_seq_launches == n0 + 1,
                  "biquad_seq: no launch counted")
            py, pst = filters.biquad_seq_plain(win, *cpu_cs, pst)
            check(bool(torch.isfinite(gy).all()),
                  "biquad_seq kernel output not finite")
            check(torch.equal(gy.cpu(), py) and torch.equal(gst.cpu(), pst),
                  f"biquad_seq kernel vs plain not bit-exact (window at "
                  f"{lo}, max |diff| {float((gy.cpu() - py).abs().max())})")
        xf, _, _ = eq3_stage_inputs(SCAN_T, seed=14)
        bq_args = (torch.from_numpy(xf).to(cuda), dev_cs,
                   torch.zeros((4, 4), device=cuda))
        fy, fst = filters.biquad_apply_sequential(*bq_args)
        torch.cuda.synchronize()
        y64 = biquad64(xf, cs, np.zeros((4, 4)))
        scale = float(np.abs(y64).max())
        err64 = float(np.abs(fy.cpu().numpy() - y64).max())
        check(err64 <= BIQUAD_F64_RTOL * scale,
              f"biquad_seq vs float64 max |diff| {err64} > "
              f"{BIQUAD_F64_RTOL} * {scale}")
        cpu_args = (bq_args[0].cpu(), *cpu_cs, bq_args[2].cpu())
        t0 = time.perf_counter()
        py, pst = filters.biquad_seq_plain(*cpu_args)
        bq_plain_ms = (time.perf_counter() - t0) * 1e3
        bq_err = float((fy.cpu() - py).abs().max())
        check(torch.equal(fy.cpu(), py) and torch.equal(fst.cpu(), pst),
              f"biquad_seq kernel vs plain at [{SCAN_T}, 4] not bit-exact "
              f"(max |diff| {bq_err})")
        # torch.profiler loses rows of this kernel's traces (3 or 4 of 5
        # calls), so its device time is taken between CUDA events
        bq_ms = kernel_event_ms(
            lambda: filters.biquad_apply_sequential(*bq_args), reps=5)
        # the recurrence is serial by contract, so its operations cannot
        # go faster than their dependent chain: the operations' term is
        # that chain at FP32 latency, far above bytes or peak-rate flops
        latency_ms = SCAN_T * BIQUAD_CYCLES_A_FRAME / BOOST_HZ * 1e3
        bq_bound = bound(filters.biquad_apply_sequential_work(*bq_args))
        if latency_ms > bq_bound["bound_ms"]:
            bq_bound = {"bound_ms": latency_ms, "bound_by": "operations"}
        bq_t = {"ms": bq_ms, "call_ms": event_ms(
                    lambda: filters.biquad_apply_sequential(*bq_args), 5),
                "plain_ms": bq_plain_ms, **bq_bound}
        emit("biquad_seq_vs_plain", card=card, windows=[SR, SR], C=4,
             bit_exact=True, T=SCAN_T, kernel_vs_plain=bq_err,
             max_abs_y=scale, kernel_vs_f64=err64,
             kernel_vs_f64_rel=err64 / scale, rtol_f64=BIQUAD_F64_RTOL,
             latency_bound_ms=latency_ms,
             latency_share=latency_ms / bq_ms, short_traces=short_traces,
             **bq_t)
        per_kernel["biquad_seq"] = bq_t

        # 14. c4 on the exact lane
        os.environ["TERMDAW_EXACT_BIQUAD"] = "1"
        try:
            reset_counts()
            t0 = time.perf_counter()
            st4x, gpu4x, rate4x = render_wav(fixtures, d4, cuda, b"",
                                             d4 / "outp.wav")
            c4x_wall = time.perf_counter() - t0
            c4x_counts = {"biquad_seq": filters.biquad_seq_launches,
                          "complex_scan": scan.complex_launches,
                          "eq3": fx.eq3_launches}
            check(st4x.compiled.exact_biquad, "the flag was not read")
            c4x_replays = check_replays(st4x, "c4 on the exact lane")
            check_wrapper_counts(st4x.compiled, c4x_counts,
                                 "c4 on the exact lane")
            replayed = path_launches(st4x.compiled, warmups=False)
            bq_launches = path_launches(st4x.compiled).get("biquad_seq", 0)
            check(replayed.get("biquad_seq", 0) == 20,
                  f"the exact-lane c4 render replayed biquad_seq "
                  f"{replayed.get('biquad_seq', 0)} times, not 20")
            check(scan.complex_launches == fx.eq3_launches == 0 and
                  "complex_scan" not in replayed and "eq3" not in replayed,
                  "the exact-lane c4 render launched the complex scan or "
                  "the eq3 kernel")
            check(rate4x == 44100 and gpu4x.shape == gpu4.shape,
                  "exact-lane c4 WAV format")
            lanes_diff = int(np.abs(gpu4x - gpu4).max())
            check(lanes_diff <= LANES_RTOL * 2 ** 15,
                  f"exact vs parallel lane {lanes_diff} counts > "
                  f"{LANES_RTOL} of full scale")
            c4x_s = wall_render(st4x, 5)
            d4s = tmp / "c4_1s"
            fixtures.write_c4_project(d4s, 1.0, SR, BL, render_sr=44100,
                                      bd=16)
            _, gpu1s, r1s = render_wav(fixtures, d4s, cuda, b"",
                                       d4s / "outp.wav")
            _, cpu1s, _ = render_wav(fixtures, d4s, cpu, b"",
                                     d4s / "outp.wav")
            cut = compare("c4 1 s exact lane", gpu1s, cpu1s, 16, r1s, 44100,
                          gpu1s.shape[0])
            check(cut["max_abs_diff"] <= 1, "c4 1 s exact lane: GPU vs CPU "
                  "more than one count apart")
        finally:
            del os.environ["TERMDAW_EXACT_BIQUAD"]
        emit("c4_exact_lane", card=card, wrapper_counts=c4x_counts,
             replayed_launches=replayed, launches=bq_launches,
             **c4x_replays,
             first_render_wall_s=c4x_wall, render_device_s=c4x_s,
             median_s=statistics.median(c4x_s),
             default_lane_median_s=statistics.median(c4_s),
             lanes_max_abs_diff_counts=lanes_diff,
             lanes_bound_counts=LANES_RTOL * 2 ** 15, cut_1s=cut)

        # 15. a stream session on c4
        d4l = tmp / "c4_live"
        fixtures.write_c4_project(d4l, SECONDS, SR, BL, render_sr=44100,
                                  bd=16, live=True)
        reset_counts()
        sess = stream_session(fixtures, d4l, cuda)
        sst, sink = sess["state"], sess["sink"]
        sess_wrappers = {"voice_mix": voices.launches,
                         "affine_scan": scan.launches,
                         "max_decay_scan": scan.max_decay_launches,
                         "complex_scan": scan.complex_launches,
                         "eq3": fx.eq3_launches,
                         "sampsyn": synthv.sampsyn_launches,
                         "synth": synthv.synth_launches}
        # the programs still cached (a longer time table drops the others)
        sess_launches = path_launches(sst.compiled)
        sess_pool_mb = sst.compiled.pool_bytes / 1e6
        audio = np.concatenate(sink.chunks)
        first = 2 * int(sess["first_event_s"] * SR)
        check(sess["packets"] > 0 and
              sst.fb.version > sess["version_before"],
              "the stream session appended no events")
        check(bool(np.isfinite(audio).all()), "stream audio not finite")
        check(audio.size > first and float(np.abs(audio[first:]).max()) > 0,
              "stream audio silent after the first event")
        sess_replays = check_replays(sst, "the stream session")
        check(sess_replays["windows"] == len(sess["sizes"]),
              f"the stream session rendered {len(sess['sizes'])} windows, "
              f"the graph {sess_replays['windows']}")
        hist = {str(n): sess["sizes"].count(n)
                for n in sorted(set(sess["sizes"]))}
        nb_walls = {}
        for nb in (1, 4, 32):
            walls = []
            for _ in range(5):
                sst.fb.set_time(sst.compiled.get_time())
                t0 = time.perf_counter()
                sst.compiled.render_window(sst.fb, nb)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                sst.fb.advance_blocks(nb)
            nb_walls[str(nb)] = statistics.median(walls)
        emit("stream_session", card=card, project="c4 + live streams",
             seconds=STREAM_SECONDS, packets=sess["packets"],
             session_wall_s=sess["wall_s"],
             paused_at_deadline=sess["paused_at_deadline"],
             blocks_rendered=sum(sess["sizes"]), window_sizes=hist,
             underruns=sink.underruns,
             min_lead_ms=min(sink.leads_ms),
             median_lead_ms=statistics.median(sink.leads_ms),
             block_ms=BL / SR * 1e3,
             render_window_ms_median={"nb": nb_walls},
             launches=sess_launches, wrapper_counts=sess_wrappers,
             programs=len(sst.compiled.programs()),
             pool_mb=sess_pool_mb,
             memory_reserved_mb=torch.cuda.memory_reserved(cuda) / 1e6,
             **sess_replays)

        # 16. chains against live bakes, then TERMDAW_VOICE_CAP
        def bake_timed(st):
            """Wrap the graph's host bake with a clock: returns the
            accumulator (ms, calls)."""
            acc = {"ms": 0.0, "calls": 0}
            orig = st.compiled._bake_all

            def timed_bake(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    acc["ms"] += (time.perf_counter() - t0) * 1e3
                    acc["calls"] += 1
            st.compiled._bake_all = timed_bake
            return acc

        chains = {}
        for cfg, d, pk, wav in (
                ("c5", d5, packets, d5 / "mix.wav"),
                ("c3", tmp / "c3", b"", tmp / "c3" / "outp.wav")):
            out = {}
            for mode in ("chains", "live"):
                if mode == "live":
                    os.environ["TERMDAW_PREBAKE"] = "0"
                try:
                    st = fixtures.load_state(d, cuda, pk)
                    ints = []
                    for _ in range(2):
                        st.render()
                        torch.cuda.synchronize()
                        ints.append(fixtures.read_wav_ints(wav)[0])
                    cg = st.compiled
                    check(cg._prebake_used <= cg._prebake_budget,
                          f"{cfg}: chain bytes over the budget")
                    check_replays(st, f"{cfg} chains, {mode}")
                    acc = bake_timed(st)
                    walls = wall_render(st, 5)
                finally:
                    os.environ.pop("TERMDAW_PREBAKE", None)
                out[mode] = {"ints": ints, "served_windows": cg.served_windows,
                             "live_bakes": cg.live_bakes,
                             "chain_bytes": cg._prebake_used,
                             "host_bake_ms_a_render": acc["ms"] / 6,
                             "median_s": statistics.median(walls),
                             "render_device_s": walls}
            for i in range(2):
                check(np.array_equal(out["chains"]["ints"][i],
                                     out["live"]["ints"][i]),
                      f"{cfg} render {i + 1}: chains vs live not "
                      f"bit-identical")
            check(out["chains"]["served_windows"] > 0 and
                  out["live"]["served_windows"] == 0,
                  f"{cfg}: chains served {out['chains']['served_windows']}"
                  f", live {out['live']['served_windows']}")
            for m in out.values():
                del m["ints"]
            chains[cfg] = {"bit_identical": True, **out}
        os.environ["TERMDAW_VOICE_CAP"] = "2"
        try:
            stc = fixtures.load_state(d5, cuda, packets)
            stc.fb.set_time(0)
            cg = stc.compiled
            cg.seed_caps(stc.fb, stc.cs, C5_NB)
            bakes, _ = cg._bake_all(stc.fb, 0, C5_NB)
            worst = 0
            for k, tbl in bakes.items():
                if k.startswith("fused"):
                    b, m = tbl["begins"], tbl["member"]
                    for kb in range(b.shape[0]):
                        live = b[kb] > 0
                        if live.any():
                            worst = max(worst, int(np.bincount(
                                m[kb][live]).max()))
            stc.render()
            torch.cuda.synchronize()
            capped, _ = fixtures.read_wav_ints(d5 / "mix.wav")
        finally:
            del os.environ["TERMDAW_VOICE_CAP"]
        p_caps = [c["p"] for c in cg.bake_caps.values() if "p" in c]
        check(cg.voice_cap == 2 and worst <= 2 and all(p <= 2 for p in
                                                       p_caps),
              f"voice cap: {worst} voices a (block, member), p caps "
              f"{p_caps}")
        check(capped.size == gpu5.size and int(np.abs(capped).max()) > 0,
              "the voice-capped c5 render is empty")
        emit("chains", card=card, **chains,
             voice_cap={"cap": 2, "max_voices_a_block_member": worst,
                        "p_caps": p_caps, "finite": True})

        # 17. TERMDAW_PROFILE
        from termdaw_tpu_torch.utils import prof

        with tempfile.TemporaryDirectory() as pdir:
            prof.PROFILE_DIR = pdir
            try:
                t0 = time.perf_counter()
                st4.render()
                torch.cuda.synchronize()
                p_wall = time.perf_counter() - t0
            finally:
                prof.PROFILE_DIR = ""
            traces = sorted(Path(pdir).glob("render-*.json"))
            check(len(traces) == 1 and traces[0].stat().st_size > 0,
                  f"TERMDAW_PROFILE wrote {len(traces)} traces")
            ranges = {e.get("name") for e in json.loads(
                traces[0].read_text())["traceEvents"]
                if e.get("cat") == "user_annotation"}
            want = {"render", "render.device", "seed caps", "window",
                    "resample", "quantize", "fetch", "wav write",
                    "wav encode", "wav file"}
            check(want <= ranges, "the TERMDAW_PROFILE trace lacks the "
                  f"program's spans {sorted(want - ranges)}")
            emit("profile_env", card=card, trace_bytes=traces[0].stat().
                 st_size, render_wall_s=p_wall,
                 **trace_breakdown(traces[0]))

        # 18. sharded scans, then sharded renders, on 4 ranks
        from termdaw_tpu_torch.tools import shard_render

        def transport(shared: bool, backend: str) -> str:
            return f"{backend}, " + (f"{SHARD_RANKS} ranks sharing cuda:0"
                                     if shared else "a card a rank")

        try:
            scans = shard_render.scan_check(SHARD_RANKS)
        except RuntimeError as e:
            check(False, str(e))
        emit("sharded_scans", card=card, cards=count,
             transport=transport(scans["shared_card"], scans["backend"]),
             **scans)
        sharded_projects = []
        for cfg, single_ints, bd in (("c4", gpu4, 16), ("c5", gpu5, 32)):
            d = tmp / f"{cfg}_sharded"
            pk = shard_render.write_project(cfg, d)
            sharded_projects.append((cfg, str(d), pk))
            single = shard_render.single_walls(d, pk, reps=3)
            res = shard_render.sharded_run(
                d, pk, shard_render.PROJECTS[cfg], SHARD_RANKS, reps=3)
            try:
                summary = shard_render.summarize(cfg, res, single_ints, bd)
            except RuntimeError as e:
                check(False, str(e))
            check(summary["windows_sharded_alone"] == [(4, 1)],
                  f"{cfg}: sharded/alone windows a render "
                  f"{summary['windows_sharded_alone']}, not [(4, 1)]")
            emit(f"{cfg}_sharded", card=card, cards=count,
                 transport=transport(summary["shared_card"],
                                     summary["backend"]),
                 single_rank=single, **summary)

        # 19. the window-program cache: the eager program against the
        # captured graphs, in the order eager, graphs, graphs, eager
        from termdaw_tpu_torch.engine.state import render_chunk_blocks

        ab = {}
        for cfg, d, pk, wav in (
                ("c5", d5, packets, d5 / "mix.wav"),
                ("c1", d1, b"", d1 / "outp.wav"),
                ("c2", tmp / "c2", b"", tmp / "c2" / "outp.wav"),
                ("c3", tmp / "c3", b"", tmp / "c3" / "outp.wav"),
                ("c4", d4, b"", d4 / "outp.wav")):
            runs, wavs = [], []
            for mode in ("eager", "graphs", "graphs", "eager"):
                st = fixtures.load_state(d, cuda, pk)
                cg = st.compiled
                eager_windows(cg, mode == "eager")
                st.render()
                torch.cuda.synchronize()
                wavs.append(fixtures.read_wav_ints(wav)[0])
                walls = wall_render(st, 5)
                run = {"mode": mode, "median_s": statistics.median(walls),
                       "render_device_s": walls, **host_launches(st)}
                if mode == "graphs":
                    run.update(check_replays(st, f"{cfg} from graphs"))
                    check(run["captures_while_profiled"] == 0,
                          f"{cfg}: a warm render captured a program")
                    run["programs"] = [{
                        "nb": k[1], "is_scan": k[2],
                        "warmup_ms": p.warmup_ms,
                        "capture_ms": p.capture_ms,
                        "pool_mb": p.pool_bytes / 1e6,
                        "kernels_captured": p.kernels, "replays": p.replays,
                    } for k, p in gcompile._PROGRAM_CACHE.items()
                        if p.cg is cg]
                    run["pool_mb_all"] = cg.pool_bytes / 1e6
                else:
                    check(cg.replays == cg.captures == 0,
                          f"{cfg}: the eager run used the cache")
                if cfg == "c4":
                    nb_ms = {}
                    for nb in (1, 4, 32):
                        ws = []
                        for _ in range(7):
                            st.fb.set_time(cg.get_time())
                            t0 = time.perf_counter()
                            cg.render_window(st.fb, nb)
                            torch.cuda.synchronize()
                            ws.append((time.perf_counter() - t0) * 1e3)
                            st.fb.advance_blocks(nb)
                        nb_ms[str(nb)] = statistics.median(ws[2:])
                    run["render_window_ms_median"] = nb_ms
                    if mode == "graphs":
                        # three more programs, in the same pool
                        run["pool_mb_all_with_nb_programs"] = \
                            cg.pool_bytes / 1e6
                        run["programs_with_nb_programs"] = len(
                            cg.programs())
                cg.release_chains()
                runs.append(run)
            for i, w in enumerate(wavs[1:], 1):
                check(np.array_equal(w, wavs[0]),
                      f"{cfg}: the {runs[i]['mode']} WAV (run {i + 1}) is "
                      f"not bit-identical to the first eager run's")
            ab[cfg] = {"bit_identical": True, "windows_a_render":
                       -(-st.cs // render_chunk_blocks(st.cs)),
                       "runs": runs}
        worst = max(r["host_enqueues_a_window"] for r in ab["c4"]["runs"]
                    if r["mode"] == "graphs")
        check(worst <= 8, f"c4: {worst} host enqueues a replayed window")
        esess = stream_session(fixtures, d4l, cuda, eager=True)
        check(esess["state"].compiled.replays == 0,
              "the eager stream session used the cache")
        eaudio = np.concatenate(esess["sink"].chunks)
        check(bool(np.isfinite(eaudio).all()),
              "eager stream audio not finite")
        emit("program_cache", card=card, **ab,
             c4_host_enqueues_a_replayed_window_max=worst,
             stream_session={
                 mode: {"blocks_rendered": sum(s["sizes"]),
                        "window_sizes": {str(n): s["sizes"].count(n)
                                         for n in sorted(set(s["sizes"]))},
                        "underruns": s["sink"].underruns,
                        "min_lead_ms": min(s["sink"].leads_ms),
                        "median_lead_ms": statistics.median(
                            s["sink"].leads_ms),
                        "session_wall_s": s["wall_s"],
                        "paused_at_deadline": s["paused_at_deadline"]}
                 for mode, s in (("graphs", sess), ("eager", esess))})

        # 20. the native host library on the card's host
        emit("native_render", card=card,
             **native_render(fixtures, tmp, cuda, reset_counts))
        emit("native_library", card=card, **native_io(tmp))

        # 21. sharded windows from captured graphs: a 1-rank NCCL world
        t21 = time.perf_counter()
        try:
            replays = shard_render.replay_check(sharded_projects, need={
                "c4": ("voice_mix", "affine_scan", "max_decay_scan",
                       "complex_scan", "sampsyn", "synth"),
                "c5": ("voice_mix",)})
        except RuntimeError as e:
            check(False, str(e))
        emit("sharded_replays", card=card, transport="nccl, 1 rank on cuda:0",
             seconds=time.perf_counter() - t21, **replays)

        # 22. the shipped examples and the stream pipe through the CLI
        t22 = time.perf_counter()
        root, ex = example_renders(fixtures, tmp, cuda, cpu)
        emit("examples", card=card, seconds=time.perf_counter() - t22, **ex)
        emit("stream_pipe", card=card, **stream_pipe(fixtures, root, tmp))

        # 23. the roofline: each config's counted work on the card and the
        # CPU, and its share of the card's peaks
        t23 = time.perf_counter()
        rl = roofline_check(fixtures, (
            ("c5", d5, packets), ("c1", d1, b""), ("c2", tmp / "c2", b""),
            ("c3", tmp / "c3", b""), ("c4", d4, b"")), ab, cuda, cpu)
        emit("roofline", card=card, **rl,
             seconds=time.perf_counter() - t23)

        # 24. c6 and c7 on the card against the CPU and the voice mix at
        # their shapes
        t24 = time.perf_counter()
        wide = wide_configs(fixtures, tmp, cuda, cpu, reset_counts)
        for cfg, w in wide.items():
            per_kernel[f"voice_mix_stereo@{cfg}"] = w["voice_mix"]
        emit("bench_wide", card=card, seconds=time.perf_counter() - t24,
             **wide)

        # 25. the parity report against the float64 oracle, card and CPU
        t25 = time.perf_counter()
        emit("parity", card=card, **parity_run(fixtures, tmp),
             seconds=time.perf_counter() - t25)

        # 26. the reference's behaviour suites on the card: concurrent
        # first renders of the two eq3 lanes, feed/render cycles, and the
        # mirrored suites' card cases
        t26 = time.perf_counter()
        emit("concurrent_renders", card=card,
             **concurrent_renders(fixtures, tmp, cuda))
        emit("feed_render_cycles", card=card,
             **feed_render_cycles(fixtures, tmp, cuda))
        emit("ref_suites", card=card, **ref_suites_run(fixtures, tmp),
             seconds=time.perf_counter() - t26)

        # 27. the eq3 kernel at c8's and c4's window, and c8's window
        # program's eq3 launches
        t27 = time.perf_counter()
        eq3_res = eq3_phase(fixtures, tmp, cuda, reset_counts)
        per_kernel["eq3_crossover"] = eq3_res["kernel"]["c4"]
        eq3_err = eq3_res["kernel"]["c4"]["kernel_vs_plain"]
        emit("eq3_kernel", card=card, seconds=time.perf_counter() - t27,
             **eq3_res)

        # 28. the Synth kernel at c9's window and c4's bass, and c9's
        # window program's synth launches
        t28 = time.perf_counter()
        syn_res = synth_phase(fixtures, tmp, cuda, reset_counts)
        per_kernel["synth"] = syn_res["kernel"]["c9"]
        syn_err = syn_res["kernel"]["c9"]["kernel_vs_plain"]
        emit("synth_kernel", card=card, seconds=time.perf_counter() - t28,
             **syn_res)

    print(card, flush=True)
    # launches: what each kernel's main-path render ran on the card (its
    # programs' replays and warm-ups, path_launches): c5's for the voice
    # mix, c4's for the scans, the flag-on c4's for the exact lane
    rows = (
        ("voice_mix_stereo", "voice_mix", "termdaw_tpu/ops/pallas_voices.py:50",
         launches, max_err),
        ("affine_scan", "affine_scan", "termdaw_tpu/ops/filters.py:72",
         c4_counts["affine_scan"], scan_err),
        ("max_decay_scan", "max_decay_scan", "termdaw_tpu/ops/fx.py:63",
         c4_counts["max_decay_scan"], mres["kernel_vs_plain"]),
        # the sharded eq3's now (phases 18 and 21): 0 on c4's path
        ("complex_affine_scan", "complex_scan",
         "termdaw_tpu/ops/filters.py:316", c4_counts.get("complex_scan", 0),
         max(cres[p]["kernel_vs_plain"] for p in ("re", "im"))),
        # the eq3 arm on one device: c4's eq3 windows; its error is phase
        # 27's at c4's window
        ("eq3_crossover", "eq3",
         "termdaw_tpu/ops/filters.py:316 and :357 (the eq3's biquads)",
         c4_counts["eq3"], eq3_err),
        # the exact lane's path is phase 14's flag-on c4 render; its error
        # is phase 13's at the eq3 stage shape [384,000, 4]
        ("biquad_seq", "biquad_seq", "termdaw_tpu/ops/filters.py:384",
         bq_launches, bq_err),
        # no Pallas kernel: the reference's SampSyn arm is jnp that XLA
        # fuses; its error is phase 4's at c4's chord shape
        ("sampsyn", "sampsyn", "termdaw_tpu/ops/synthv.py sampsyn (XLA)",
         c4_counts["sampsyn"], ss_err),
        # no Pallas kernel: the reference's Synth arm is jnp that XLA
        # fuses; c4's bass windows; its error and time are phase 28's at
        # c9's window
        ("synth", "synth", "termdaw_tpu/ops/synthv.py synth (XLA)",
         c4_counts["synth"], syn_err),
        # the voice mix at the wide configs' shapes (phase 24): c6's and
        # c7's renders, their first window's arguments
        *((f"voice_mix_stereo@{cfg}", "voice_mix",
           "termdaw_tpu/ops/pallas_voices.py:50", w["launches"],
           w["max_abs_err"]) for cfg, w in wide.items()),
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
        # max-decay scan, the voice mix, a biquad, the SampSyn or Synth
        # arm or the eq3's crossover tree
        "library_ms": None,
    } for name, src, replaces, n, err in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
