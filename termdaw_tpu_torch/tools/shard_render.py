"""Sharded scans and renders on the card: n ranks, one process each.

    python3 -m termdaw_tpu_torch.tools.shard_render [--ranks 4] [--reps 3]

First the sharded scan primitives (`scan_check`): the one-pole scan, the
max-decay, the eq3's biquad cascades (complex scans) and c4's 21
feedback lines at the frames a rank holds in c4's sharded windows
(131,072 and 86,016), with CUDA tensors on --ranks ranks, held against
the plain scans over the whole input on the CPU. Then c4 and c5 at
their full shape (40 s, 48 kHz, 1024-frame blocks): each rendered on
cuda:0 alone (the live-bake median with TERMDAW_PREBAKE=0 and the
chain-served median), then on --ranks ranks (parallel/mesh.launch).
Ranks take NCCL with a card for each where the machine has that many
cards, else gloo with every rank on cuda:0 (the lines name it). Over
NCCL each sharded window replays its rank's captured program (the
collectives inside); over gloo the program's entries run eager (a gloo
collective cannot be captured). Each rank returns its kernel launch
counts of the first render, its sharded and single-device windows, its
sharded program entries (`sharded_programs`: captured or eager), and the
walls and collective time of `reps` more renders each way, through the
program cache and with every sharded window eager
(`render_window_sharded(..., eager=True)`), in turns; rank 0 also
returns the WAV, which must be within 2/32768 of full scale of the
single-rank one. One JSON line for the scans and one a project; exits 1
if a check fails. chip_smoke.py's phase 18 runs `scan_check` and
`sharded_run`.

`replay_check` (chip_smoke.py's phase 21) runs a 1-rank NCCL world on
one card, where a sharded window's program is captured with real NCCL
collectives inside (NCCL refuses two ranks on one card, and gloo's
cannot be captured): two States render the same sharded windows, one
through the program cache and one eager, and the audio and the numeric
state must be bit-identical, every window a replay and every program
holding all its collectives.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..graph import compile as gcompile
from ..ops import filters, fx, scan, synthv, voices
from ..parallel import launch
from ..utils import fixtures

BL, SR, SECONDS = 1024, 48000, 40.0
# 16-bit counts of full scale a sharded WAV may differ by: the IIR
# boundary composition is ~1e-4 relative (mesh_default_check.py:111)
WAV_TOL = 2.0 / 32768.0
PROJECTS = {"c4": "outp.wav", "c5": "mix.wav"}

# frames a rank holds in c4's 512-block and 336-block sharded windows on
# 4 ranks
SHARD_FRAMES = (512 * BL // 4, 336 * BL // 4)
# a sharded scan's output against the plain scan over the whole input, of
# its max |y|; the final state of the same max |y| (the biquad's of
# max(1, max |state|): y[T-2] comes from the clamped division). The
# cascade's bounds are tests/subproc/sharded_biquad_check.py:31's. The
# one-pole scan is held to the plain scan evaluated in float64: in float32
# the plain scan's tile products drift on the slow lanes over 524,288
# frames (1.5e-5 of max |y| at a = 0.9999, on the CPU), past the bound.
SCAN_RTOL = {"affine_scan": 1e-5, "max_decay_scan": 1e-5,
             "complex_affine_scan": 1e-4}
STATE_RTOL = {"affine_scan": 1e-4, "max_decay_scan": 1e-4,
              "complex_affine_scan": 1e-3}
# launches of its kernel by one sharded call of a primitive: the summary
# from the identity seed, then the seeded scan (a biquad: two complex
# scans)
SHARDED_LAUNCHES = {"affine_scan": 2, "max_decay_scan": 2,
                    "complex_affine_scan": 4}
# the compressor's release decay (250 ms at 48 kHz) and its seed
MAX_DECAY_R, MAX_DECAY_Y0 = 0.99992, 0.5


def feedback_lines() -> list[tuple[str, int, int, float]]:
    """c4's feedback lines at 48 kHz, (name, D, channels, g): the
    reverb's 16 mono combs and 4 stereo allpasses, the 120 ms delay."""
    combs, allp = fx._reverb_lines(SR)
    return ([(f"comb_{d}", d, 1, 0.8) for d in combs]
            + [(f"allpass_{d}", d, 2, 0.5) for d in allp]
            + [("delay", fx._delay_samples(SR, {"time": 120.0}), 2, 0.35)])


def primitive_kernel(name: str) -> str:
    if name == "max_decay":
        return "max_decay_scan"
    return "complex_affine_scan" if name.startswith("eq3") else "affine_scan"


def scan_inputs(n: int, seed: int) -> dict:
    """The primitives' inputs over n frames, from numpy seed `seed`; the
    one-pole lanes span c4's decays (damping 0.4, compressor smoothing
    0.99931) and slow poles."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "b": normal(n, 4), "y0": normal(4),
        "a": np.asarray([0.4, 0.99931, 0.999, 0.9999], np.float32),
        "lvl": np.abs(normal(n, 1)), "x": normal(n, 4),
        "bq_state": 0.1 * normal(4, 4),
        "tails": {name: normal(D, C) for name, D, C, _ in feedback_lines()},
    }


def sharded_scans(inp: dict, dev: torch.device, mesh, lo: int,
                  hi: int) -> dict:
    """Each primitive over frames [lo, hi) of `inp` on `dev`, under `mesh`
    (or over all of them with mesh None): {name: (y, final state)} as
    host arrays."""
    def seq(a):
        return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev)

    def full(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    out = {
        "affine": filters.first_order_scan(seq(inp["b"]), full(inp["a"]),
                                           full(inp["y0"]), mesh),
        "max_decay": fx.max_decay_scan_sharded(
            seq(inp["lvl"]), full([MAX_DECAY_R]), full([MAX_DECAY_Y0]),
            mesh),
    }
    c_lo, c_hi = fx._eq3_coefs(SR, 180.0, 4000.0, dev)
    for name, c in (("eq3_low", c_lo), ("eq3_high", c_hi)):
        out[name] = filters.biquad_apply(seq(inp["x"]), c,
                                         full(inp["bq_state"]), mesh)
    for name, D, C, g in feedback_lines():
        out[name] = fx.feedback_line(seq(inp["x"][:, :C]),
                                     full(inp["tails"][name]), g, D, mesh)
    return {k: (y.cpu().numpy(), s.cpu().numpy()) for k, (y, s) in
            out.items()}


def _scan_counts() -> dict[str, int]:
    return {"affine_scan": scan.launches,
            "max_decay_scan": scan.max_decay_launches,
            "complex_affine_scan": scan.complex_launches}


def scan_rank(mesh, frames: tuple, seed: int) -> dict:
    """One rank: its slice of every primitive at each T in `frames`, and
    the kernel launches each T took."""
    out = {}
    for T in frames:
        inp = scan_inputs(mesh.size * T, seed)
        before = _scan_counts()
        got = sharded_scans(inp, mesh.device, mesh, mesh.rank * T,
                            (mesh.rank + 1) * T)
        out[T] = {"got": got, "launches": {
            k: v - before[k] for k, v in _scan_counts().items()}}
    return out


def scan_check(n_ranks: int, frames: tuple = SHARD_FRAMES, seed: int = 0,
               device: str = "cuda") -> dict:
    """The sharded primitives on n_ranks ranks (`transport`; gloo on the
    CPU) against the plain scans over the whole input on the CPU (the
    one-pole scan's in float64). Returns the report: per T and kernel the
    worst max |diff| and its share of max |y|, the worst state error, and
    each rank's launches; per T the float32 plain one-pole scan's own
    error against float64, of max |y|. Raises
    RuntimeError listing every failed check: a rank's launches other than
    SHARDED_LAUNCHES a call (none on the CPU), a state unequal across
    ranks, an output or a state out of its bound."""
    backend, share = transport(n_ranks) if device == "cuda" else \
        ("gloo", False)
    ranks = launch(scan_rank, n_ranks, tuple(frames), seed, backend=backend,
                   device=device, share_device=share, timeout_s=600.0)
    names = list(sharded_scans(scan_inputs(8, seed), torch.device("cpu"),
                               None, 0, 8))
    calls = {k: sum(primitive_kernel(p) == k for p in names) for k in
             SCAN_RTOL}
    want_launches = {k: (SHARDED_LAUNCHES[k] * calls[k]
                         if device == "cuda" else 0) for k in calls}
    fails: list[str] = []
    report = {"backend": backend, "shared_card": share, "ranks": n_ranks,
              "frames_a_rank": list(frames), "primitives": len(names),
              "launches_a_rank": want_launches, "by_frames": {}}
    for T in frames:
        for r, res in enumerate(ranks):
            if res[T]["launches"] != want_launches:
                fails.append(f"T={T}: rank {r} launches "
                             f"{res[T]['launches']} != {want_launches}")
        inp = scan_inputs(n_ranks * T, seed)
        want = sharded_scans(inp, torch.device("cpu"), None, 0, n_ranks * T)
        y64 = scan.affine_scan_plain(
            *(torch.from_numpy(inp[k]).double() for k in ("b", "a", "y0"))
        ).numpy()
        plain_rel = float(np.abs(want["affine"][0] - y64).max() /
                          np.abs(y64).max())
        want["affine"] = (y64, y64[-1])
        kern: dict[str, dict] = {}
        for name, (y_want, s_want) in want.items():
            k = primitive_kernel(name)
            y = np.concatenate([res[T]["got"][name][0] for res in ranks])
            states = [res[T]["got"][name][1] for res in ranks]
            if any(not np.array_equal(s, states[0]) for s in states[1:]):
                fails.append(f"T={T} {name}: final states differ by rank")
            scale = float(np.abs(y_want).max())
            diff = float(np.abs(y - y_want).max()) if y.shape == \
                y_want.shape else float("inf")
            s_scale = max(1.0, float(np.abs(s_want).max())) if \
                k == "complex_affine_scan" else scale
            s_err = float(np.abs(states[0] - s_want).max()) / s_scale
            if not diff <= SCAN_RTOL[k] * scale:
                fails.append(f"T={T} {name}: max |diff| {diff} > "
                             f"{SCAN_RTOL[k]} of {scale}")
            if not s_err <= STATE_RTOL[k]:
                fails.append(f"T={T} {name}: state error {s_err} of "
                             f"{s_scale} > {STATE_RTOL[k]}")
            w = kern.setdefault(k, {"max_abs_diff": 0.0, "rel": 0.0,
                                    "worst": None, "state_rel": 0.0,
                                    "rtol": SCAN_RTOL[k]})
            w["max_abs_diff"] = max(w["max_abs_diff"], diff)
            if diff / scale >= w["rel"]:
                w["rel"], w["worst"] = diff / scale, name
            w["state_rel"] = max(w["state_rel"], s_err)
        # the feedback lines' shard offsets (i*T) mod D: o != 0 on ranks > 0
        offsets = sorted({(r * T) % D for _, D, _, _ in feedback_lines()
                          for r in range(1, n_ranks)})
        report["by_frames"][str(T)] = {
            "kernels": kern, "plain_f32_affine_rel": plain_rel,
            "launches_by_rank": [res[T]["launches"] for res in ranks],
            "feedback_offsets_min_max": [offsets[0], offsets[-1]]}
    if fails:
        raise RuntimeError("sharded scans: " + "; ".join(fails))
    return report


def write_project(name: str, d: Path) -> bytes:
    """c4 or c5 at the full shape; returns c5's stream packets."""
    if name == "c4":
        fixtures.write_c4_project(d, SECONDS, SR, BL, render_sr=44100, bd=16)
        return b""
    return fixtures.write_c5_project(d, SECONDS, SR, BL, n_tracks=64,
                                     hit_sr=96000, bd=32)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def transport(n_ranks: int) -> tuple[str, bool]:
    """(backend, share_device): a card a rank over NCCL where there are
    enough cards, else every rank on cuda:0 over gloo."""
    if torch.cuda.device_count() >= n_ranks:
        return "nccl", False
    return "gloo", True


def _reset_counts() -> None:
    voices.launches = scan.launches = 0
    scan.max_decay_launches = scan.complex_launches = 0
    filters.biquad_seq_launches = synthv.sampsyn_launches = 0
    synthv.synth_launches = 0


def sharded_programs(cg) -> list[dict]:
    """The graph's sharded entries of the window-program cache."""
    return [{"nb_total": k[2], "is_scan": k[3], "ranks": k[4],
             "ttab_len": k[6], "captured": p.captured,
             "collectives": p.collectives, "replays": p.replays,
             "warmup_ms": p.warmup_ms, "capture_ms": p.capture_ms,
             "pool_mb": p.pool_bytes / 1e6, "kernels_captured": p.kernels}
            for k, p in gcompile._PROGRAM_CACHE.items()
            if p.cg is cg and k[1] == "sharded"]


def eager_sharded(cg, on: bool) -> None:
    """Run the graph's sharded windows through the eager program (on) or
    their cached programs (off)."""
    if on:
        cg.render_window_sharded = functools.partial(
            type(cg).render_window_sharded, cg, eager=True)
    else:
        cg.__dict__.pop("render_window_sharded", None)


MODES = ("graphs", "eager")


def render_rank(mesh, d: str, packets: bytes, wav: str, reps: int) -> dict:
    """One rank: the project's first render (its kernel launches and its
    sharded programs), then `reps` timed render_device calls each way
    after a warm-up each, in turns: through the program cache
    ("graphs") and with every sharded window eager."""
    _reset_counts()
    st = fixtures.load_state(d, mesh.device, packets, mesh=mesh)
    t0 = time.perf_counter()
    st.render()
    torch.cuda.synchronize(mesh.device)
    first = time.perf_counter() - t0
    counts = gcompile._kernel_counts()
    cg = st.compiled
    out = {"rank": mesh.rank, "device": str(mesh.device), "launches": counts,
           "sharded_windows": cg.sharded_windows,
           "alone_windows": cg.live_bakes - cg.sharded_windows,
           "sharded_programs": sharded_programs(cg),
           "first_render_wall_s": first}
    if mesh.rank == 0:
        out["ints"] = fixtures.read_wav_ints(Path(d) / wav)[0]
    m = mesh
    runs = {mode: {"walls_s": [], "collective_s": [], "collectives": []}
            for mode in MODES}
    for i in range(reps + 1):
        for mode in (MODES if i % 2 == 0 else MODES[::-1]):
            eager_sharded(cg, mode == "eager")
            st.fb.set_time(cg.get_time())
            m.collective_calls, m.collective_s = 0, 0.0
            t0 = time.perf_counter()
            st.render_device()
            torch.cuda.synchronize(mesh.device)
            dt = time.perf_counter() - t0
            cg.set_time(0)
            if i:
                runs[mode]["walls_s"].append(dt)
                runs[mode]["collective_s"].append(m.collective_s)
                runs[mode]["collectives"].append(m.collective_calls)
    eager_sharded(cg, False)
    out.update(runs["graphs"])
    out.update({f"eager_{k}": v for k, v in runs["eager"].items()})
    return out


def sharded_run(d: Path, packets: bytes, wav: str, n_ranks: int,
                reps: int, timeout_s: float = 900.0) -> dict:
    backend, share = transport(n_ranks)
    t0 = time.perf_counter()
    ranks = launch(render_rank, n_ranks, str(d), packets, wav, reps,
                   backend=backend, device="cuda", share_device=share,
                   timeout_s=timeout_s)
    return {"backend": backend, "shared_card": share, "ranks": ranks,
            "launch_wall_s": time.perf_counter() - t0}


def single_walls(d: Path, packets: bytes, reps: int) -> dict:
    """cuda:0 alone: render_device medians with chains (served) and with
    TERMDAW_PREBAKE=0 (a live bake a window, as every sharded window)."""
    out = {}
    for mode in ("live", "served"):
        if mode == "live":
            os.environ["TERMDAW_PREBAKE"] = "0"
        try:
            st = fixtures.load_state(d, torch.device("cuda", 0), packets)
            walls = []
            for i in range(reps + 1):
                st.fb.set_time(st.compiled.get_time())
                t0 = time.perf_counter()
                st.render_device()
                torch.cuda.synchronize()
                if i:
                    walls.append(time.perf_counter() - t0)
                st.compiled.set_time(0)
        finally:
            os.environ.pop("TERMDAW_PREBAKE", None)
        out[f"{mode}_walls_s"] = walls
        out[f"{mode}_median_s"] = statistics.median(walls)
    return out


def summarize(name: str, res: dict, single_ints, bd: int) -> dict:
    """The checks and the printed numbers of one sharded run: raises
    RuntimeError if a rank launched no kernel of the project's path (c4:
    the six of the default lane; c5: the voice mix), if its sharded
    programs are not all captured (NCCL) or all eager (gloo), or if rank
    0's WAV is out of bound against `single_ints`."""
    ranks = res["ranks"]
    need = ("voice_mix", "affine_scan", "max_decay_scan", "complex_scan",
            "sampsyn", "synth") if name == "c4" else ("voice_mix",)
    for r in ranks:
        for k in need:
            if r["launches"][k] <= 0:
                raise RuntimeError(f"{name}: rank {r['rank']} launched no "
                                   f"{k} kernel")
    windows = {(r["sharded_windows"], r["alone_windows"]) for r in ranks}
    got = ranks[0].pop("ints")
    full = 2 ** (bd - 1)
    diff = int(abs(got - single_ints).max()) if got.shape == \
        single_ints.shape else None
    if diff is None or diff > WAV_TOL * full:
        raise RuntimeError(f"{name}: sharded WAV vs single-rank max |diff| "
                           f"{diff} > {WAV_TOL * full} (shapes {got.shape}, "
                           f"{single_ints.shape})")
    want_captured = res["backend"] == "nccl"
    for r in ranks:
        if not r["sharded_programs"] or any(
                p["captured"] != want_captured for p in r["sharded_programs"]):
            raise RuntimeError(
                f"{name}: rank {r['rank']}'s sharded programs "
                f"{r['sharded_programs']} are not all "
                f"{'captured' if want_captured else 'eager'} over "
                f"{res['backend']}")
    r0 = ranks[0]
    return {
        "backend": res["backend"], "shared_card": res["shared_card"],
        "ranks": len(ranks), "devices": [r["device"] for r in ranks],
        "launches_by_rank": [r["launches"] for r in ranks],
        "windows_sharded_alone": sorted(windows),
        "sharded_programs_rank0": [
            {k: p[k] for k in ("nb_total", "is_scan", "captured",
                               "collectives", "replays", "warmup_ms",
                               "capture_ms", "pool_mb")}
            for p in r0["sharded_programs"]],
        "sharded_entries": "captured" if want_captured else "eager",
        "wav_max_abs_diff": diff, "wav_bound": WAV_TOL * full,
        "first_render_wall_s": [r["first_render_wall_s"] for r in ranks],
        "rank0_walls_s": r0["walls_s"], "median_s":
            statistics.median(r0["walls_s"]),
        "eager_rank0_walls_s": r0["eager_walls_s"],
        "eager_median_s": statistics.median(r0["eager_walls_s"]),
        "collective_s_rank0": r0["collective_s"],
        "collective_median_s": statistics.median(r0["collective_s"]),
        "eager_collective_median_s": statistics.median(
            r0["eager_collective_s"]),
        "collectives_a_render": r0["collectives"][0],
        "eager_collectives_a_render": r0["eager_collectives"][0],
        "launch_wall_s": res["launch_wall_s"],
    }


# the windows of a c4 or c5 render on 4 ranks (State._pick_nb), as
# replay_check renders them
REPLAY_WINDOWS = (512, 512, 512, 336)
# the runtime calls that enqueue work on the card, as torch.profiler's
# CPU-side rows name them
ENQUEUES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
            "cudaMemcpyAsync", "cudaMemsetAsync")
PROFILE_TRIES = 3  # a trace without host rows is taken again


def state_leaves(tree) -> list[torch.Tensor]:
    """A numeric state tree's tensors: dicts in key order, tuples in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in state_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in state_leaves(v)]
    return [tree]


def _rewind(st) -> None:
    """Back to t = 0 with fresh carries, so each pass renders the song's
    windows as a first render does (the carries a render leaves at its
    end, moved to t = 0, would raise the caps and mint programs once)."""
    cg = st.compiled
    cg.set_time(0)
    cg._apply_carries({vi: type(c)() for vi, c in cg.carries.items()})


def _enqueues_a_window(sts: dict, mode: str, windows: tuple, mesh) -> float:
    """The host's enqueue rows (kernel and graph launches, copies, fills;
    torch.profiler) a window of one pass of `windows` from t = 0 by the
    State of `mode`."""
    from torch.profiler import ProfilerActivity, profile

    st = sts[mode]
    cg = st.compiled
    cuda_t = torch.autograd.DeviceType.CUDA
    for _ in range(PROFILE_TRIES):
        _rewind(st)
        torch.cuda.synchronize(mesh.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for nb in windows:
                st.fb.set_time(cg.get_time())
                cg.render_window_sharded(st.fb, nb, mesh,
                                         eager=mode == "eager")
                st.fb.advance_blocks(nb)
            torch.cuda.synchronize(mesh.device)
        rows = sum(1 for e in prof.events()
                   if e.name in ENQUEUES and e.device_type != cuda_t)
        if rows:
            return rows / len(windows)
    raise RuntimeError(f"{PROFILE_TRIES} traces of the {mode} windows held "
                       "no enqueue row")


def replay_rank(mesh, projects: list, windows: tuple, reps: int) -> dict:
    """One rank: for each (name, project dir, packets) of `projects`, two
    States of the project in lockstep render `windows` (block counts from
    t = 0, each a multiple of the world size) through
    render_window_sharded, one through the program cache ("graphs") and
    one eager; then `reps` more passes from t = 0 (fresh carries: the
    same tables) with each window timed both ways in turns, and one
    profiled pass each way. Returns per project: whether the first
    pass's audio and numeric state were bit-identical and finite, the
    kernel wrappers' launches in the first pass (counts set to 0 just
    before it), the window walls (ms) and collectives a window each way
    by window size, the enqueue rows a window, the graph State's windows
    and replays, its sharded programs and its pool."""
    dev = mesh.device
    out = {}
    for name, d, packets in projects:
        sts = {m: fixtures.load_state(d, dev, packets, mesh=mesh)
               for m in MODES}
        for st in sts.values():
            st.compiled.seed_caps(st.fb, st.cs, max(windows), prebake=False)
        audio: dict[str, list] = {m: [] for m in MODES}
        walls = {m: {nb: [] for nb in windows} for m in MODES}
        colls: dict[str, dict] = {m: {} for m in MODES}
        _reset_counts()
        for i in range(reps + 1):
            for st in sts.values():
                _rewind(st)
            for nb in windows:
                for m in (MODES if i % 2 == 0 else MODES[::-1]):
                    st = sts[m]
                    cg = st.compiled
                    st.fb.set_time(cg.get_time())
                    calls = mesh.collective_calls
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    y = cg.render_window_sharded(st.fb, nb, mesh,
                                                 eager=m == "eager")
                    torch.cuda.synchronize(dev)
                    dt = (time.perf_counter() - t0) * 1e3
                    st.fb.advance_blocks(nb)
                    if i == 0:
                        audio[m].append(y.cpu())
                    else:
                        walls[m][nb].append(dt)
                        colls[m][nb] = mesh.collective_calls - calls
            if i == 0:
                launches = gcompile._kernel_counts()  # both ways' first pass
                states = {m: [t.cpu() for k in sorted(sts[m].compiled.
                                                      num_state)
                              for t in state_leaves(
                                  sts[m].compiled.num_state[k])]
                          for m in MODES}
        cg = sts["graphs"].compiled
        out[name] = {
            "windows": list(windows),
            "audio_bit_identical": all(
                torch.equal(a, b) for a, b in zip(*audio.values())),
            "state_bit_identical": all(
                torch.equal(a, b) for a, b in zip(*states.values())),
            "audio_finite": all(bool(torch.isfinite(a).all())
                                for a in audio["graphs"]),
            "launches_first_pass": launches,
            "window_ms": walls,
            "window_ms_median": {m: {str(nb): statistics.median(w)
                                     for nb, w in walls[m].items()}
                                 for m in MODES},
            "collectives_a_window": {m: {str(nb): n for nb, n in c.items()}
                                     for m, c in colls.items()},
            "enqueues_a_window": {m: _enqueues_a_window(sts, m, windows,
                                                        mesh)
                                  for m in MODES},
            "sharded_windows": cg.sharded_windows, "replays": cg.replays,
            "captures": cg.captures, "programs": sharded_programs(cg),
            "pool_mb": cg.pool_bytes / 1e6,
        }
    return out


def replay_check(projects: list, windows: tuple = REPLAY_WINDOWS,
                 reps: int = 5, need: dict | None = None) -> dict:
    """`replay_rank` in a 1-rank NCCL world on cuda:0. Raises RuntimeError
    listing every failed check: a project whose replayed windows' audio or
    numeric state is not bit-identical to the eager program's, or not
    finite; a graph window that was not a replay; a sharded program that
    was not captured, or whose captured collectives differ from what the
    eager program issues a window (or a replay adds); a kernel `need`
    names for the project that the first pass never launched, or that a
    program did not capture."""
    (res,) = launch(replay_rank, 1, projects, tuple(windows), reps,
                    backend="nccl", device="cuda", timeout_s=900.0)
    fails: list[str] = []
    for name, r in res.items():
        for k in ("audio_bit_identical", "state_bit_identical",
                  "audio_finite"):
            if not r[k]:
                fails.append(f"{name}: not {k}")
        idle = [k for k in (need or {}).get(name, ())
                if r["launches_first_pass"].get(k, 0) <= 0]
        if idle:
            fails.append(f"{name}: the first pass launched no {idle}")
        passes = reps + 1 + 1  # the first, the timed and the profiled
        if not r["replays"] == r["sharded_windows"] == \
                passes * len(windows):
            fails.append(f"{name}: {r['replays']} replays for "
                         f"{r['sharded_windows']} sharded windows")
        if len(r["programs"]) != len(set(windows)) or \
                r["captures"] != len(set(windows)):
            fails.append(f"{name}: {r['captures']} captures, programs "
                         f"{[p['nb_total'] for p in r['programs']]}")
        for p in r["programs"]:
            nb = str(p["nb_total"])
            eager_n = r["collectives_a_window"]["eager"].get(nb)
            if not p["captured"] or p["collectives"] <= 0 or \
                    p["collectives"] != eager_n or \
                    r["collectives_a_window"]["graphs"].get(nb) != eager_n:
                fails.append(f"{name}: program {nb}: captured "
                             f"{p['captured']}, {p['collectives']} "
                             f"collectives, the eager program {eager_n}")
            missing = set((need or {}).get(name, ())) - \
                set(p["kernels_captured"])
            if missing:
                fails.append(f"{name}: program {nb} captured no "
                             f"{sorted(missing)}")
    if fails:
        raise RuntimeError("sharded replays: " + "; ".join(fails))
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m "
                                 "termdaw_tpu_torch.tools.shard_render")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shard_render: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    try:
        scans = scan_check(args.ranks)
    except RuntimeError as e:
        print(f"shard_render: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"scans": scans, "card": card(),
                      "cards": torch.cuda.device_count()}), flush=True)
    with tempfile.TemporaryDirectory(prefix=".shard_render-",
                                     dir=Path.cwd()) as tmp:
        for name, wav in PROJECTS.items():
            d = Path(tmp) / name
            packets = write_project(name, d)
            st = fixtures.load_state(d, torch.device("cuda", 0), packets)
            st.render()
            torch.cuda.synchronize()
            single_ints = fixtures.read_wav_ints(d / wav)[0]
            single = single_walls(d, packets, args.reps)
            try:
                res = summarize(name, sharded_run(d, packets, wav,
                                                  args.ranks, args.reps),
                                single_ints, 16 if name == "c4" else 32)
            except RuntimeError as e:
                print(f"shard_render: {e}", file=sys.stderr)
                return 1
            print(json.dumps({"project": name, "card": card(),
                              "cards": torch.cuda.device_count(),
                              "single_rank": single, "sharded": res}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
