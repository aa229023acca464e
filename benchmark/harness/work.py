"""The yardstick of the kernel rooflines: the published peaks of the
cards the benchmark knows, and the least work of the recurrences and
voice mixes a project asks for, computed from its spec (not from what
the program launches), so that it reads the same whatever implements
them.

A kernel family is the set of device kernels whose name holds one of
its patterns: `scan` (the tiled scans of one-pole filters, feedback
lines, envelope followers and the eq3's biquads) and `voice_mix`. A
family's least time is the larger of its float32 operations over the
peak rate and its bytes over the memory bandwidth, each input read once
and each output written once."""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM5 (dense float32 outside the tensor cores,
# HBM3 bandwidth); "NVIDIA H100 80GB HBM3" is what
# torch.cuda.get_device_name() calls that part
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}

FAMILIES = {
    "voice_mix": ("voice_mix",),
    "scan": ("tile_scan", "tile_reduce", "biquad_seq"),
}

F32 = 4


def family_of(kernel: str) -> str | None:
    for fam, pats in FAMILIES.items():
        if any(p in kernel for p in pats):
            return fam
    return None


def _frames(spec: dict) -> int:
    bl, sr = int(spec["bl"]), int(spec["sr"])
    return -(-int(round(sr * float(spec["length_s"]))) // bl) * bl


def _linear(frames: int, channels: int, order: int = 1) -> tuple[float, float]:
    """y[t] = a y[t-d] (+ ...) + b x[t] over [frames, channels]: 2 flops
    an order a value; read x, write y."""
    return (2.0 * order * frames * channels, 2.0 * F32 * frames * channels)


def bounce_work(spec: dict, sample_frames: dict) -> dict:
    """{family: (flops, bytes)} of one bounce of `spec` at the project
    rate. `sample_frames` gives each sample's length at the project rate."""
    T = _frames(spec)
    fam = {"scan": [0.0, 0.0], "voice_mix": [0.0, 0.0]}

    def add(f, w):
        fam[f][0] += w[0]
        fam[f][1] += w[1]

    plugins = spec.get("plugins", {})
    multis = [v for v in spec["vertices"] if v["kind"] == "sample_multi"]
    if multis:
        hits = 0
        for v in multis:
            hits += _hits(spec, v["floww"])
        sample_bytes = sum(sample_frames[s] * 2 * F32
                           for s in {v["sample"] for v in multis})
        flops = sum(_hits(spec, v["floww"]) * sample_frames[v["sample"]] * 4.0
                    for v in multis)
        add("voice_mix", (flops, T * 2 * F32 + sample_bytes))
    for v in spec["vertices"]:
        if v["kind"] == "bandpass":
            add("scan", _linear(T, 4))
        if v["kind"] != "fx":
            continue
        kind = plugins[v["plugin"]]["kind"]
        if kind == "reverb":
            add("scan", _linear(T, 2))            # input damping
            for _ in range(16):
                add("scan", _linear(T, 1))        # comb lines
            for _ in range(4):
                add("scan", _linear(T, 2))        # allpass feedback
        elif kind == "compressor":
            add("scan", (2.0 * T, 2.0 * F32 * T))  # envelope follower
            add("scan", _linear(T, 1))            # smoothing
        elif kind == "eq3":
            for _ in range(4):
                add("scan", _linear(T, 4, order=2))  # biquad stages
        elif kind == "delay":
            add("scan", _linear(T, 2))
    return {k: tuple(v) for k, v in fam.items() if v[1] > 0}


def _hits(spec: dict, floww: str) -> int:
    ev = spec.get("stream_events", {}).get(floww)
    if ev is not None:
        return int(len(ev))
    return int(spec["hit_counts"][floww])


def project_facts(spec: dict, d) -> dict:
    """Each sample's length at the project rate, and each MIDI floww's
    note-on count (into spec["hit_counts"]), read from the raw files."""
    import math
    from pathlib import Path

    from benchmark.reference import files

    d = Path(d)
    spec["hit_counts"] = {
        n: int((files.read_midi(d / f)[:, 2] > 0.001).sum())
        for n, f in spec.get("midi", {}).items()}
    frames = {}
    for n, f in spec.get("samples", {}).items():
        ints, sr, _ = files.read_wav_ints(d / f)
        frames[n] = int(math.ceil(len(ints) * int(spec["sr"]) / sr))
    return frames


def least_s(flops: float, nbytes: float, peaks: dict) -> float:
    return max(flops / peaks["f32_flops"], nbytes / peaks["hbm_bytes"])
