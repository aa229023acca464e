"""A project spec (benchmark/projects) rendered by the plain reference:
the samples loaded as termdaw loads them, the flowws, every vertex, the
block-wise Normalize, the render resample and the quantize."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from . import effects, files, voices


def load_sample(path: Path, project_sr: int) -> np.ndarray:
    """[frames, 2]: raw counts, peak-normalised over both channels, then
    resampled to the project rate."""
    ints, sr, _ = files.read_wav_ints(path)
    x = ints[:, :2].astype(np.float64)
    m = np.max(np.abs(x))
    if m > 0:
        x = x / m
    return effects.resample(x, sr, project_sr)


def pan_gain(buf: np.ndarray, gain: float, angle: float) -> np.ndarray:
    angle = min(max(angle, -90.0), 90.0)
    if abs(angle) >= 0.001:
        rad = angle * 0.5 * 0.01745329
        buf = buf * np.array([math.sqrt(0.5) * (math.cos(rad) + math.sin(rad)),
                              math.sqrt(0.5) * (math.cos(rad) - math.sin(rad))])
    if abs(gain - 1.0) >= 0.001:
        buf = buf * gain
    return buf


def flowws(spec: dict, d: Path) -> dict:
    out = {name: files.read_midi(d / f) for name, f in
           spec.get("midi", {}).items()}
    for name, ev in spec.get("stream_events", {}).items():
        out[name] = np.asarray(ev, np.float64)[:, 1:4]
    return out


def song_blocks(spec: dict) -> int:
    """The song's blocks at the project rate."""
    return int(math.ceil(int(spec["sr"]) * float(spec["length_s"])
                         / int(spec["bl"])))


def song_frames(spec: dict) -> int:
    """The frames of a bounce at the render rate, from the spec alone:
    the song's blocks, resampled where the project rate is above the
    render rate (effects.resample's output length)."""
    sr, out = int(spec["sr"]), int(spec["render_sr"])
    frames = song_blocks(spec) * int(spec["bl"])
    if sr <= out:
        return frames
    g = math.gcd(sr, out)
    return -(-frames * (out // g) // (sr // g))


def render_passes(spec: dict, d: Path, passes: int,
                  blocks: int | None = None, cast=None) -> np.ndarray:
    """[passes * frames, 2] at the project rate, before the render
    resample: the graph's output over `passes` back-to-back renders of
    `blocks` blocks (the song's by default). `cast`, when given, rounds
    every vertex's output (the control's lower precision)."""
    d = Path(d)
    sr, bl = int(spec["sr"]), int(spec["bl"])
    if blocks is None:
        blocks = song_blocks(spec)
    tl = voices.Timeline(sr, bl, blocks, passes)
    samples = {n: load_sample(d / f, sr) for n, f in
               spec.get("samples", {}).items()}
    tables = {n: files.read_wavetable(d / f) for n, f in
              spec.get("tables", {}).items()}
    fl = flowws(spec, d)
    cast = cast or (lambda a: a)
    verts = {v["name"]: v for v in spec["vertices"]}
    ins: dict = {n: [] for n in verts}
    fan: dict = {n: 0 for n in verts}
    for a, b in spec["edges"]:
        ins[b].append(a)
        fan[a] += 1
    done: dict = {}   # outputs read by more than one vertex

    def note(v):
        return None if float(v.get("note", -1)) < 0 else float(v["note"])

    def run(name):
        if name in done:
            return done[name]
        v = verts[name]
        k = v["kind"]
        mix = np.zeros((tl.N, 2))
        for a in ins[name]:
            mix += run(a)
        if k == "sample_multi":
            y = voices.sample_multi(tl, samples[v["sample"]], fl[v["floww"]],
                                    note(v))
        elif k == "sample_lerp":
            y = voices.sample_lerp(tl, samples[v["sample"]], fl[v["floww"]],
                                   note(v), int(v["lerp_len"]))
        elif k == "synth":
            y = np.repeat(voices.synth(tl, fl[v["floww"]], v["sq"], v["tf"],
                                       v["tr"])[:, None], 2, axis=1)
        elif k == "sampsyn":
            times, waves = tables[v["table"]]
            y = np.repeat(voices.sampsyn(tl, fl[v["floww"]], v["conf"],
                                         times, waves)[:, None], 2, axis=1)
        elif k == "adsr":
            y = mix
            if v["wet"] >= 0.0001:
                y = mix * voices.adsr_gain(tl, fl[v["floww"]], v["conf"],
                                           v["use_max"], note(v),
                                           v["wet"])[:, None]
        elif k == "bandpass":
            y = mix
            if v["wet"] >= 0.0001:
                y = np.concatenate([
                    effects.bandpass(part, v["cut_low"], v["cut_high"],
                                     v["pass_mode"], sr)
                    for part in np.split(mix, tl.passes)])
        elif k == "fx":
            plug = spec["plugins"][v["plugin"]]
            y = mix
            if np.float32(v["wet"]) >= np.float32(1e-4):
                fx = effects.EFFECTS[plug["kind"]](
                    mix, effects.params(plug["kind"], plug.get("params", {})),
                    sr)
                y = mix + v["wet"] * (fx - mix)
        elif k == "normalize":
            peaks = np.max(np.abs(mix).reshape(-1, bl, 2), axis=(1, 2))
            m = np.maximum.accumulate(np.maximum(peaks, 1e-6))
            y = mix / np.repeat(m, bl)[:, None]
        else:
            raise ValueError(f"the reference has no vertex kind {k!r}")
        y = cast(pan_gain(y, float(v.get("gain", 1.0)),
                          float(v.get("angle", 0.0))))
        if fan[name] > 1:
            done[name] = y
        return y

    return run(spec["output"])


def amplitude(bd: int) -> float:
    return float((1 << (bd - 1)) - 1) if bd < 32 else float(2 ** 31 - 1)


def bounce(spec: dict, d: Path, passes: int = 3, cast=None) -> np.ndarray:
    """The last of `passes` back-to-back bounces at the render rate,
    scaled to the WAV's integer range (before the truncation)."""
    sr = int(spec["sr"])
    x = render_passes(spec, d, passes, cast=cast)
    F = x.shape[0] // passes
    last = x[(passes - 1) * F:]
    if sr > int(spec["render_sr"]):
        last = effects.resample(last, sr, int(spec["render_sr"]))
    return cast(last) * amplitude(int(spec["bd"])) if cast else \
        last * amplitude(int(spec["bd"]))
