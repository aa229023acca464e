"""A mix engineer's session, DAWBench DSP's layout: n recorded tracks,
each a SampleLoop of its own stem through the same channel strip (tape ->
eq3 -> compressor, a chorus or a flanger on some), fanned out to the mix
bus and to a reverb send (and on some to a delay send), the two returns
into the mix bus, and the master bus (eq3 -> compressor -> Normalize),
bounced to a 24-bit WAV.

A stem is `stem_s` seconds of 24-bit PCM at the project rate: a region of
bars at `bpm` from one-shot hits (the `_files.drum` body) and tones with
envelopes, looped under the song. The seed draws the stems, every gain,
pan and send level and every traced effect parameter; the eq3's
crossovers come from a small fixed set and the modulation rates from
tempo-synced ones (a whole number of LFO periods a song, so that every
bounce starts its LFOs where the last one did). Every seed gives the same
vertices, edges, delay lengths and wets, so the same work.
"""

from __future__ import annotations

import functools
import struct
from pathlib import Path

import numpy as np

from . import lua

# the parts of the strip every track has
STRIP = ("tape", "eq3", "compressor")
EQ_LOW = (100.0, 150.0, 200.0, 250.0)
EQ_HIGH = (2500.0, 3000.0, 4000.0, 5000.0)


def write_wav24(path: Path, data: np.ndarray, sr: int) -> None:
    """[frames, 2] float in [-1, 1] as 24-bit PCM: scaled by 2^23 - 1,
    clipped and truncated toward zero."""
    v = np.clip(np.trunc(np.asarray(data, np.float64).reshape(-1)
                         * 8388607.0), -8388608, 8388607).astype("<i4")
    b = v.view(np.uint8).reshape(-1, 4)
    packed = np.empty((len(v), 3), np.uint8)
    for k in range(3):
        packed[:, k] = b[:, k]
    raw = packed.tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 2, sr, sr * 6, 6, 24)
           + b"data" + struct.pack("<I", len(raw)))
    Path(path).write_bytes(hdr + raw)


def _hit(sr: int, dur: float, freq: float, decay: float, noise: float,
         rng: np.random.Generator) -> np.ndarray:
    """The `_files.drum` body: a decaying pitch-swept hit, peak 1."""
    t = np.arange(int(sr * dur)) / sr
    body = np.exp(-t * decay) * np.sin(2 * np.pi * freq * t * np.exp(-t * 4))
    if noise > 0:
        body = body + noise * np.exp(-t * decay * 2) * rng.standard_normal(
            len(t))
    return body / np.max(np.abs(body))


@functools.lru_cache(maxsize=256)
def _tone(sr: int, dur: float, freq: float, attack: float, release: float,
          harmonics: int) -> np.ndarray:
    """[frames, 2] a note of `harmonics` partials at 1/h, the right
    channel a few cents up, under an attack-hold-release envelope (kept
    for the next note of the same pitch and shape: read only)."""
    t = np.arange(int(sr * dur)) / sr
    env = np.minimum(1.0, t / attack) * np.exp(
        -np.maximum(t - 0.6 * dur, 0.0) / release)
    out = np.zeros((len(t), 2))
    for ch, det in enumerate((1.0, 1.0029)):
        for h in range(1, harmonics + 1):
            out[:, ch] += np.sin(2 * np.pi * freq * det * h * t) / h
    return out * env[:, None]


def stem(kind: str, sr: int, seconds: float, bpm: float,
         rng: np.random.Generator) -> np.ndarray:
    """[frames, 2] one track's region, peak 0.9: hits or notes on a grid
    of beats, drawn from the seed."""
    n = int(round(sr * seconds))
    beat = 60.0 / bpm
    beats = int(round(seconds / beat))
    out = np.zeros((n + 4 * sr, 2))

    def put(at_s: float, x: np.ndarray, gain: float) -> None:
        i = int(round(at_s * sr))
        x = x if x.ndim == 2 else np.stack([x, x], 1)
        out[i:i + len(x)] += gain * x

    if kind in ("kick", "snare", "hats", "perc"):
        freq, decay, noise, dur, grid = {
            "kick": (rng.uniform(48, 64), rng.uniform(22, 32), 0.0, 0.3, 1),
            "snare": (rng.uniform(170, 220), rng.uniform(28, 40), 0.6, 0.2,
                      1),
            "hats": (rng.uniform(5500, 8000), rng.uniform(70, 95), 1.0, 0.06,
                     4),
            "perc": (rng.uniform(90, 300), rng.uniform(18, 30), 0.2, 0.25, 2),
        }[kind]
        hit = _hit(sr, dur, freq, decay, noise, rng)
        for k in range(beats * grid):
            on = {"kick": k % 4 in (0, 2) or rng.random() < 0.2,
                  "snare": k % 4 in (1, 3),
                  "hats": True,
                  "perc": rng.random() < 0.35}[kind]
            if on or k == 0:
                put(k * beat / grid, hit, rng.uniform(0.6, 1.0))
    else:
        root = {"keys": 57, "bass": 33, "lead": 69, "pad": 45}[kind]
        scale = (0, 2, 3, 5, 7, 8, 10)
        step, length, voices, harm = {
            "keys": (2, 1.8, 3, 4), "bass": (1, 0.45, 1, 3),
            "lead": (0.5, 0.4, 1, 5), "pad": (8, 7.5, 3, 3)}[kind]
        t = 0.0
        while t < beats - 1e-9:
            deg = int(rng.integers(0, 7))
            for v in range(voices):
                d = deg + 2 * v
                note = root + 12 * (d // 7) + scale[d % 7]
                f = 440.0 * 2.0 ** ((note - 69) / 12.0)
                put(t * beat, _tone(sr, length * beat, f, 0.01 if step < 2
                                    else 0.3, 0.1 if step < 2 else 0.8,
                                    harm), rng.uniform(0.5, 0.8))
            t += step
    # the region loops: what rings past its end wraps to its start
    body = out[:n].copy()
    for k in range(n, out.shape[0], n):
        part = out[k:k + n]
        body[:len(part)] += part
    return 0.9 * body / np.max(np.abs(body))


def _u(rng: np.random.Generator, lo: float, hi: float) -> float:
    return round(float(rng.uniform(lo, hi)), 3)


def effect_params(kind: str, rng: np.random.Generator) -> dict:
    """An effect's traced parameters drawn from the seed (the eq3's
    crossovers from EQ_LOW and EQ_HIGH, the LFO rates tempo-synced)."""
    if kind == "tape":
        return {"drive": _u(rng, 1.0, 3.0), "cutoff": _u(rng, 8000, 16000)}
    if kind == "eq3":
        return {"low_freq": float(rng.choice(EQ_LOW)),
                "high_freq": float(rng.choice(EQ_HIGH)),
                "low_gain": _u(rng, -4, 4), "mid_gain": _u(rng, -4, 4),
                "high_gain": _u(rng, -4, 4)}
    if kind == "compressor":
        return {"threshold": _u(rng, -24, -12), "ratio": _u(rng, 2, 6),
                "attack": _u(rng, 5, 30), "release": _u(rng, 80, 250),
                "knee": _u(rng, 3, 8), "makeup": _u(rng, 0, 3)}
    if kind == "chorus":
        return {"rate": float(rng.choice([0.25, 0.5, 1.0])),
                "depth": _u(rng, 2, 5), "base": _u(rng, 6, 12)}
    if kind == "flanger":
        return {"rate": float(rng.choice([0.125, 0.25])),
                "depth": _u(rng, 1, 3), "base": _u(rng, 1, 3)}
    raise ValueError(kind)


def _picked(cfg: dict, key: str, i: int) -> bool:
    every, at = cfg[key]
    return i % int(every) == int(at)


def build(cfg: dict, seed: int, d: Path) -> dict:
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    sr = int(cfg["project_samplerate"])
    n = int(cfg["tracks"])
    plugins: dict = {}
    vertices: list = []
    edges: list = []

    def fx(name: str, kind: str, params: dict, wet: float = 1.0,
           gain: float = 1.0, angle: float = 0.0) -> str:
        plugins[name] = {"kind": kind, "params": params}
        vertices.append({"name": name, "kind": "fx", "wet": wet,
                         "plugin": name, "gain": gain, "angle": angle})
        return name

    def chain(names: list) -> None:
        edges.extend([a, b] for a, b in zip(names, names[1:]))

    samples = {}
    for i in range(n):
        kind = cfg["stems"][i % len(cfg["stems"])]
        write_wav24(d / f"stem{i}.wav",
                    stem(kind, sr, float(cfg["stem_s"]), float(cfg["bpm"]),
                         rng), sr)
        samples[f"stem{i}"] = f"stem{i}.wav"
    vertices.append({"name": "mixbus", "kind": "sum"})
    vertices.append({"name": "verbbus", "kind": "sum"})
    vertices.append({"name": "delaybus", "kind": "sum"})
    for i in range(n):
        gain, angle = _u(rng, 0.5, 1.0), _u(rng, -60, 60)
        vertices.append({"name": f"track{i}", "kind": "sample_loop",
                         "sample": f"stem{i}"})
        names = [f"track{i}"]
        kinds = list(STRIP)
        if _picked(cfg, "chorus_tracks", i):
            kinds.append("chorus")
        if _picked(cfg, "flanger_tracks", i):
            kinds.append("flanger")
        for j, kind in enumerate(kinds):
            last = j == len(kinds) - 1
            wet = 0.5 if kind in ("chorus", "flanger") else 1.0
            names.append(fx(f"{kind}{i}", kind, effect_params(kind, rng),
                            wet, gain if last else 1.0,
                            angle if last else 0.0))
        chain(names)
        out = names[-1]
        edges.append([out, "mixbus"])
        vertices.append({"name": f"verbsend{i}", "kind": "sum",
                         "gain": _u(rng, 0.05, 0.3)})
        chain([out, f"verbsend{i}", "verbbus"])
        if _picked(cfg, "delay_tracks", i):
            vertices.append({"name": f"delaysend{i}", "kind": "sum",
                             "gain": _u(rng, 0.05, 0.25)})
            chain([out, f"delaysend{i}", "delaybus"])
    chain(["verbbus", fx("verb", "reverb", {"room": _u(rng, 0.6, 0.85),
                                             "damp": _u(rng, 0.3, 0.6)}),
           "mixbus"])
    chain(["delaybus", fx("echo", "delay", {
        "time": float(cfg["delay_ms"]),
        "feedback": _u(rng, 0.2, 0.45)}), "mixbus"])
    master_eq = effect_params("eq3", rng)
    master_eq.update({k: _u(rng, -2, 2) for k in
                      ("low_gain", "mid_gain", "high_gain")})
    chain(["mixbus", fx("mastereq", "eq3", master_eq),
           fx("mastercomp", "compressor", {
               "threshold": _u(rng, -12, -6), "ratio": _u(rng, 2, 4),
               "attack": _u(rng, 10, 30), "release": _u(rng, 100, 250),
               "knee": _u(rng, 4, 8), "makeup": 0.0}), "out"])
    vertices.append({"name": "out", "kind": "normalize"})
    spec = {
        "sr": sr, "bl": int(cfg["buffer_length"]),
        "length_s": float(cfg["length_s"]),
        "render_sr": int(cfg["render_samplerate"]),
        "bd": int(cfg["render_bitdepth"]),
        "samples": samples, "plugins": plugins,
        "vertices": vertices, "edges": edges, "output": "out",
        "packets": b"",
    }
    write_project(spec, d)
    return spec


def _vertex(v: dict) -> str:
    """The Lua call of a vertex: the two kinds `lua._vertex` has no form
    for here, the others there."""
    head = (f'"{v["name"]}", {lua._num(v.get("gain", 1.0))}, '
            f'{lua._num(v.get("angle", 0.0))}')
    if v["kind"] == "sample_loop":
        return f'add_sampleloop({head}, "{v["sample"]}");'
    if v["kind"] == "sum":
        return f"add_sum({head});"
    return lua._vertex(v)


def write_project(spec: dict, d: Path) -> None:
    """project.toml and project.lua of `spec` in d (the stems are
    already there)."""
    d = Path(d)
    out = [
        f'set_length({lua._num(spec["length_s"])});',
        f'set_render_samplerate({int(spec["render_sr"])});',
        f'set_render_bitdepth({int(spec["bd"])});',
        f'set_output_file("{d / "outp.wav"}");',
    ]
    out += [f'load_sample("{name}", "{d / f}", "");'
            for name, f in spec["samples"].items()]
    for name, p in spec["plugins"].items():
        out.append(f'load_lv2("{name}", "native:{p["kind"]}");')
        out += [f'parameter("{name}", "{k}", {lua._num(val)});'
                for k, val in p["params"].items()]
    out += [_vertex(v) for v in spec["vertices"]]
    out += [f'connect("{a}", "{b}");' for a, b in spec["edges"]]
    out.append(f'set_output("{spec["output"]}");')
    (d / "project.lua").write_text("\n".join(out) + "\n")
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\n'
        f'buffer_length = {int(spec["bl"])}\n'
        f'project_samplerate = {int(spec["sr"])}\n')
