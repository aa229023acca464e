"""A pianist-arranger's sampled-piano session, DAWBench VI's layout with a
multisampled instrument: n piano tracks over one shared library, each
playing its own part, the tracks summed in groups on bus Sums and the
buses into a master Normalize, bounced to a 24-bit WAV.

The library has a sample for every key of `keys` in each of
`velocity_layers` layers. A track is one SampleMulti a key and layer,
`add_sample_multi(name, 1, 0, sample, floww, key)` into the track's Sum:
a layer's notes are one floww (one MIDI file), and each SampleMulti
plays the hits of its key. A note goes to the first layer whose upper
velocity it is under (`layer_split`; the last layer takes the rest).

A bar holds `left_hand["chords"]` chords of `left_hand["notes"]` notes on
the beats 1, 3, ... (onsets spread by distinct tick offsets in
`spread_ticks`, so that no two share a frame: termdaw's drum rule keeps
a frame's first on-event only) and `right_hand["notes"]` notes on as many
of the off-beat sixteenths, each moved by up to `jitter_ms`. Onset times
come from a generator seeded by the track alone; the seed draws the
pitches, velocities, track gains and pans and the library's partials.
Note counts, times and registers are the same for every seed.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from . import _files, lua

TPQ = 480            # MIDI ticks a quarter note (_files.write_midi's)
TIMES_SEED = 1010    # onset times: the same for every seed
TILE_S = 2.0         # a sample's partials repeat every TILE_S seconds
PARTIALS = 16


def sample_s(cfg: dict, key: int) -> float:
    """The sample length of `key`, falling linearly over the keyboard."""
    lo, hi = cfg["keys"]
    s_lo, s_hi = cfg["sample_s"]
    return s_lo + (s_hi - s_lo) * (key - lo) / (hi - lo)


def layer_of(vel: int, cfg: dict) -> int:
    """The layer of a MIDI velocity (0-127): 0 under `layer_split`, else
    the next; with more layers the splits are spaced evenly above it."""
    n = int(cfg["velocity_layers"])
    split = float(cfg["layer_split"])
    v = vel / 127.0
    if v < split or n == 1:
        return 0
    return 1 + min(n - 2, int((v - split) / ((1.0 - split) / (n - 1))))


def key_samples(cfg: dict, key: int, rng: np.random.Generator) -> list:
    """[frames, 2] int16 samples of `key`, one a layer, peak 0.9 of full
    scale: a TILE_S tile of stretched partials (each a whole number of
    cycles in the tile, so the tile repeats seamlessly; made by an inverse
    FFT) under one envelope (a 2 ms attack, a decay over the sample, a
    50 ms fade to 0), panned a little by the key; the soft layers roll
    off faster."""
    sr = int(cfg["library_sr"])
    n = int(round(sample_s(cfg, key) * sr))
    tile = int(TILE_S * sr)
    f0 = 440.0 * 2.0 ** ((key - 69) / 12.0)
    h = np.arange(1, PARTIALS + 1)
    stretch = rng.uniform(1e-4, 4e-4)
    cycles = np.round(h * f0 * np.sqrt(1 + stretch * h * h) * TILE_S)
    cycles = cycles[cycles < 0.45 * tile].astype(np.int64)
    rot = np.exp(2j * np.pi * rng.uniform(0, 1, len(cycles)))
    strength = rng.uniform(0.3, 1.0, len(cycles))
    env = np.exp(np.arange(n, dtype=np.float32) * np.float32(-4.0 / n))
    a = min(n, int(0.002 * sr))
    env[:a] *= np.linspace(0, 1, a, dtype=np.float32)
    f = min(n, int(0.05 * sr))
    env[n - f:] *= np.linspace(1, 0, f, dtype=np.float32)
    pan = 0.3 * (key - 64.5) / 44.0
    gains = np.float32([1 - pan, 1 + pan]) / np.float32(1 + abs(pan))
    layers = int(cfg["velocity_layers"])
    out = []
    for layer in range(layers):
        roll = 1.0 + 1.2 * (layers - 1 - layer) / max(1, layers - 1)
        spec = np.zeros(tile // 2 + 1, np.complex128)
        np.add.at(spec, cycles, strength * np.arange(1, len(cycles) + 1)
                  ** -roll * rot)
        x = np.resize(np.fft.irfft(spec, tile).astype(np.float32), n)
        x *= env
        x *= np.float32(0.9 * 32767 / np.max(np.abs(x)))
        out.append((x[:, None] * gains).astype(np.int16))
    return out


def write_wav16(path: Path, ints: np.ndarray, sr: int) -> None:
    """[frames, 2] int16 as a 16-bit PCM WAV (_files.write_wav16's
    layout, without its float pass)."""
    raw = np.ascontiguousarray(ints, "<i2").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 2, sr, sr * 4, 4, 16)
           + b"data" + struct.pack("<I", len(raw)))
    Path(path).write_bytes(hdr + raw)


def part(cfg: dict, track: int, rng: np.random.Generator) -> list:
    """One track's (tick, note, velocity 0-127) list of on-events."""
    spt_s = 60.0 / (float(cfg["bpm"]) * TPQ)
    bar = int(round(float(cfg["bar_s"]) / spt_s))
    beat = TPQ
    six = TPQ // 4
    lh, rh = cfg["left_hand"], cfg["right_hand"]
    trng = np.random.default_rng([TIMES_SEED, track])
    chords = int(lh["chords"])
    off_beats = [s for s in range(bar // six)
                 if s not in {8 * c for c in range(chords)}]
    jit = int(round(float(rh["jitter_ms"]) / 1e3 / spt_s))
    lo_s, hi_s = lh["spread_ticks"]
    lo_p, hi_p = int(lh["low"]), int(lh["high"])
    width = min(12, hi_p - lo_p)     # a chord lies within an octave
    notes = []
    for b in range(int(round(float(cfg["length_s"]) / float(cfg["bar_s"])))):
        t0 = b * bar
        for c in range(chords):
            spread = trng.choice(np.arange(lo_s, hi_s + 1), int(lh["notes"]),
                                 replace=False)
            root = int(rng.integers(lo_p, hi_p - width + 1))
            chord = root + np.sort(rng.choice(width + 1, int(lh["notes"]),
                                              replace=False))
            for p, s in zip(chord, spread):
                notes.append((t0 + 2 * c * beat + int(s), int(p)))
        for s in sorted(trng.choice(off_beats, int(rh["notes"]),
                                    replace=False)):
            notes.append((t0 + int(s) * six + int(trng.integers(-jit,
                                                                 jit + 1)),
                          int(rng.integers(int(rh["low"]),
                                           int(rh["high"]) + 1))))
    lo_v, hi_v = cfg["velocity"]
    return [(t, p, int(round(127 * rng.uniform(lo_v, hi_v))))
            for t, p in notes]


def build(cfg: dict, seed: int, d: Path) -> dict:
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n, group = int(cfg["tracks"]), int(cfg["bus_tracks"])
    layers = int(cfg["velocity_layers"])
    k_lo, k_hi = (int(k) for k in cfg["keys"])
    sr = int(cfg["library_sr"])
    samples = {}
    for key in range(k_lo, k_hi + 1):
        for layer, x in enumerate(key_samples(cfg, key, rng)):
            name = f"k{key}v{layer}"
            write_wav16(d / f"{name}.wav", x, sr)
            samples[name] = f"{name}.wav"
    spt_s = 60.0 / (float(cfg["bpm"]) * TPQ)
    hold = (float(cfg["left_hand"]["hold_s"]),
            float(cfg["right_hand"]["hold_s"]))
    midi: dict = {}
    vertices: list = [{"name": f"bus{b}", "kind": "sum"}
                      for b in range(-(-n // group))]
    edges: list = []
    for i in range(n):
        by_layer: list = [[] for _ in range(layers)]
        for tick, p, vel in part(cfg, i, rng):
            by_layer[layer_of(vel, cfg)].append(
                (tick * spt_s, hold[p >= cfg["right_hand"]["low"]], p, vel))
        for layer, notes in enumerate(by_layer):
            name = f"part{i}v{layer}"
            _files.write_midi(d / f"{name}.mid", notes, tpq=TPQ,
                              bpm=float(cfg["bpm"]))
            midi[name] = f"{name}.mid"
        vertices.append({"name": f"track{i}", "kind": "sum",
                         "gain": round(float(rng.uniform(0.5, 1.0)), 3),
                         "angle": round(float(rng.uniform(-60, 60)), 3)})
        edges.append([f"track{i}", f"bus{i // group}"])
        for key in range(k_lo, k_hi + 1):
            for layer in range(layers):
                name = f"t{i}k{key}v{layer}"
                vertices.append({"name": name, "kind": "sample_multi",
                                 "sample": f"k{key}v{layer}",
                                 "floww": f"part{i}v{layer}", "note": key})
                edges.append([name, f"track{i}"])
    vertices.append({"name": "out", "kind": "normalize"})
    edges += [[f"bus{b}", "out"] for b in range(-(-n // group))]
    spec = {
        "sr": int(cfg["project_samplerate"]), "bl": int(cfg["buffer_length"]),
        "length_s": float(cfg["length_s"]),
        "render_sr": int(cfg["render_samplerate"]),
        "bd": int(cfg["render_bitdepth"]),
        "samples": samples, "midi": midi,
        "vertices": vertices, "edges": edges, "output": "out",
        "packets": b"",
    }
    write_project(spec, d)
    return spec


def write_project(spec: dict, d: Path) -> None:
    """project.toml and project.lua of `spec` in d (the samples and MIDI
    files are already there)."""
    d = Path(d)
    out = [
        f'set_length({lua._num(spec["length_s"])});',
        f'set_render_samplerate({int(spec["render_sr"])});',
        f'set_render_bitdepth({int(spec["bd"])});',
        f'set_output_file("{d / "outp.wav"}");',
    ]
    out += [f'load_sample("{name}", "{d / f}", "");'
            for name, f in spec["samples"].items()]
    out += [f'load_midi_floww("{name}", "{d / f}");'
            for name, f in spec["midi"].items()]
    for v in spec["vertices"]:
        if v["kind"] == "sum":
            out.append(f'add_sum("{v["name"]}", '
                       f'{lua._num(v.get("gain", 1.0))}, '
                       f'{lua._num(v.get("angle", 0.0))});')
        else:
            out.append(lua._vertex(v))
    out += [f'connect("{a}", "{b}");' for a, b in spec["edges"]]
    out.append(f'set_output("{spec["output"]}");')
    (d / "project.lua").write_text("\n".join(out) + "\n")
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\n'
        f'buffer_length = {int(spec["bl"])}\n'
        f'project_samplerate = {int(spec["sr"])}\n')
