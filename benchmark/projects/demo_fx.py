"""termdaw's demo project with native effects: SampleLerp kick and hat, a
SampleMulti snare, a Synth bass and a wavetable SampSyn chord track
ducked by an Adsr on the kick, a BandPass, then reverb -> compressor ->
eq3 -> delay into a Normalize.

A frozen copy of the program's c4 project writer (its
`utils/fixtures.write_c4_project`, the reference's
`build_demo_project(include_fx=True)`), as a spec. The seed draws the
snare's and hat's noise, the order of the four chord roots and the hats'
accents; every seed has the same events at the same times, so the same
work.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import _files
from .lua import write_project

HIT_ADSR = [0.001, 0.02, 0.0, 0.0, 0.0, 0.0]
NOTE_ADSR = [0.01, 0.1, 0.8, 5.0, 0.2, 0.5]
DUCK_ADSR = [1.0, 0.01, 0.4, 0.25, 0.4, 0.0, 0.0, 0.05, 1.0]


def events(length_s: float, rng: np.random.Generator) -> dict:
    """The five MIDI parts as (start_s, dur_s, note, velocity) lists."""
    roots = [int(r) for r in rng.permutation([45, 41, 43, 48])]
    accent = int(rng.integers(0, 2))
    beats, snares, hats, bass, chords = [], [], [], [], []
    for bar in range(max(1, int(length_s / 2.0))):
        t0 = bar * 2.0
        beats += [(t0, 0.1, 36, 110), (t0 + 1.0, 0.1, 36, 100)]
        snares += [(t0 + 0.5, 0.1, 38, 100), (t0 + 1.5, 0.1, 38, 105)]
        hats += [(t0 + i * 0.25, 0.05, 42, 70 + ((i + accent) % 2) * 20)
                 for i in range(8)]
        root = roots[bar % 4]
        bass += [(t0, 0.9, root - 12, 100), (t0 + 1.0, 0.9, root - 5, 90)]
        chords += [(t0, 1.8, root + 12, 70), (t0, 1.8, root + 16, 60),
                   (t0, 1.8, root + 19, 65)]
    return {"kick": beats, "snare": snares, "hat": hats, "bass": bass,
            "chords": chords}


def build(cfg: dict, seed: int, d: Path) -> dict:
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    sr = int(cfg["project_samplerate"])
    snare_seed, hat_seed = (int(s) for s in rng.integers(0, 2**31, 2))
    _files.drum(d / "kick.wav", sr, 0.18, 55.0, 28.0)
    _files.drum(d / "snare.wav", sr, 0.15, 190.0, 35.0, noise=0.6,
                seed=snare_seed)
    _files.drum(d / "hat.wav", sr, 0.06, 6000.0, 80.0, noise=1.0,
                seed=hat_seed)
    parts = events(float(cfg["length_s"]), rng)
    for name, ev in parts.items():
        _files.write_midi(d / f"{name}.mid", ev, bpm=120)
    _files.write_wavetable(d / "table.wt", *_files.default_wavetable())
    spec = {
        "sr": sr, "bl": int(cfg["buffer_length"]),
        "length_s": float(cfg["length_s"]),
        "render_sr": int(cfg["render_samplerate"]),
        "bd": int(cfg["render_bitdepth"]),
        "samples": {"kick": "kick.wav", "snare": "snare.wav",
                    "hat": "hat.wav"},
        "midi": {name: f"{name}.mid" for name in parts},
        "tables": {"tbl": "table.wt"},
        "plugins": {
            "verb": {"kind": "reverb", "params": {}},
            "comp": {"kind": "compressor",
                     "params": {"Attack": 30.0, "Ratio": 3.0}},
            "eq": {"kind": "eq3",
                   "params": {"low freq": 180.0, "low gain": -3.0,
                              "high gain": 2.0}},
            "del": {"kind": "delay",
                    "params": {"time": 120.0, "feedback": 0.35}},
        },
        "vertices": [
            {"name": "kick", "kind": "sample_lerp", "gain": 1.2,
             "sample": "kick", "floww": "kick", "note": -1, "lerp_len": 40},
            {"name": "snare", "kind": "sample_multi", "gain": 0.9,
             "sample": "snare", "floww": "snare", "note": -1},
            {"name": "hat", "kind": "sample_lerp", "gain": 0.4,
             "angle": 40.0, "sample": "hat", "floww": "hat", "note": -1,
             "lerp_len": 40},
            {"name": "bass", "kind": "synth", "gain": 0.5, "floww": "bass",
             "sq": [0.4, 0.3, HIT_ADSR], "tf": [1.0, 0.8, NOTE_ADSR],
             "tr": [0.0, []]},
            {"name": "chords", "kind": "sampsyn", "gain": 0.35,
             "angle": -20.0, "floww": "chords", "conf": NOTE_ADSR,
             "table": "tbl"},
            {"name": "duck", "kind": "adsr", "wet": 1.0, "floww": "kick",
             "use_off": False, "use_max": False, "note": -1,
             "conf": DUCK_ADSR},
            {"name": "band", "kind": "bandpass", "wet": 1.0,
             "cut_low": 8000.0, "cut_high": 30.0, "pass_mode": True},
            {"name": "fxverb", "kind": "fx", "wet": 0.4, "plugin": "verb"},
            {"name": "fxcomp", "kind": "fx", "wet": 1.0, "plugin": "comp"},
            {"name": "fxeq", "kind": "fx", "wet": 1.0, "plugin": "eq"},
            {"name": "fxdel", "kind": "fx", "wet": 0.3, "plugin": "del"},
            {"name": "sum", "kind": "normalize"},
        ],
        "edges": [["kick", "sum"], ["snare", "sum"], ["hat", "sum"],
                  ["bass", "duck"], ["chords", "duck"], ["duck", "band"],
                  ["band", "fxverb"], ["fxverb", "fxcomp"],
                  ["fxcomp", "fxeq"], ["fxeq", "fxdel"], ["fxdel", "sum"]],
        "output": "sum",
        "packets": b"",
    }
    write_project(spec, d)
    return spec
