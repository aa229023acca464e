"""An arranger's virtual-instrument session, DAWBench VI's layout: n
instrument tracks, each playing its own copy of one dense polyphonic part
on its own instrument, the tracks summed in groups on bus Sums and the
buses into a master Normalize, bounced to a 24-bit WAV.

Even tracks are wavetable SampSyns, each with its own table of K
snapshots; odd tracks are three-oscillator Synths with every oscillator
on. Every track uses the configuration's one ADSR. A track's part is a
six-note chord a bar, held `chord_hold_s`, and a sixteenth-note arpeggio
over the chord's tones `arp_up` semitones (one octave) higher, each step
held `arp_hold_s`. Chords are voiced inside one octave, so the arpeggio
lies above the chord's top: chord and arpeggio registers are disjoint,
and no chord pitch is ever an arpeggio pitch.

The seed draws the progression's order from the fixed CHORDS, each
track's arpeggio orders, every velocity (0.5-1.0), the track gains
(0.5-1.0) and pans (-60..60) and the tables' harmonics. A chord's
voicing is its pitch classes' one placement in the octave. Event times,
note counts, vertices and edges are the same for every seed, so every
seed does the same work.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import _files, lua

# six distinct pitch classes each (root + extensions), so that a voicing
# places six distinct pitches
CHORDS = (
    (0, 2, 4, 7, 9, 11),     # C major 13 (no 11)
    (9, 11, 0, 2, 4, 7),     # A minor 11
    (5, 7, 9, 0, 2, 4),      # F major 13 (no 11)
    (7, 9, 11, 2, 5, 4),     # G 13
    (2, 4, 5, 9, 0, 7),      # D minor 11
    (4, 6, 7, 11, 2, 9),     # E minor 11
    (10, 0, 2, 5, 7, 9),     # B-flat major 13 (no 11)
    (11, 1, 2, 6, 9, 4),     # B minor 11
)
LOW = 45                     # the chords' register: LOW .. LOW + 11


def voicing(pcs) -> list[int]:
    """The pitch classes placed in [LOW, LOW + 11]; ascending."""
    return sorted(LOW + (pc - LOW) % 12 for pc in pcs)


def part(cfg: dict, order: list, rng: np.random.Generator) -> list:
    """One track's (start_s, dur_s, note, velocity 0-127) list."""
    bar = float(cfg["bar_s"])
    step = float(cfg["arp_step_s"])
    steps = int(round(bar / step))
    notes = []
    for b in range(int(round(float(cfg["length_s"]) / bar))):
        t0 = b * bar
        chord = voicing(CHORDS[order[b % len(order)]])
        for p in chord:
            notes.append((t0, float(cfg["chord_hold_s"]), p,
                          int(round(127 * rng.uniform(0.5, 1.0)))))
        arp = [p + int(cfg["arp_up"]) for p in rng.permutation(chord)]
        for j in range(steps):
            notes.append((t0 + j * step, float(cfg["arp_hold_s"]),
                          arp[j % len(arp)],
                          int(round(127 * rng.uniform(0.5, 1.0)))))
    return notes


def wavetable(cfg: dict, rng: np.random.Generator):
    """(times [K], waves [K, W]) float32: snapshot k a sum of harmonics at
    seeded amplitudes rolling off faster with k, and seeded phases, peak
    1."""
    tcfg = cfg["table"]
    times = np.asarray(tcfg["times"], np.float32)
    w, H = int(tcfg["width"]), int(tcfg["harmonics"])
    x = np.arange(w) / w
    waves = np.zeros((len(times), w))
    for k in range(len(times)):
        for h in range(1, H + 1):
            amp = rng.uniform(0.2, 1.0) * h ** -(0.5 + 0.5 * k)
            waves[k] += amp * np.sin(2 * np.pi * h * x
                                     + rng.uniform(0, 2 * np.pi))
        waves[k] /= np.max(np.abs(waves[k]))
    return times, waves.astype(np.float32)


def build(cfg: dict, seed: int, d: Path) -> dict:
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n, group = int(cfg["tracks"]), int(cfg["bus_tracks"])
    adsr = [float(v) for v in cfg["adsr"]]
    syn = cfg["synth"]
    order = [int(i) for i in rng.permutation(len(CHORDS))]
    midi, tables = {}, {}
    vertices: list = [{"name": f"bus{b}", "kind": "sum"}
                      for b in range(-(-n // group))]
    edges: list = []
    for i in range(n):
        _files.write_midi(d / f"part{i}.mid", part(cfg, order, rng),
                          bpm=float(cfg["bpm"]))
        midi[f"part{i}"] = f"part{i}.mid"
        v = {"name": f"track{i}", "floww": f"part{i}",
             "gain": round(float(rng.uniform(0.5, 1.0)), 3),
             "angle": round(float(rng.uniform(-60, 60)), 3)}
        if i % 2 == 0:
            _files.write_wavetable(d / f"table{i}.wt", *wavetable(cfg, rng))
            tables[f"table{i}"] = f"table{i}.wt"
            v.update(kind="sampsyn", conf=adsr, table=f"table{i}")
        else:
            v.update(kind="synth", sq=[*syn["sq"], adsr],
                     tf=[*syn["tf"], adsr], tr=[syn["tr"], adsr])
        vertices.append(v)
        edges.append([f"track{i}", f"bus{i // group}"])
    vertices.append({"name": "out", "kind": "normalize"})
    edges += [[f"bus{b}", "out"] for b in range(-(-n // group))]
    spec = {
        "sr": int(cfg["project_samplerate"]), "bl": int(cfg["buffer_length"]),
        "length_s": float(cfg["length_s"]),
        "render_sr": int(cfg["render_samplerate"]),
        "bd": int(cfg["render_bitdepth"]),
        "midi": midi, "tables": tables,
        "vertices": vertices, "edges": edges, "output": "out",
        "packets": b"",
    }
    write_project(spec, d)
    return spec


def write_project(spec: dict, d: Path) -> None:
    """project.toml and project.lua of `spec` in d (the MIDI files and
    wavetables are already there)."""
    d = Path(d)
    out = [
        f'set_length({lua._num(spec["length_s"])});',
        f'set_render_samplerate({int(spec["render_sr"])});',
        f'set_render_bitdepth({int(spec["bd"])});',
        f'set_output_file("{d / "outp.wav"}");',
    ]
    out += [f'load_midi_floww("{name}", "{d / f}");'
            for name, f in spec["midi"].items()]
    out += [f'load_resource("{name}", "{d / f}");'
            for name, f in spec["tables"].items()]
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
