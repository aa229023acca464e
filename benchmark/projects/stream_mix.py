"""termdaw's streamed multitrack mix: n streamed SampleMulti tracks, panned
across the field, over one drum hit recorded at a higher rate than the
project's (resampled on import) into a Normalize, rendered at 32 bits.

A frozen copy of the program's c5 project writer (its
`utils/fixtures.write_c5_project`) as a spec. The seed draws the hit's
noise and each track's hit times and velocities; every seed has the same
number of hits on every track, so the same work. `packets` are the
floww packets (one a track) that fill the declared streams.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import _files
from .lua import write_project


def hits(cfg: dict, rng: np.random.Generator) -> list[np.ndarray]:
    """Per track, [hits, 4] float32 rows (id 0, t_s, note 36, vel)."""
    n, length_s = int(cfg["tracks"]), float(cfg["length_s"])
    k = int(cfg["hits_per_track"])
    out = []
    for _ in range(n):
        times = np.sort(rng.uniform(0.0, length_s * 0.95, size=k))
        out.append(np.stack(
            [np.zeros(k), times, np.full(k, 36.0), rng.uniform(0.4, 1.0, k)],
            axis=1).astype(np.float32))
    return out


def build(cfg: dict, seed: int, d: Path) -> dict:
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(cfg["tracks"])
    _files.drum(d / "hit.wav", int(cfg["hit_samplerate"]), 0.08, 400.0,
                40.0, noise=0.4, seed=int(rng.integers(0, 2**31)))
    tracks = hits(cfg, rng)
    vertices = [{"name": "sum", "kind": "normalize"}]
    edges = []
    for i in range(n):
        vertices.append({"name": f"t{i}", "kind": "sample_multi",
                         "angle": round((i / n) * 180.0 - 90.0, 2),
                         "sample": "hit", "floww": f"s{i}", "note": -1})
        edges.append([f"t{i}", "sum"])
    spec = {
        "sr": int(cfg["project_samplerate"]), "bl": int(cfg["buffer_length"]),
        "length_s": float(cfg["length_s"]),
        "render_sr": int(cfg["render_samplerate"]),
        "bd": int(cfg["render_bitdepth"]),
        "samples": {"hit": "hit.wav"},
        "streams": [f"s{i}" for i in range(n)],
        "vertices": vertices, "edges": edges, "output": "sum",
        "stream_events": {f"s{i}": tracks[i] for i in range(n)},
        "packets": b"".join(_files.encode_events(f"s{i}", tracks[i])
                            for i in range(n)),
    }
    write_project(spec, d)
    return spec
