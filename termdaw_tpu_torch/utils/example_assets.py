"""The shipped examples' asset generator (a copy of examples/_gen.py).

The example projects' Lua reads samples, MIDIs and wavetables from
`../assets/` (examples/*/project.lua); every example ships a
make_assets.py that runs `import _gen; _gen.ensure()` on first open. The
port's CLI (cli.py) runs that hook with `_gen` resolved to this module,
bound to the assets directory beside the project, so an example opens
with nothing of the JAX package loaded. Files are written through the
port's own writers (fileio.wav, fileio.midi, fileio.wavetable) and
drums through utils/fixtures.drum, byte-identical to what _gen.ensure()
writes. Idempotent: existing files are left alone.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..fileio.midi import write_midi
from ..fileio.wav import write_wav
from ..fileio.wavetable import WaveTable, write_wavetable
from .fixtures import drum

SR = 48000


def _drum(path: Path, dur: float, freq: float, decay: float,
          noise: float = 0.0, seed: int = 0, sr: int = SR) -> None:
    if path.exists():
        return
    drum(path, sr, dur, freq, decay, noise=noise, seed=seed)


def _pad_loop(path: Path, dur: float = 4.0, sr: int = SR) -> None:
    """Soft background pad (three detuned saw-ish partial stacks), loopable."""
    if path.exists():
        return
    t = np.arange(int(sr * dur)) / sr
    x = np.zeros((len(t), 2), np.float64)
    for i, f in enumerate([110.0, 165.0, 220.0]):
        for h in range(1, 6):
            amp = 0.4 / (h * (i + 1))
            x[:, 0] += amp * np.sin(2 * np.pi * f * h * t + 0.1 * i)
            x[:, 1] += amp * np.sin(2 * np.pi * f * h * t * 1.003 + 0.2 * i)
    # gentle amplitude motion, ends where it starts (loop-safe)
    lfo = 0.8 + 0.2 * np.sin(2 * np.pi * t / dur)
    x *= lfo[:, None]
    x = (0.6 * x / np.max(np.abs(x))).astype(np.float32)
    write_wav(path, x, sr, bits=16)


def _table(path: Path, kind: str) -> None:
    """Wavetables with distinct harmonic evolutions for sampsyn."""
    if path.exists():
        return
    w = 2048
    x = np.arange(w) / w
    if kind == "bright":
        start = sum(np.sin(2 * np.pi * h * x) / h for h in range(1, 17))
        end = np.sin(2 * np.pi * x)
        times = [0.0, 1.0]
        waves = [start, end]
    elif kind == "hollow":
        # odd harmonics only (square-ish), mellowing over time
        start = sum(np.sin(2 * np.pi * h * x) / h for h in range(1, 16, 2))
        mid = sum(np.sin(2 * np.pi * h * x) / h for h in range(1, 8, 2))
        end = np.sin(2 * np.pi * x)
        times = [0.0, 0.4, 1.5]
        waves = [start, mid, end]
    else:  # "nylon": plucked-string-like, fast decay of highs
        start = sum(
            np.sin(2 * np.pi * h * x) / (h ** 1.5) for h in range(1, 24)
        )
        end = np.sin(2 * np.pi * x) + 0.15 * np.sin(4 * np.pi * x)
        times = [0.0, 0.8]
        waves = [start, end]
    waves = np.stack(
        [wv / np.max(np.abs(wv)) for wv in waves]
    ).astype(np.float32)
    write_wavetable(
        path, WaveTable(np.asarray(times, np.float32), waves)
    )


def _midis(assets: Path) -> None:
    """Four-on-the-floor-ish patterns over 40 s at 120 bpm, mirroring the
    roles of the reference's music-gen MIDIs (kick/snare/hat/ride/bass/
    comping)."""
    bars = 20  # 2 s per bar at 120 bpm
    kicks, snares, hats, rides, bass, comp = [], [], [], [], [], []
    for bar in range(bars):
        t0 = bar * 2.0
        kicks += [(t0, 0.1, 36, 110), (t0 + 1.0, 0.1, 36, 100)]
        if bar % 4 == 3:
            kicks.append((t0 + 1.75, 0.1, 36, 90))
        snares += [(t0 + 0.5, 0.1, 38, 100), (t0 + 1.5, 0.1, 38, 105)]
        hats += [
            (t0 + i * 0.25, 0.05, 42, 70 + (i % 2) * 25) for i in range(8)
        ]
        if bar % 2 == 0:
            rides += [(t0 + i * 0.5, 0.2, 51, 60 + 10 * (i % 2))
                      for i in range(4)]
        root = [45, 41, 43, 48][bar % 4]
        bass += [(t0, 0.9, root - 12, 100), (t0 + 1.0, 0.45, root - 5, 90),
                 (t0 + 1.5, 0.45, root - 12, 85)]
        comp += [(t0 + 0.25, 1.5, root + 12, 70),
                 (t0 + 0.25, 1.5, root + 16, 62),
                 (t0 + 0.25, 1.5, root + 19, 66)]
    for name, notes in [
        ("bassd", kicks), ("snare", snares), ("hihat", hats),
        ("ride", rides), ("bass", bass), ("comping", comp),
    ]:
        p = assets / f"{name}.mid"
        if not p.exists():
            write_midi(p, notes, bpm=120)


def ensure(assets: Path) -> Path:
    """Generate every shared asset into `assets` (skipping existing
    files); returns `assets`."""
    assets = Path(assets)
    assets.mkdir(parents=True, exist_ok=True)
    _drum(assets / "kick.wav", 0.25, 55.0, 26.0)
    _drum(assets / "snare.wav", 0.18, 190.0, 32.0, noise=0.6, seed=1)
    _drum(assets / "snare_damped.wav", 0.09, 180.0, 60.0, noise=0.5, seed=4)
    _drum(assets / "hihat_closed.wav", 0.06, 6000.0, 80.0, noise=1.0, seed=2)
    _drum(assets / "hihat_tight.wav", 0.04, 7000.0, 120.0, noise=1.0, seed=5)
    _drum(assets / "ride.wav", 0.8, 3200.0, 6.0, noise=0.35, seed=3)
    _pad_loop(assets / "bg.wav")
    _table(assets / "testtable.wt", "bright")
    _table(assets / "hollowbody.wt", "hollow")
    _table(assets / "nylon.wt", "nylon")
    _midis(assets)
    return assets
