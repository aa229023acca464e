"""The port against the plain reference of an instrument session
(benchmark/reference/poly.py, the benchmark's own) on the CPU, at a tiny
size of the benchmark's layout (benchmark/projects/poly_session.py): two
Synths with all three oscillators and two SampSyns with K = 4 tables, a
4 s song over three renders, every note arm's table pinned at 32 slots.
Also the window counters of the note arms' tables (`note_slots`,
`note_voices`) against a count of the tables a window packed, for live
and chain-served windows, and the live bake's `notes`."""

from __future__ import annotations

import contextlib
import io
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.projects import mix_session as ms
from benchmark.projects import poly_session as ps
from benchmark.reference import poly
from termdaw_tpu_torch.fileio.wav import read_wav
from termdaw_tpu_torch.utils import prof
from termdaw_tpu_torch.utils.fixtures import load_state

ROOT = Path(__file__).resolve().parents[1]
FULL = float(2 ** 23 - 1)

# the float32 signal path against float64, after the 24-bit truncation
# (1.2e-7 of full scale): the float32 oscillators (the sine's range
# reduction, the table's lerps and blend), each voice's float32 product
# of velocity, envelope and amplitude and the slots' float32 sums, about
# 6e-8 of a track's peak a step, then the buses' sums and the Normalize's
# division
SOUND = 2e-6


def session(d: Path, seed: int = 20261018) -> dict:
    """The benchmark's layout at 4 tracks over a 4 s song (two bars):
    tracks 0 and 2 SampSyns, 1 and 3 Synths, two buses of two."""
    cfg = json.loads((ROOT / "benchmark/configs/c9_poly32.json").read_text())
    cfg.update({"tracks": 4, "bus_tracks": 2, "length_s": 4.0})
    return ps.build(cfg, seed, d)


def _render(d: Path, renders: int):
    with contextlib.redirect_stdout(io.StringIO()):
        st = load_state(d, torch.device("cpu"))
        for _ in range(renders):
            st.render()
    return st


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap of the WAV's integers from the reference's unrounded
    samples, as a share of full scale."""
    assert got.shape == want.shape
    want = np.clip(want, -FULL - 1, FULL)
    return float(np.abs(got.astype(np.float64) - want).max() / FULL)


def test_port_matches_the_poly_reference(tmp_path):
    """Three renders (the third starts with the SampSyns' release tails
    the second left, the Synths' voices cleared) against the reference's
    third pass; the reference in bfloat16 fails the same tolerance."""
    torch.set_num_threads(1)
    spec = session(tmp_path)
    kinds = [v["kind"] for v in spec["vertices"] if "floww" in v]
    assert kinds == ["sampsyn", "synth", "sampsyn", "synth"]
    st = _render(tmp_path, 3)
    names = st.compiled.graph.names
    slots = {names[int(k)]: c["p"] for k, c in st.compiled.bake_caps.items()
             if "p" in c}
    assert slots == {f"track{i}": 32 for i in range(4)}
    got, info = read_wav(tmp_path / "outp.wav")
    assert (info.sample_rate, info.bits_per_sample) == (48000, 24)
    want = poly.bounce(spec, tmp_path, 3)
    assert np.abs(want).max() > 0.5 * FULL
    assert _gap(got, want) < SOUND
    low = poly.bounce(spec, tmp_path, 3, cast=poly.bf16)
    assert _gap(np.trunc(low), want) > SOUND


def test_poly_voices_follow_termdaw_note_rules():
    """A note-off drops the released voices of its pitch and releases the
    held ones; other pitches are untouched; a Synth's voices end with
    their render, a SampSyn's run on."""
    sr, bl, F = 1000, 10, 1000
    rows = np.array([[0.1, 60, 1.0], [0.2, 60, 0.0],    # released at 200
                     [0.3, 60, 0.8], [0.4, 60, 0.0],    # drops the first
                     [0.35, 62, 0.5], [0.95, 64, 0.7]])  # held past the end
    on, off, end, note, vel = poly.voices_of(rows, sr, bl, F, 2, 0.5, False)
    tail = 500 + 2 * bl
    assert on[:4].tolist() == [100, 300, 350, 950]
    assert off[:4].tolist() == [200, 400, -1, -1]
    assert end[:4].tolist() == [400, 400 + tail, 2 * F, 2 * F]
    assert note[:4].tolist() == [60, 60, 62, 64]
    _, _, end_s, _, _ = poly.voices_of(rows, sr, bl, F, 2, 0.5, True)
    assert end_s[:4].tolist() == [400, 400 + tail, F, F]
    assert end_s[4:].tolist() == [F + 400, F + 400 + tail, 2 * F, 2 * F]


def _fill(ints: torch.Tensor, layout) -> tuple[int, int]:
    """(slots, voices) of the `idx` tables in a packed window."""
    slots = voices = 0
    for _vkey, field, kind, off, shape in layout:
        if field == "idx":
            a = ints[off:off + int(np.prod(shape))].numpy()
            slots += a.size
            voices += int((a >= 0).sum())
    return slots, voices


def test_note_counters_count_the_packed_tables(tmp_path):
    """Render 1 is served from the seeded chain, render 2 bakes live and
    is recorded, render 3 is served from that recording: the counters
    rise by each window's count of its packed idx tables, and each live
    bake is one `window.bake` span."""
    torch.set_num_threads(1)
    session(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        st = load_state(tmp_path, torch.device("cpu"))
        cg = st.compiled
        st.render()
        seeded = [_fill(w[0], w[2]) for w in cg._prebaked["wins"]]
        assert cg.served_windows == len(seeded) and cg.live_bakes == 0
        assert (cg.note_slots, cg.note_voices) == tuple(
            np.sum(seeded, axis=0))
        t0 = time.perf_counter()
        with prof.recording():
            st.render()
        bakes = [r for r in prof.records()
                 if r.name == "window.bake" and r.t0 >= t0]
        st.render()
    rec = cg._recorded[-1]["wins"]
    live = [_fill(w[0], w[2]) for w in rec]
    assert cg.live_bakes == len(live) == len(bakes)
    assert cg.served_windows == len(seeded) + len(live)
    want = np.sum(seeded, axis=0) + 2 * np.sum(live, axis=0)
    assert (cg.note_slots, cg.note_voices) == tuple(want)
    assert 0 < cg.note_voices < cg.note_slots


def test_note_counters_stay_zero_without_note_arms(tmp_path):
    """A session of SampleLoops, Sums and effects has no instance table."""
    cfg = json.loads((ROOT / "benchmark/configs/c8_mix64.json").read_text())
    cfg.update({"tracks": 2, "length_s": 1.0, "stem_s": 0.5})
    ms.build(cfg, 5, tmp_path)
    torch.set_num_threads(1)
    st = _render(tmp_path, 2)
    assert st.compiled.live_bakes + st.compiled.served_windows > 0
    assert (st.compiled.note_slots, st.compiled.note_voices) == (0, 0)


@pytest.mark.parametrize("K", [1, 4])
def test_work_poly_counts_sounding_voice_frames(tmp_path, K):
    """The SampSyn work model: one voice's frames from its on to its
    release's end, its operations a frame by the table's snapshots, its
    bytes the table, the note's columns, its blocks and the track's mix."""
    from benchmark.harness import work_poly
    from benchmark.projects import _files

    sr, bl = 48000, 1024
    _files.write_midi(tmp_path / "p.mid", [(0.5, 0.25, 60, 100)])
    times = np.linspace(0.0, 3.0, K).astype(np.float32)
    _files.write_wavetable(tmp_path / "t.wt", times,
                           np.zeros((K, 64), np.float32))
    spec = {"sr": sr, "bl": bl, "length_s": 2.0, "render_sr": sr,
            "midi": {"p": "p.mid"}, "tables": {"t": "t.wt"},
            "vertices": [{"name": "s", "kind": "sampsyn", "floww": "p",
                          "conf": [0.01, 0.1, 0.8, 1.0, 0.5, 0.2],
                          "table": "t"}]}
    flops, nbytes = work_poly.sampsyn_work(spec, tmp_path)
    frames = 12000 + 9600            # held 0.25 s, released 0.2 s
    lo, hi = 24000, 24000 + frames
    blocks = (hi - 1) // bl - lo // bl + 1
    per = 18 + (10 if K > 1 else 0)
    assert flops == frames * per
    T = poly.song_frames(spec)
    assert nbytes == (K * 64 + K) * 4 + 6 * 4 + blocks * 3 * 4 + T * 2 * 4
