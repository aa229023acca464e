"""The port against the plain reference of a sampled-instrument session
(benchmark/reference/keys.py, the benchmark's own) on the CPU, at a tiny
size of the benchmark's layout (benchmark/projects/piano_session.py): two
tracks of 6 keys x 2 velocity layers, each track's 12 SampleMultis one
fused group, a 2 s song in windows of 40 blocks over three renders, so
that voices ring across windows and past the song's end into the next
render. Also termdaw's drum rule on same-frame on-events, the groups'
shared sample pool against per-group concatenations, a lone SampleMulti
on its own buffer, the group counters (`group_slots`, `group_voices`,
`group_pool_bytes`), each live bake's rise of them, the voice mix's
regimes at the session's and c4's sizes and the work model of the voice
mix's roofline (benchmark/harness/work_keys.py). Imports no JAX."""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.projects import piano_session as ps
from benchmark.reference import keys
from termdaw_tpu_torch import kernels
from termdaw_tpu_torch.engine import state as state_mod
from termdaw_tpu_torch.fileio.wav import read_wav
from termdaw_tpu_torch.graph import graph as G
from termdaw_tpu_torch.ops import mix, voices
from termdaw_tpu_torch.utils.fixtures import load_state, write_c4_project

ROOT = Path(__file__).resolve().parents[1]
FULL = float(2 ** 23 - 1)
WINDOW = 40      # blocks a window, so that a 2 s song renders in three

# the float32 signal path against float64, after the 24-bit truncation
# (1.2e-7 of full scale): each voice's float32 product of its sample and
# velocity, the slots' float32 sums, the tracks' gain and pan, the buses'
# sums and the Normalize's division
SOUND = 2e-6


def config(**over) -> dict:
    cfg = json.loads(
        (ROOT / "benchmark/configs/c10_piano16.json").read_text())
    cfg.update({
        "length_s": 2.0, "tracks": 2, "bus_tracks": 1, "keys": [57, 62],
        "sample_s": [0.9, 0.5],
        "left_hand": {"chords": 2, "notes": 2, "low": 57, "high": 59,
                      "spread_ticks": [2, 11], "hold_s": 0.9},
        "right_hand": {"notes": 6, "low": 60, "high": 62, "jitter_ms": 8.0,
                       "hold_s": 0.1}})
    cfg.update(over)
    return cfg


def session(d: Path, seed: int = 20261018, lone: bool = False) -> dict:
    """The tiny session in d; `lone`: also a SampleMulti of its own into
    the bus, on the first track's soft floww and the lowest key."""
    spec = ps.build(config(), seed, d)
    if lone:
        spec["vertices"].insert(-1, {"name": "lone", "kind": "sample_multi",
                                     "sample": "k57v0", "floww": "part0v0",
                                     "note": 57})
        spec["edges"].append(["lone", "bus0"])
        ps.write_project(spec, d)
    return spec


@pytest.fixture
def windows(monkeypatch):
    monkeypatch.setattr(state_mod, "RENDER_WINDOW_BLOCKS", WINDOW)
    torch.set_num_threads(1)


def _render(d: Path, renders: int):
    with contextlib.redirect_stdout(io.StringIO()):
        st = load_state(d, torch.device("cpu"))
        for _ in range(renders):
            st.render()
    return st


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape
    want = np.clip(want, -FULL - 1, FULL)
    return float(np.abs(got.astype(np.float64) - want).max() / FULL)


def test_port_matches_the_keys_reference(tmp_path, windows):
    """Three renders against the reference's third pass, the groups'
    voices ringing across window boundaries and into the next render;
    the reference in bfloat16 fails the same tolerance."""
    spec = session(tmp_path)
    st = _render(tmp_path, 3)
    cg = st.compiled
    assert sorted(len(m) for m in cg.fused_groups.values()) == [12, 12]
    got, info = read_wav(tmp_path / "outp.wav")
    assert (info.sample_rate, info.bits_per_sample) == (48000, 24)
    want = keys.bounce(spec, tmp_path, 3)
    assert np.abs(want).max() > 0.5 * FULL
    assert _gap(got, want) < SOUND
    low = keys.bounce(spec, tmp_path, 3, cast=keys.bf16)
    assert _gap(np.trunc(low), want) > SOUND
    # the hits of the first pass: some ring over a window's end, some
    # past the song's end into the second render
    F, bl = keys.song_frames(spec), int(spec["bl"])
    lens = {n: len(keys.load_sample(tmp_path / f, 48000))
            for n, f in spec["samples"].items()}
    ends = []
    for v in spec["vertices"]:
        if v["kind"] == "sample_multi":
            fr, _ = keys.hits(spec, tmp_path, 1)[v["name"]]
            ends += [(int(f), int(f) + lens[v["sample"]]) for f in fr]
    w = WINDOW * bl
    assert any(f // w < (e - 1) // w and e <= F for f, e in ends)
    assert any(f < F < e for f, e in ends)


def test_same_frame_on_events_only_the_first_triggers(tmp_path, windows,
                                                      monkeypatch):
    """Each chord note doubled two keys up at the same tick (the same
    floww): the drum rule passes over the second, in the port as in the
    reference."""
    part = ps.part

    def doubled(cfg, track, rng):
        out = []
        for tick, p, vel in part(cfg, track, rng):
            out.append((tick, p, vel))
            if p < cfg["right_hand"]["low"]:
                out.append((tick, p + 2, vel))
        return out

    monkeypatch.setattr(ps, "part", doubled)
    spec = session(tmp_path)
    struck = keys.hits(spec, tmp_path, 1)
    notes = 2 * len(part(config(), 0, np.random.default_rng(0)))
    assert sum(len(f) for f, _ in struck.values()) == notes
    st = _render(tmp_path, 2)
    got, _ = read_wav(tmp_path / "outp.wav")
    assert _gap(got, keys.bounce(spec, tmp_path, 2)) < SOUND
    assert st.compiled.group_voices > 0


def _group_tables(cg, fb, nb: int) -> dict:
    """The window's bake at the graph's time as tensors (the state and
    the floww cursor left as they are)."""
    bakes, _ = cg._bake_all(fb, cg.t, nb)
    return {k: {f: torch.from_numpy(a) for f, a in t.items()}
            for k, t in bakes.items()}


def test_groups_over_one_sample_set_read_one_pool(tmp_path, windows):
    """The two tracks' groups read one pool at the same base offsets,
    counted once in `group_pool_bytes`; each group's mix from it is bit
    for bit its mix from its own concatenation of its members' padded
    samples (the layout before pools were shared). The lone SampleMulti
    reads its sample's own padded buffer, and matches the reference."""
    spec = session(tmp_path, lone=True)
    st = _render(tmp_path, 1)
    cg = st.compiled
    bl = cg.bl
    pools = [k for k in cg.samples_padded if not isinstance(k, int)]
    assert len(pools) == 1
    pool = cg.samples_padded[pools[0]]
    layouts = [cg._fused_layout[c] for c in cg.fused_groups]
    assert all(lay == layouts[0] for lay in layouts)
    assert cg.group_pool_bytes == pool.numel() * 4
    assert pool.shape == (2, sum(len(cg.samples[p]) + 2 * bl + 256
                                 for p in pools[0][1]))
    lone = cg.graph.names.index("lone")
    assert lone not in cg._fused_members
    pos = cg.statics[lone].sample_pos
    assert cg.samples_padded[pos].shape == (2, len(cg.samples[pos])
                                            + 2 * bl + 256)
    own = {k for k in cg.samples_padded if isinstance(k, int)}
    assert own == {pos}
    got, _ = read_wav(tmp_path / "outp.wav")
    assert _gap(got, keys.bounce(spec, tmp_path, 1)) < SOUND
    # a window in the middle of the second render, voices carried in
    cg.set_time(WINDOW * bl)
    st.fb.set_time(WINDOW * bl)
    nb = WINDOW
    bakes = _group_tables(cg, st.fb, nb)
    for c, members in cg.fused_groups.items():
        tbl = bakes[f"fused{c}"]
        live = tbl["vel"] != 0
        assert live.any()
        got = cg._fused_mix(c, bakes, nb)
        poses = list(dict.fromkeys(cg.statics[m].sample_pos
                                   for m in members))
        cat = torch.cat([voices.make_padded_sample(cg.samples[p], bl)
                         for p in poses], dim=1)
        base = np.cumsum([0] + [len(cg.samples[p]) + 2 * bl + 256
                                for p in poses[:-1]])
        pool_base = cg._fused_layout[c][1]
        shift = torch.tensor([int(base[poses.index(cg.statics[m].sample_pos)])
                              - pool_base[cg.statics[m].sample_pos]
                              for m in members], dtype=torch.int32)
        begins = torch.where(live, tbl["begins"] + shift[tbl["member"].long()],
                             tbl["begins"])
        ids = cg._fused_ids[c]
        amp = mix.post_amps(cg._angles[ids], cg._gains[ids])
        member = tbl["member"].long()
        want = voices.voice_mix_stereo(
            cat, begins.contiguous(), tbl["vel"] * amp[member, 0],
            tbl["vel"] * amp[member, 1], nb, bl)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _fill(floats: torch.Tensor, layout) -> tuple[int, int]:
    """(slots, voices) of the fused groups' `vel` tables in a packed
    window."""
    slots = voices_ = 0
    for vkey, field, _kind, off, shape in layout:
        if vkey.startswith("fused") and field == "vel":
            a = floats[off:off + int(np.prod(shape))].numpy()
            slots += a.size
            voices_ += int(np.count_nonzero(a))
    return slots, voices_


def test_group_counters_count_the_packed_tables(tmp_path):
    """One window a render: render 1 is served from the seeded chain,
    render 2 bakes live and is recorded, render 3 is served from that
    recording: the counters
    rise by each window's count of its packed group tables; the live
    bake raises them by its own window's slots and voices, over the
    session's two groups of 12 members each."""
    session(tmp_path)
    torch.set_num_threads(1)
    with contextlib.redirect_stdout(io.StringIO()):
        st = load_state(tmp_path, torch.device("cpu"))
        cg = st.compiled
        assert (cg.group_slots, cg.group_voices) == (0, 0)
        st.render()
        seeded = [_fill(w[1], w[2]) for w in cg._prebaked["wins"]]
        assert cg.served_windows == len(seeded) == 1
        assert cg.live_bakes == 0
        assert (cg.group_slots, cg.group_voices) == tuple(
            np.sum(seeded, axis=0))
        before = (cg.group_slots, cg.group_voices)
        st.render()
        rise = (cg.group_slots - before[0], cg.group_voices - before[1])
        st.render()
    live = [_fill(w[1], w[2]) for w in cg._recorded[-1]["wins"]]
    assert cg.live_bakes == len(live) == 1
    assert rise == tuple(np.sum(live, axis=0))
    assert (len(cg.fused_groups), len(cg._fused_members)) == (2, 24)
    want = np.sum(seeded, axis=0) + 2 * np.sum(live, axis=0)
    assert (cg.group_slots, cg.group_voices) == tuple(want)
    assert 0 < cg.group_voices < cg.group_slots
    assert (cg.note_slots, cg.note_voices) == (0, 0)


def test_no_group_no_pool(tmp_path):
    """c4's one SampleMulti, a snare feeding the mix alone, reads its own
    padded buffer: no pool, no group counts, and a buffer the voice mix
    keeps in shared memory."""
    write_c4_project(tmp_path, 4.0, 48000, 1024)
    with contextlib.redirect_stdout(io.StringIO()):
        cg = load_state(tmp_path, torch.device("cpu")).compiled
    multis = [vi for vi in cg.order if cg.statics[vi].kind == G.SAMPLEMULTI]
    assert len(multis) == 1 and not cg.fused_groups
    assert cg.group_pool_bytes == 0
    assert (cg.group_slots, cg.group_voices) == (0, 0)
    (pos,) = cg.samples_padded
    lpad = cg.samples_padded[pos].shape[1]
    assert kernels.voice_mix_plan(lpad, 375, 1024).resident


def test_the_session_pool_streams():
    """The full session's pool, 176 samples of 4-16 s, is over the
    resident budget by three orders: the voice mix streams it."""
    cfg = json.loads(
        (ROOT / "benchmark/configs/c10_piano16.json").read_text())
    lo, hi = cfg["keys"]
    frames = sum(round(ps.sample_s(cfg, k) * 48000) + 2 * 1024 + 256
                 for k in range(lo, hi + 1)) * int(cfg["velocity_layers"])
    assert 84e6 < frames < 2 ** 31
    plan = kernels.voice_mix_plan(frames, 375, 1024)
    assert not plan.resident and plan.smem == 0


def test_work_keys_counts_sounding_voice_frames(tmp_path):
    """The voice mix work model: each hit's frames inside the second of
    two renders (one rings in from the first) for the operations and the
    table entries of its blocks; each sounded frame of a sample read
    once, however many voices sound it; one [T, 2] mix a group."""
    from benchmark.harness import work_keys
    from benchmark.projects import _files

    sr, bl = 48000, 1024
    _files.write_midi(tmp_path / "p.mid", [(0.5, 0.1, 60, 100),
                                           (0.6, 0.1, 60, 100),
                                           (1.9, 0.1, 61, 100)])
    spec = {"sr": sr, "bl": bl, "length_s": 2.0, "render_sr": sr,
            "midi": {"p": "p.mid"}, "samples": {"a": "a.wav", "b": "b.wav"},
            "vertices": [{"name": "x", "kind": "sample_multi", "sample": "a",
                          "floww": "p", "note": 60},
                         {"name": "y", "kind": "sample_multi", "sample": "b",
                          "floww": "p", "note": 61},
                         {"name": "s", "kind": "sum"}],
            "edges": [["x", "s"], ["y", "s"]]}
    flops, nbytes = work_keys.voicemix_work(spec, tmp_path,
                                            {"a": 12000, "b": 30000})
    F = keys.song_frames(spec)
    a0, a1, b0 = (int(np.float32(t) * np.float32(sr))
                  for t in (0.5, 0.6, 1.9))
    spans = [(F + a0, F + a0 + 12000), (F + a1, F + a1 + 12000),
             (F, b0 + 30000), (F + b0, 2 * F)]
    frames = sum(hi - lo for lo, hi in spans)
    blocks = sum((hi - 1) // bl - lo // bl + 1 for lo, hi in spans)
    touched = 12000 + 30000      # each of a's and b's frames once
    assert frames > touched
    assert flops == 4.0 * frames
    assert nbytes == 8.0 * touched + 12.0 * blocks + F * 2 * 4
