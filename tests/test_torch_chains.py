"""The port's bake-table machinery beyond the live bake, on the CPU:

* TERMDAW_VOICE_CAP: the reference's cases (tests/test_bake_caps.py:
  201-263) on a lone SampleMulti, a fused SampleMulti group and the note
  bakes, with the port's tables equal to the reference's;
* the prebaked and recorded chains (seed_caps pass 2, render_window's
  serve/record branch, release at refresh): the reference's cases
  (tests/test_bake_caps.py:443-835) held to the port, a served render
  bit-identical to a live one, the byte budget never exceeded;
* TERMDAW_PROFILE: a render writes a torch.profiler trace into the dir.

The reference renders with TERMDAW_PALLAS_INTERPRET=1 (its fused bake
layout, the one the port copies) and TERMDAW_MESH=0."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from termdaw_tpu.config import Config
from termdaw_tpu.engine.state import State as RefState
from termdaw_tpu.fileio.packets import PacketDecoder as RefPacketDecoder

from termdaw_tpu_torch.engine.state import render_chunk_blocks
from termdaw_tpu_torch.fileio.midi import write_midi
from termdaw_tpu_torch.fileio.packets import PacketDecoder, encode_events
from termdaw_tpu_torch.fileio.wavetable import WaveTable, write_wavetable
from termdaw_tpu_torch.graph import compile as C
from termdaw_tpu_torch.utils import prof
from termdaw_tpu_torch.utils.fixtures import drum, load_state

from .conftest import scrubbed_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SR, BL = 8000, 256


def _toml(d: Path) -> None:
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = {BL}\n'
        f"project_samplerate = {SR}\n")


def _bursty_project(d: Path, n_tracks=6, length_sec=4.0, seed=0,
                    notes=False) -> bytes:
    """The reference's _make_state project (test_bake_caps.py:99-146):
    n_tracks streamed SampleMulti tracks whose events land in one random
    half-second each -> Normalize; `notes` adds a Synth and a DebugSine
    over one dense chord of 8 overlapping notes. Returns the packets."""
    d.mkdir(parents=True, exist_ok=True)
    drum(d / "hit.wav", SR, 0.05, 300.0, 30.0)
    lines = [f"set_length({length_sec});", f"set_render_samplerate({SR});",
             "set_render_bitdepth(16);", f'set_output_file("{d}/outp.wav");',
             f'load_sample("hit", "{d}/hit.wav", "");',
             'add_normalize("sum", 1.0, 0.0);']
    for i in range(n_tracks):
        lines += [f'declare_stream("s{i}");',
                  f'add_sample_multi("t{i}", 1.0, 0.0, "hit", "s{i}", -1);',
                  f'connect("t{i}", "sum");']
    if notes:
        chord = ", ".join(f"{{{0.5 + 0.01 * k}, {48 + k}, 0.8}}"
                          for k in range(8))
        offs = ", ".join(f"{{{1.5 + 0.01 * k}, {48 + k}, 0.0}}"
                         for k in range(8))
        lines += [f'declare_floww("chord", {{ {chord}, {offs} }});',
                  'add_synth("syn", 0.3, 0.0, "chord", 0.4, 0.3, '
                  '{0.01, 0.1, 0.8, 0.5, 0.2, 0.5}, 0.0, 0.0, {}, 0.0, {});',
                  'add_debug_sine("sine", 0.2, 0.0, "chord");',
                  'connect("syn", "sum");', 'connect("sine", "sum");']
    lines.append('set_output("sum");')
    (d / "project.lua").write_text("\n".join(lines))
    _toml(d)
    rng = np.random.default_rng(seed)
    blob = b""
    for i in range(n_tracks):
        t0 = rng.uniform(0.0, length_sec - 0.6)
        times = np.sort(rng.uniform(t0, t0 + 0.5, size=12)).astype(np.float32)
        ev = np.stack([np.zeros(12, np.float32), times,
                       np.full(12, 36.0, np.float32),
                       rng.uniform(0.4, 1.0, 12).astype(np.float32)], axis=1)
        blob += encode_events(f"s{i}", ev)
    return blob


def _ref_state(d, monkeypatch, packets=b""):
    monkeypatch.setenv("TERMDAW_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TERMDAW_MESH", "0")
    st = RefState(Config.read(Path(d) / "project.toml"), str(d))
    st.refresh()
    assert st.loaded
    if packets:
        st.fb.append_streams(RefPacketDecoder().feed(packets))
    return st


def _dense_events(st, n_per_track=10, burst_sec=0.04):
    """Every stream one dense burst, so each track's per-block polyphony
    far exceeds a cap of 2 (test_bake_caps.py:214-227)."""
    for name, i in st.fb.names.items():
        if not name.startswith("s"):
            continue
        times = (0.5 + np.linspace(0, burst_sec, n_per_track)).astype(
            np.float32)
        st.fb.flowws[i] = np.stack(
            [np.zeros(n_per_track, np.float32), times,
             np.full(n_per_track, 36.0, np.float32),
             np.full(n_per_track, 0.8, np.float32)], axis=1)
    st.fb.version += 1


def _first_window_tables(st, port: bool):
    cg = st.compiled
    st.fb.set_time(0)
    step = render_chunk_blocks(st.cs)
    cg.seed_caps(st.fb, st.cs, step)
    nb = min(st.cs, step)
    if port:
        bakes, _ = cg._bake_all(st.fb, 0, nb)
    else:
        bakes, _ = cg._bake_all(st.fb, 0, nb, fused=True)
    return {k: {f: np.asarray(a) for f, a in t.items()}
            for k, t in bakes.items()}


def _assert_tables_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k]), k
        for f in want[k]:
            np.testing.assert_array_equal(got[k][f], want[k][f],
                                          err_msg=f"{k}.{f}")


@pytest.mark.parametrize("cap", [None, "2"])
def test_voice_cap_steals_and_pins(tmp_path, monkeypatch, cap):
    """A lone SampleMulti, a Synth and a DebugSine (8 overlapping notes):
    under TERMDAW_VOICE_CAP=2 every voice table is at most 2 wide and the
    port's tables equal the reference's; without it they are wider. The
    mirror of tests/test_bake_caps.py::TestStableLayouts::
    test_voice_cap_steals_and_pins."""
    if cap:
        monkeypatch.setenv("TERMDAW_VOICE_CAP", cap)
    packets = _bursty_project(tmp_path / "p", n_tracks=1, notes=True)
    ref = _ref_state(tmp_path / "p", monkeypatch, packets)
    port = load_state(tmp_path / "p", CPU, packets)
    assert port.compiled.voice_cap == ref.compiled.voice_cap == (
        int(cap) if cap else None)
    assert not port.compiled.fused_groups
    got = _first_window_tables(port, True)
    _assert_tables_equal(got, _first_window_tables(ref, False))
    widths = [t["idx"].shape[1] for t in got.values() if "idx" in t]
    assert len(widths) == 3
    if cap:
        assert max(widths) <= 2
        assert all(c["p"] <= 2 for c in port.compiled.bake_caps.values()
                   if "p" in c)
    else:
        assert max(widths) >= 8


def _fused_member_counts(tables) -> int:
    """Max live-voice count over (block, member) cells of the fused
    tables (test_bake_caps.py:229-251)."""
    worst = 0
    for k, t in tables.items():
        if not k.startswith("fused"):
            continue
        live = t["begins"] > 0
        for kb in range(t["begins"].shape[0]):
            for m in np.unique(t["member"][kb][live[kb]]):
                worst = max(worst, int(np.sum(live[kb] &
                                              (t["member"][kb] == m))))
    return worst


@pytest.mark.parametrize("cap", [None, "2"])
def test_voice_cap_steals_on_fused_path(tmp_path, monkeypatch, cap):
    """The fused group's merged voice table is capped per member vertex
    with oldest-voice steal, as the reference's; uncapped, some (block,
    member) cell holds more than 2 voices. The mirror of
    tests/test_bake_caps.py::TestStableLayouts::
    test_voice_cap_steals_on_fused_path."""
    if cap:
        monkeypatch.setenv("TERMDAW_VOICE_CAP", cap)
    packets = _bursty_project(tmp_path / "p")
    ref = _ref_state(tmp_path / "p", monkeypatch, packets)
    port = load_state(tmp_path / "p", CPU, packets)
    _dense_events(ref)
    _dense_events(port)
    assert port.compiled.fused_groups == ref.compiled.fused_groups
    got = _first_window_tables(port, True)
    _assert_tables_equal(got, _first_window_tables(ref, False))
    if cap:
        assert _fused_member_counts(got) == 2
    else:
        assert _fused_member_counts(got) > 2


def test_voice_cap_render_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("TERMDAW_VOICE_CAP", "2")
    packets = _bursty_project(tmp_path / "p", notes=True)
    ref = _ref_state(tmp_path / "p", monkeypatch, packets)
    port = load_state(tmp_path / "p", CPU, packets)
    _dense_events(ref)
    _dense_events(port)
    ref.render()
    want = (tmp_path / "p" / "outp.wav").read_bytes()
    port.render()
    got = np.frombuffer((tmp_path / "p" / "outp.wav").read_bytes()[44:],
                        "<i2").astype(np.int64)
    assert np.abs(got - np.frombuffer(want[44:], "<i2")).max() <= 1


# -- the chains -------------------------------------------------------------

def _state(tmp_path, sub="proj", **kw):
    packets = _bursty_project(tmp_path / sub, **kw)
    st = load_state(tmp_path / sub, CPU, packets)
    return st


def _render_np(st):
    """render_device from the graph time, then back to 0; checks the
    byte budget after the render."""
    cg = st.compiled
    st.fb.set_time(cg.get_time())
    chunks = st.render_device()
    out = torch.cat(chunks).numpy()
    cg.set_time(0)
    assert 0 <= cg._prebake_used <= cg._prebake_budget
    return out


def _count_bakes(cg):
    calls = {"n": 0}
    orig = cg._bake_all

    def wrapped(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    cg._bake_all = wrapped
    return calls


def test_repeat_render_serves_prebaked_bit_identically(tmp_path):
    # 20 s at 8 kHz / 256 = 625 blocks: two windows (512 + 113), the
    # second exercising the chain's lineage
    st = _state(tmp_path, length_sec=20.0)
    r1 = _render_np(st)
    cg = st.compiled
    assert cg.served_windows == 2 and cg.live_bakes == 0
    calls = _count_bakes(cg)
    cg.reset_normalize_vertices()
    r2 = _render_np(st)
    assert calls["n"] == 0, "the second render must not bake"
    assert np.array_equal(r1, r2)
    assert len(cg._prebaked["index"]) == 2
    # the chain holds the two uploaded buffers per window, counted
    ints, floats = cg._prebaked["wins"][0][:2]
    assert ints.dtype == torch.int32 and floats.dtype == torch.float32
    assert cg._prebake_used == cg._prebaked["bytes"] > 0


def test_prebake_off_is_bit_identical(tmp_path, monkeypatch):
    st = _state(tmp_path, seed=3)
    on1, on2 = _render_np(st), _render_np(st)
    monkeypatch.setenv("TERMDAW_PREBAKE", "0")
    st2 = _state(tmp_path, "off", seed=3)
    assert st2.compiled._prebake_on is False
    off1, off2 = _render_np(st2), _render_np(st2)
    assert st2.compiled._prebaked is None and st2.compiled.served_windows == 0
    assert np.array_equal(on1, off1) and np.array_equal(on2, off2)


def _feed(st, stream="s0", ev=((0.0, 1.2, 36.0, 0.9), (0.0, 2.1, 36.0, 0.7))):
    st.fb.append_streams(PacketDecoder().feed(
        encode_events(stream, np.asarray(ev, np.float32))))


def test_feed_invalidates_and_matches_live(tmp_path, monkeypatch):
    st = _state(tmp_path, seed=5)
    base = _render_np(st)
    _feed(st)  # a version bump: the stale chain must not serve
    fed = _render_np(st)
    assert not np.array_equal(base, fed), "new events must be audible"
    monkeypatch.setenv("TERMDAW_PREBAKE", "0")
    st2 = _state(tmp_path, "off", seed=5)
    base2 = _render_np(st2)
    _feed(st2)
    assert np.array_equal(base, base2)
    assert np.array_equal(fed, _render_np(st2))


def test_seek_breaks_chain_and_matches_live(tmp_path, monkeypatch):
    st = _state(tmp_path, seed=7)
    _render_np(st)
    st.compiled.set_time(4 * BL)
    st.fb.set_time(4 * BL)
    calls = _count_bakes(st.compiled)
    w1 = st.compiled.render_window(st.fb, 2).numpy()
    assert calls["n"] == 1, "an off-grid window must bake live"
    monkeypatch.setenv("TERMDAW_PREBAKE", "0")
    st2 = _state(tmp_path, "off", seed=7)
    _render_np(st2)
    st2.compiled.set_time(4 * BL)
    st2.fb.set_time(4 * BL)
    assert np.array_equal(w1, st2.compiled.render_window(st2.fb, 2).numpy())


def test_budget_bounds_chain_with_live_tail(tmp_path, monkeypatch):
    """A window whose bytes do not fit TERMDAW_PREBAKE_MB is not kept: the
    chain ends before it and the rest bakes live, bit-identical to a
    render with no chain."""
    monkeypatch.setenv("TERMDAW_PREBAKE_MB", "0.000001")
    st = _state(tmp_path, seed=9, length_sec=20.0)
    r1 = _render_np(st)
    assert st.compiled._prebaked["wins"] == []
    assert st.compiled._prebake_used == 0
    monkeypatch.setenv("TERMDAW_PREBAKE", "0")
    st2 = _state(tmp_path, "off", seed=9, length_sec=20.0)
    assert np.array_equal(r1, _render_np(st2))


def test_budget_edge_keeps_only_windows_that_fit(tmp_path, monkeypatch):
    """With a budget between one window's bytes and two windows', the
    chain keeps exactly one window and counts exactly its bytes (the
    reference keeps the window that crosses the budget too)."""
    st = _state(tmp_path, seed=9, length_sec=20.0)
    _render_np(st)
    sizes = [C._nbytes(*w[:2]) for w in st.compiled._prebaked["wins"]]
    assert len(sizes) == 2
    mb = (sizes[0] + sizes[1] - 1) / 1e6
    monkeypatch.setenv("TERMDAW_PREBAKE_MB", repr(mb))
    st2 = _state(tmp_path, "edge", seed=9, length_sec=20.0)
    r = _render_np(st2)
    cg = st2.compiled
    assert len(cg._prebaked["wins"]) == 1
    assert cg._prebake_used == cg._prebaked["bytes"] == sizes[0]
    assert cg._prebake_used <= cg._prebake_budget
    assert cg.served_windows == 1 and cg.live_bakes == 1
    monkeypatch.setenv("TERMDAW_PREBAKE", "0")
    st3 = _state(tmp_path, "off", seed=9, length_sec=20.0)
    assert np.array_equal(r, _render_np(st3))


def _lerp_project(d: Path) -> None:
    d.mkdir(parents=True)
    drum(d / "hit.wav", SR, 0.05, 300.0, 30.0)
    write_midi(d / "hits.mid", [(0.2, 0.1, 36, 100), (1.1, 0.1, 36, 90),
                                (2.3, 0.1, 36, 80)], bpm=120)
    (d / "project.lua").write_text(f"""
set_length(4.0);
set_render_samplerate({SR});
set_render_bitdepth(16);
set_output_file("{d}/o.wav");
load_sample("hit", "{d}/hit.wav", "");
load_midi_floww("hits", "{d}/hits.mid");
declare_stream("live");
add_sample_lerp("lerp", 1.0, 0.0, "hit", "hits", -1, 40);
add_sample_multi("m", 1.0, 0.0, "hit", "live", -1);
add_normalize("sum", 1.0, 0.0);
connect("lerp", "sum");
connect("m", "sum");
set_output("sum");
""")
    _toml(d)


def test_stateful_carries_serve_recorded_chain(tmp_path, monkeypatch):
    """A SampleLerp holding its last trigger misses the fresh-start seed
    chain but reaches a steady state: render 2 bakes live and is
    recorded, render 3 serves the recording, bit-identically; a live
    ground truth gives the same three renders."""
    _lerp_project(tmp_path / "lerp")
    st = load_state(tmp_path / "lerp", CPU)
    r1 = _render_np(st)                 # the seed chain serves
    st.compiled.reset_normalize_vertices()
    r2 = _render_np(st)                 # live, recorded
    assert st.compiled._recorded, "render 2 must have been recorded"
    calls = _count_bakes(st.compiled)
    st.compiled.reset_normalize_vertices()
    r3 = _render_np(st)                 # served from the recording
    assert calls["n"] == 0, "the steady-state render must not bake"
    assert np.array_equal(r2, r3)
    monkeypatch.setenv("TERMDAW_PREBAKE", "0")
    _lerp_project(tmp_path / "off")
    st2 = load_state(tmp_path / "off", CPU)
    g = []
    for _ in range(3):
        g.append(_render_np(st2))
        st2.compiled.reset_normalize_vertices()
    assert np.array_equal(r1, g[0]) and np.array_equal(r2, g[1])
    assert np.array_equal(r3, g[2])


def test_seek_after_served_render_keeps_chain_intact(tmp_path, monkeypatch):
    """A seek right after a served render rebinds the SampSyn carry it
    remaps, so the chain's stored objects stay as they were, and later
    renders match a live ground truth (test_bake_caps.py:601-686)."""
    def build(sub):
        d = tmp_path / sub
        d.mkdir()
        write_midi(d / "m.mid", [(0.1, 9.0, 60, 100)], bpm=120)
        write_wavetable(d / "t.wt", WaveTable.default())
        (d / "project.lua").write_text(f"""
set_length(4.0);
set_render_samplerate({SR});
set_render_bitdepth(16);
set_output_file("{d}/o.wav");
load_midi_floww("m", "{d}/m.mid");
load_resource("tbl", "{d}/t.wt");
add_sampsyn("syn", 0.8, 0.0, "m", {{0.01, 0.1, 0.8, 5.0, 0.2, 0.5}}, "tbl");
add_normalize("sum", 1.0, 0.0);
connect("syn", "sum");
set_output("sum");
""")
        _toml(d)
        return load_state(d, CPU)

    st = build("syn")
    st.fb.set_time(0)
    r1 = torch.cat(st.render_device()).numpy()
    pb = st.compiled._prebaked
    stored = [c for w in pb["wins"] for c in w[3].values()
              if getattr(c, "notes", None)]
    assert any(any(c is lv for lv in st.compiled.carries.values())
               for c in stored), "the served delta aliases stored carries"
    snap = [(n.on_f, n.off_f, n.dead_f, n.env_t, n.rel_t)
            for c in stored for n in c.notes]
    st.compiled.set_time(0)
    st.fb.set_time(0)
    assert snap == [(n.on_f, n.off_f, n.dead_f, n.env_t, n.rel_t)
                    for c in stored for n in c.notes]
    r2 = _render_np(st)
    monkeypatch.setenv("TERMDAW_PREBAKE", "0")
    st2 = build("syn_live")
    assert np.array_equal(r1, _render_np(st2))
    assert np.array_equal(r2, _render_np(st2))


def test_unfresh_index_matches_brute_force(tmp_path):
    """The incremental _unfresh index equals a from-scratch scan after a
    refresh, served and live renders, a seek, an off-grid window and a
    feed."""
    def brute(cg):
        return {vi for vi, c in cg.carries.items()
                if C._FRESH_CARRIES.get(cg.statics[vi].kind) != c}

    _lerp_project(tmp_path / "inv")
    st = load_state(tmp_path / "inv", CPU)
    cg = st.compiled
    seen = []
    for step in ("refresh", "render 1", "render 2", "seek", "window",
                 "feed"):
        if step.startswith("render"):
            _render_np(st)
        elif step == "seek":
            cg.set_time(5 * BL)
            st.fb.set_time(5 * BL)
        elif step == "window":
            cg.render_window(st.fb, 3)
        elif step == "feed":
            _feed(st, "live", ((0.0, 3.2, 36.0, 0.9),))
            cg.set_time(0)
            _render_np(st)
        assert cg._unfresh == brute(cg), step
        seen.append(bool(cg._unfresh))
    assert any(seen) and not all(seen)


def test_feed_purges_stale_recorded_chains(tmp_path):
    _lerp_project(tmp_path / "purge")
    st = load_state(tmp_path / "purge", CPU)
    cg = st.compiled
    _render_np(st)   # the seed chain serves (fresh)
    _render_np(st)   # stateful lerp: live and recorded
    assert cg._recorded and cg._prebake_used > 0
    v1 = {r["bank"] for r in cg._recorded}
    _feed(st, "live", ((0.0, 1.5, 36.0, 0.7),))
    _render_np(st)
    now = {r["bank"] for r in cg._recorded}
    assert now and not (v1 & now), "stale-bank chains must be purged"
    assert cg._prebake_used == (cg._prebaked["bytes"] + sum(
        r["bytes"] for r in cg._recorded))


def test_refresh_releases_replaced_graphs_chains(tmp_path):
    st = _state(tmp_path, seed=21)
    _render_np(st)
    old = st.compiled
    assert old._prebaked is not None and old._prebake_used > 0
    st.refresh()
    assert st.loaded and st.compiled is not old
    assert old._prebaked is None and not old._recorded
    assert old._prebake_used == 0


def test_caps_stay_sticky_across_a_refresh(tmp_path):
    """A refresh that keeps a vertex starts from its caps (cap_scope is
    the project dir), so the rebuilt graph's first window has the same
    layout before any seed."""
    st = _state(tmp_path, seed=2)
    _render_np(st)
    caps = {k: dict(v) for k, v in st.compiled.bake_caps.items()}
    assert caps
    st.refresh()
    assert st.compiled.cap_scope == str(tmp_path / "proj")
    assert st.compiled.bake_caps == caps


# -- TERMDAW_PROFILE ---------------------------------------------------------

def test_profile_dir_gets_a_trace_of_each_render(tmp_path):
    """TERMDAW_PROFILE is read at import: a CPU render in a process started
    with it writes one Chrome trace a render, named after the span."""
    _bursty_project(tmp_path / "p", n_tracks=2, length_sec=1.0)
    out = tmp_path / "traces"
    script = f"""
import torch
from termdaw_tpu_torch.utils.fixtures import load_state
st = load_state({str(tmp_path / 'p')!r}, torch.device('cpu'))
st.render()
st.render()
"""
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=240,
        env=scrubbed_env(TERMDAW_SINK="null", TERMDAW_PROFILE=str(out)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    traces = sorted(out.glob("render-*.json"))
    assert len(traces) == 2
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert events and any(e.get("ph") == "X" for e in events)


def test_no_profile_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(prof, "PROFILE_DIR", "")
    monkeypatch.chdir(tmp_path)
    st = _state(tmp_path, n_tracks=2, length_sec=1.0)
    before = sorted(p for p in tmp_path.rglob("*"))
    st.render()
    after = sorted(p for p in tmp_path.rglob("*"))
    # the WAV and nothing else
    assert [p for p in after if p not in before] == [
        tmp_path / "proj" / "outp.wav"]
