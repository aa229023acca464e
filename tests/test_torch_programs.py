"""The port's window-program cache on the CPU (graph/compile.py
`_PROGRAM_CACHE`, `_get_fn`, `_WindowProgram`), where an entry runs the
eager program over its static input buffers:

* the reference's cache cases (tests/test_bake_caps.py:315-408: a bounded
  LRU, eviction, evicted entries releasing their graph) and
  TERMDAW_PROGRAM_CACHE read the reference's way;
* a stream feed mints no program (tests/test_events.py:311-339), nor does
  a repeat render (tests/test_workflows.py:238-240);
* c3 and c4 cuts rendered window by window through the cache against the
  JAX reference's windows (seeks, a normalize scan and apply, a
  PluginHost change, served and live windows, t0 != 0);
* the numeric state's tensors keep their storage through windows, seeks,
  resets and a hand-over from the reference.

The reference renders with TERMDAW_PALLAS_INTERPRET=1 and
TERMDAW_MESH=0 (tests/test_torch_engine.py)."""

import gc
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from termdaw_tpu.config import Config
from termdaw_tpu.engine.state import State as RefState

from termdaw_tpu_torch.fileio.packets import PacketDecoder, encode_events
from termdaw_tpu_torch.graph import compile as C
from termdaw_tpu_torch.ops import filters, fx, sampler
from termdaw_tpu_torch.utils.fixtures import (
    drum, load_state, write_c1_project, write_c3_project, write_c4_project,
    write_c5_project,
)

from .conftest import scrubbed_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SR, BL = 8000, 256


def _ref_state(d, monkeypatch):
    monkeypatch.setenv("TERMDAW_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TERMDAW_MESH", "0")
    st = RefState(Config.read(Path(d) / "project.toml"), str(d))
    st.refresh()
    assert st.loaded
    return st


def _window(st, nb, is_scan=False):
    st.fb.set_time(st.compiled.get_time())
    audio = st.compiled.render_window(st.fb, nb, is_scan=is_scan)
    st.fb.advance_blocks(nb)
    return np.asarray(audio)


# -- the reference's cache cases ---------------------------------------------

def test_bounded_lru_eviction(monkeypatch):
    """tests/test_bake_caps.py:315-330 on the port's cache."""
    monkeypatch.setattr(C, "_PROGRAM_CACHE", {})
    monkeypatch.setattr(C, "_PROGRAM_CACHE_CAP", 3)
    for k in "abc":
        C._cache_put(k, k)
    assert C._cache_get("a") == "a"  # refreshes 'a' to most-recent
    C._cache_put("d", "d")           # evicts 'b', the oldest
    assert C._cache_get("b") is None
    assert C._cache_get("a") == "a"
    assert C._cache_get("d") == "d"


def _topology_project(d: Path, n: int) -> None:
    lines = ["set_length(0.5);", f"set_render_samplerate({SR});",
             f'set_output_file("{d}/o.wav");',
             f'load_sample("hit", "{d}/hit.wav", "");',
             'add_normalize("sum", 1.0, 0.0);']
    for i in range(n):
        lines += [f'add_sampleloop("t{i}", 1.0, 0.0, "hit");',
                  f'connect("t{i}", "sum");']
    lines.append('set_output("sum");')
    (d / "project.lua").write_text("\n".join(lines))


def test_evicted_programs_release_their_graph(tmp_path, monkeypatch):
    """tests/test_bake_caps.py:332-386: each entry pins its CompiledGraph
    (samples, state); once evicted, the old graphs are collectable."""
    monkeypatch.setattr(C, "_PROGRAM_CACHE", {})
    monkeypatch.setattr(C, "_PROGRAM_CACHE_CAP", 2)
    d = tmp_path / "p"
    d.mkdir()
    drum(d / "hit.wav", SR, 0.05, 300.0, 30.0)
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = {BL}\n'
        f"project_samplerate = {SR}\n")
    refs = []
    for n in range(2, 7):  # 5 distinct topologies
        _topology_project(d, n)
        st = load_state(d, CPU)
        st.render()
        assert st.compiled.captures == st.compiled.replays == 1
        refs.append(weakref.ref(st.compiled))
        del st
    assert len(C._PROGRAM_CACHE) <= 2
    for _ in range(3):
        gc.collect()
    dead = sum(1 for r in refs[:-1] if r() is None)
    assert dead >= len(refs) - 2, f"only {dead} old graphs released"


def test_program_cache_is_safe_under_threads(monkeypatch):
    """Graphs render from several threads: the cache's LRU get and put, a
    graph's listing and its drops hold the cache's lock, so no thread's
    get meets a key another evicted between its read and its move, and
    no listing sees the dict change size (both raised without it)."""
    import threading

    monkeypatch.setattr(C, "_PROGRAM_CACHE", {})
    monkeypatch.setattr(C, "_PROGRAM_CACHE_CAP", 8)

    class Entry:
        def __init__(self, cg):
            self.cg = cg

    graphs = [object() for _ in range(4)]
    errors = []
    barrier = threading.Barrier(16)

    def work(i):
        try:
            barrier.wait()
            g = graphs[i % 4]
            for n in range(3000):
                key = (i, n % 12)
                if C._cache_get(key) is None:
                    C._cache_put(key, Entry(g))
                C._cache_get((i ^ 1, n % 12))
                assert all(p.cg is g for p in C.CompiledGraph.programs(g))
                if n % 50 == 0:
                    C.CompiledGraph._drop_programs(g, lambda k: k[1] == 0)
        except Exception as e:  # reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(C._PROGRAM_CACHE) <= 8


def test_refresh_drops_the_replaced_graphs_programs(tmp_path):
    """The port's deviation: programs never outlive their CompiledGraph.
    A refresh (release_chains) drops the old graph's entries even with
    the topology unchanged, and the new graph makes its own."""
    write_c1_project(tmp_path, 1.0, SR, BL, render_sr=4000)
    st = load_state(tmp_path, CPU)
    st.render()
    old = st.compiled
    assert old.programs() and all(p.cg is old for p in old.programs())
    st.refresh()
    assert st.loaded and st.compiled is not old
    assert old.programs() == []
    assert st.compiled.serial != old.serial  # it leads each key
    st.render()
    assert len(st.compiled.programs()) == st.compiled.captures == 1


def test_a_dropped_program_is_freed_without_the_collector(tmp_path):
    """A program holds no reference to itself: dropped from the cache (at
    a refresh, or evicted) it is freed at once, never by a later cyclic
    collection, which on the card could run inside another program's
    capture and void it (a CUDAGraph freed mid-capture)."""
    write_c1_project(tmp_path, 1.0, SR, BL, render_sr=4000)
    st = load_state(tmp_path, CPU)
    st.render()
    refs = [weakref.ref(p) for p in st.compiled.programs()]
    assert refs
    gc.disable()
    try:
        st.compiled.release_chains()
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("env,cap", [("", 128), ("3", 8), ("200", 200)])
def test_program_cache_env_read_the_reference_way(env, cap):
    """TERMDAW_PROGRAM_CACHE: max(8, int(env or 128)), read at import."""
    proc = subprocess.run(
        [sys.executable, "-c", "from termdaw_tpu_torch.graph import compile"
         " as C; print(C._PROGRAM_CACHE_CAP)"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=scrubbed_env(TERMDAW_PROGRAM_CACHE=env))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == cap


# -- no new program for a feed or a repeat render ----------------------------

def _stream_project(d: Path, n_tracks=4):
    """tests/test_events.py:269-297's project for the port."""
    drum(d / "hit.wav", SR, 0.05, 300.0, 30.0)
    lines = ["set_length(2.0);", f"set_render_samplerate({SR});",
             'set_output_file("mix.wav");',
             f'load_sample("hit", "{d}/hit.wav", "");',
             'add_normalize("sum", 1.0, 0.0);']
    for i in range(n_tracks):
        lines += [f'declare_stream("s{i}");',
                  f'add_sample_multi("t{i}", 1.0, 0.0, "hit", "s{i}", -1);',
                  f'connect("t{i}", "sum");']
    lines.append('set_output("sum");')
    (d / "project.lua").write_text("\n".join(lines))
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = {BL}\n'
        f"project_samplerate = {SR}\n")
    return load_state(d, CPU)


def test_feed_reaches_next_window_without_a_new_program(tmp_path):
    """tests/test_events.py:299-339: a fed event lands frame-exact in a
    later 1-block window, and the feed mints no program."""
    st = _stream_project(tmp_path)
    cg = st.compiled
    cg.seed_caps(st.fb, st.cs, 4)
    silent = np.asarray(cg.render_window(st.fb, 1))
    st.fb.advance_blocks(1)
    assert np.max(np.abs(silent)) == 0.0
    keys_before = set(C._PROGRAM_CACHE)
    t_now = cg.get_time()
    ev = np.array([[0.0, (t_now + BL + 16) / SR, 36.0, 0.9]], np.float32)
    st.fb.trim_streams()
    assert st.fb.append_streams(
        PacketDecoder().feed(encode_events("s1", ev))) == []
    st.fb.set_time(t_now)
    quiet = np.asarray(cg.render_window(st.fb, 1))
    st.fb.advance_blocks(1)
    assert np.max(np.abs(quiet)) == 0.0
    hit = np.asarray(cg.render_window(st.fb, 1))
    st.fb.advance_blocks(1)
    assert np.max(np.abs(hit)) > 0.01, "fed event missed its window"
    assert np.max(np.abs(hit[:8])) == 0.0
    assert np.max(np.abs(hit[14:64])) > 0.0
    assert set(C._PROGRAM_CACHE) == keys_before
    assert cg.captures == 1 and cg.replays == 3


@pytest.mark.parametrize("cfg", ["c1", "c5"])
def test_repeat_render_mints_no_program(tmp_path, cfg):
    """tests/test_workflows.py:238-240: rendering again what was rendered
    replays the programs already made."""
    if cfg == "c1":
        write_c1_project(tmp_path, 2.0, SR, BL, render_sr=4000)
        packets = b""
    else:
        packets = write_c5_project(tmp_path, 2.0, SR, BL, n_tracks=4,
                                   hit_sr=16000, bd=16)
    st = load_state(tmp_path, CPU, packets)
    st.render()
    keys, captures = set(C._PROGRAM_CACHE), st.compiled.captures
    st.render()
    st.render()
    assert set(C._PROGRAM_CACHE) == keys
    assert st.compiled.captures == captures
    assert st.compiled.replays == 3 * -(-st.cs // 512)


def test_time_table_sized_at_seed_caps(tmp_path):
    """The time table covers the whole render from its first window
    (reference test_bake_caps.py:270-292), so every window of a render
    replays one program; a window past it grows the table, which is part
    of the key, captures anew and drops the program keyed to the shorter
    table."""
    write_c3_project(tmp_path, 2.0, SR, BL)
    st = load_state(tmp_path, CPU)
    cg = st.compiled
    st.render()
    assert cg._ttab_min_frames == st.cs * cg.bl
    n = cg._ttab.shape[0]
    assert n >= st.cs * cg.bl
    (key,) = [k for k, p in C._PROGRAM_CACHE.items() if p.cg is cg]
    assert key[-1] == n and cg.captures == 1
    cg.set_time(n - 2 * BL)  # the next 4-block window reaches past it
    st.fb.set_time(cg.get_time())
    _window(st, 4)
    assert cg._ttab.shape[0] == 2 * n and cg.captures == 2
    (key,) = [k for k, p in C._PROGRAM_CACHE.items() if p.cg is cg]
    assert key[1] == 4 and key[-1] == 2 * n


def test_eager_window_runs_outside_the_cache(tmp_path):
    """render_window(..., eager=True) runs the eager program on the same
    inputs: the same audio and state as a cached program's window, and
    no program made or run."""
    write_c3_project(tmp_path, 2.0, SR, BL)
    got = {}
    for eager in (True, False):
        st = load_state(tmp_path, CPU)
        cg = st.compiled
        cg.seed_caps(st.fb, st.cs, 16)
        st.fb.set_time(0)
        got[eager] = [np.asarray(cg.render_window(st.fb, 16, eager=eager))]
        got[eager] += [t.numpy() for k in sorted(cg.num_state)
                       for t in _leaves(cg.num_state[k])]
        assert (cg.captures, cg.replays) == ((0, 0) if eager else (1, 1))
        assert cg.served_windows == 1
    for a, b in zip(got[True], got[False]):
        np.testing.assert_array_equal(a, b)


# -- window by window against the reference ----------------------------------

NB = 16


@pytest.mark.parametrize("cfg", ["c3", "c4"])
def test_cached_windows_match_reference(tmp_path, monkeypatch, cfg):
    """Windows of 16 blocks through the cache against the reference's
    (atol 1e-5, c4's eq3 1e-4): two served from the chains seed_caps
    built, then after a seek (t0 != 0, live), after a PluginHost change
    (c4's compressor ratio), and, for c3, a normalize scan then apply.
    Every window is one program's run (replays == windows)."""
    write = {"c3": write_c3_project, "c4": lambda d, *a: write_c4_project(
        d, *a, render_sr=8000)}[cfg]
    write(tmp_path, 2.0, SR, BL)
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    atol = 1e-4 if cfg == "c4" else 1e-5
    both = (ref, port)
    for st in both:
        st.compiled.seed_caps(st.fb, st.cs, NB)
        st.fb.set_time(0)

    def windows(n, is_scan=False):
        for _ in range(n):
            want, got = (_window(st, NB, is_scan) for st in both)
            assert np.abs(want).max() > 0 or is_scan
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)

    windows(2)
    cg = port.compiled
    assert cg.served_windows == 2 and cg.live_bakes == 0
    for st in both:
        st.compiled.set_time(1000)
    windows(2)
    assert cg.live_bakes == 2 and cg.get_time() == 1000 + 2 * NB * BL
    if cfg == "c4":
        for st in both:
            st.host.set_value("comp", "ratio", 6.0)
        windows(1)
    else:
        for st in both:
            st.compiled.reset_scan_normalize_vertices()
            st.compiled.set_time(0)
        windows(2, is_scan=True)
        for st in both:
            st.compiled.apply_scan_normalize_vertices()
        ((_, want),) = ref.compiled.get_normalization_values()
        ((_, got),) = cg.get_normalization_values()
        assert got == pytest.approx(want, rel=1e-6)
        windows(1)
    assert cg.replays == cg.served_windows + cg.live_bakes
    assert cg.captures == len(cg.programs()) <= 3


# -- persistent state buffers -------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _ptrs(cg) -> dict:
    return {k: [t.data_ptr() for t in _leaves(v)]
            for k, v in cg.num_state.items()}


def test_state_tensors_keep_their_storage(tmp_path, monkeypatch):
    """Every num_state tensor is written in place by windows (live and
    served, scan and not), seeks, the Normalize resets, a scan's apply and
    a hand-over from the reference; `.max` never aliases `.scan_max`."""
    write_c3_project(tmp_path, 2.0, SR, BL)
    port = load_state(tmp_path, CPU)
    cg = port.compiled
    ptrs = _ptrs(cg)
    band = cg.graph.name_map["band"]
    norm = cg.graph.name_map["sum"]
    port.render()
    port.scan_exact()
    assert _ptrs(cg) == ptrs
    mx, smx = cg.num_state[f"{norm}.max"], cg.num_state[f"{norm}.scan_max"]
    assert mx.data_ptr() != smx.data_ptr()
    assert float(mx) == float(smx) > 0
    cg.reset_normalize_vertices()
    assert float(mx) == np.float32(1e-6) and float(smx) > 1e-6
    cg.reset_scan_normalize_vertices()
    assert float(smx) == 0.0 and float(mx) == np.float32(1e-6)
    _window(port, 8)
    assert not bool(cg.num_state[f"{band}.bp"].first)
    cg.set_time(3000)
    assert bool(cg.num_state[f"{band}.bp"].first)
    assert not cg.num_state[f"{band}.bp"].prevs.any()
    _window(port, 8, is_scan=True)
    assert _ptrs(cg) == ptrs
    ref = _ref_state(tmp_path, monkeypatch)
    _window(ref, 20)
    rcg = ref.compiled
    cg.load_reference_state(rcg.num_state, rcg.carries, rcg.get_time())
    assert _ptrs(cg) == ptrs
    np.testing.assert_array_equal(
        cg.num_state[f"{band}.bp"].prevs.numpy(),
        np.asarray(rcg.num_state[f"{band}.bp"].prevs))
    np.testing.assert_allclose(_window(port, 20), _window(ref, 20), rtol=0,
                               atol=1e-5)


def test_c4_effect_states_keep_their_storage(tmp_path):
    """The effects' states (delay tails, scan carries, biquad states) are
    written in place too, and the wet-gated vertices' left untouched."""
    write_c4_project(tmp_path, 2.0, SR, BL, render_sr=8000)
    st = load_state(tmp_path, CPU)
    cg = st.compiled
    ptrs = _ptrs(cg)
    verb = cg.graph.name_map["fxverb"]
    _window(st, 32)  # half the song: the reverb's lines are ringing
    assert _ptrs(cg) == ptrs
    tails = cg.num_state[f"{verb}.fx"]["comb_tails"]
    assert max(float(t.abs().max()) for t in tails) > 1e-4


def test_write_pairs_clones_values_aliasing_a_leaf_being_written():
    """A new value that is another leaf being written (a swap) is read
    before any copy."""
    a, b = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])
    pairs: list = []
    C._state_pairs({"x": a, "y": b}, {"x": b, "y": a[[1, 0]]}, pairs)
    C._write_pairs(pairs)
    assert a.tolist() == [3.0, 4.0] and b.tolist() == [2.0, 1.0]
    pairs = []
    C._state_pairs((a,), (a,), pairs)
    assert pairs == []  # an unchanged leaf is not copied
    with pytest.raises(ValueError, match="state shape"):
        C._state_pairs(a, torch.zeros(3), [])


def test_layout_sizes_match_the_packed_buffers(tmp_path):
    """_layout_sizes gives the buffer lengths _pack_bakes packs, so a
    program's static inputs take any window of its layout."""
    packets = write_c5_project(tmp_path, 2.0, SR, BL, n_tracks=4,
                               hit_sr=16000, bd=16)
    st = load_state(tmp_path, CPU, packets)
    cg = st.compiled
    cg.seed_caps(st.fb, st.cs, NB)
    st.fb.set_time(0)
    bakes, _ = cg._bake_all(st.fb, 0, NB)
    ints, floats, layout = C._pack_bakes(bakes)
    assert C._layout_sizes(layout) == (ints.size, floats.size)
    assert C._layout_sizes(()) == (1, 1)


# -- the device inputs of the program -----------------------------------------

@pytest.mark.parametrize("t0", [0, 5, 1023, 4096 + 17])
def test_sample_loop_takes_a_device_t0(t0):
    """sample_loop at a 0-d tensor t0 equals it at the Python int, and the
    reference's tiled slice."""
    s = torch.from_numpy(
        np.random.default_rng(t0).normal(size=(300, 2)).astype(np.float32))
    T = 1000
    want = s.repeat(-(-(T + 300) // 300), 1)[t0 % 300:t0 % 300 + T]
    assert torch.equal(sampler.sample_loop(s, t0, T), want)
    assert torch.equal(sampler.sample_loop(s, torch.tensor(t0), T), want)


def test_prebuilt_band_pass_gammas_and_eq3_coefs_match():
    """The gammas and the eq3's coefficients built once at graph build
    give what the per-window uploads gave, bit for bit."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(500, 2)).astype(np.float32))
    lg = filters.gamma_from_cutoff(2000.0, SR)
    hg = filters.gamma_from_cutoff(60.0, SR)
    st0 = filters.BandPassState.init(CPU)
    wet = torch.tensor(1.0)
    a = filters.band_pass_timeline(x, st0, lg, hg, True, wet)
    b = filters.band_pass_timeline(
        x, st0, lg, hg, True, wet, g=filters.band_pass_gammas(lg, hg, CPU))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].prevs, b[1].prevs)
    eff = fx.EFFECTS["eq3"]
    static = fx.static_values(eff, eff.defaults)
    bound = fx.bind_static(eff, SR, static, CPU)
    params = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in eff.defaults.items() if k not in eff.static_params}
    params["low_gain"] = torch.tensor(3.0)
    y1, s1 = eff.process(x, eff.init_state(SR, static, CPU), params, SR,
                         static)
    y2, s2 = eff.process(x, eff.init_state(SR, static, CPU), params, SR,
                         bound)
    assert torch.equal(y1, y2)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_fx_vector_is_updated_in_place(tmp_path):
    """A PluginHost change copies the new values into the graph's one
    parameter vector, which every program reads: no new vector."""
    write_c4_project(tmp_path, 1.0, SR, BL, render_sr=8000)
    st = load_state(tmp_path, CPU)
    cg = st.compiled
    comp = str(cg.graph.name_map["fxcomp"])
    params = cg._pack_fx()
    vec, view = cg._fx_vec, params[comp]["ratio"]
    assert float(view) == 3.0
    st.host.set_value("comp", "ratio", 5.5)
    assert cg._pack_fx() is params and cg._fx_vec is vec
    assert float(view) == 5.5
