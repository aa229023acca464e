"""The port held to the reference's bake-table suite
(tests/test_bake_caps.py): block-table caps, the clock fold, stable
layouts and one time table over randomized schedules, the bounded program
cache and its eviction, the window's cost, and the prebaked and recorded
chains, through termdaw_tpu_torch with the same projects, seeds and
assertions.

Every case that renders or caches runs on the device of its parameter
(tests/torch_ref.py): `cpu` here, `cuda` on the card, where it also
asserts which hand-written kernels launched and what the captured
programs do: a fixed count of captures over randomized schedules, and an
evicted program's CUDAGraph gone with its memory pool returned. The
voice-cap table cases are held to the reference's own tables in
tests/test_torch_chains.py. Imports nothing of JAX or termdaw_tpu:

    python -m pytest tests/test_torch_ref_bake_caps.py -m cuda -q
"""

import numpy as np

from termdaw_tpu_torch.graph import bake as B
from termdaw_tpu_torch.graph.compile import _pack_bakes
from termdaw_tpu_torch.engine.state import render_chunk_blocks

from .torch_ref import (  # noqa: F401
    captured_programs, device, host, launched, pool_segment_bytes,
)


class TestBlockTableCaps:
    def test_cap_pins_width(self):
        """Mirror of tests/test_bake_caps.py::TestBlockTableCaps::
        test_cap_pins_width."""
        starts = np.array([0, 10, 20], np.int64)
        ends = starts + 5
        idx = B.block_table(starts, ends, 0, 4, 16, p_cap=8)
        assert idx.shape == (4, 8)

    def test_cap_pins_width_when_empty(self):
        """Mirror of tests/test_bake_caps.py::TestBlockTableCaps::
        test_cap_pins_width_when_empty."""
        idx = B.block_table(np.zeros(0, np.int64), np.zeros(0, np.int64),
                            0, 4, 16, p_cap=8)
        assert idx.shape == (4, 8)
        idx2 = B.block_table(np.array([9999], np.int64),
                             np.array([10005], np.int64), 0, 4, 16, p_cap=8)
        assert idx2.shape == (4, 8)

    def test_overflow_grows_without_steal(self):
        """Mirror of tests/test_bake_caps.py::TestBlockTableCaps::
        test_overflow_grows_without_steal."""
        n = 5
        starts = np.zeros(n, np.int64)
        ends = np.full(n, 64, np.int64)
        idx = B.block_table(starts, ends, 0, 2, 32, p_cap=2)
        assert idx.shape[1] == 8  # pow2(5)
        assert set(idx[0][idx[0] >= 0].tolist()) == set(range(n))

    def test_overflow_steals_oldest(self):
        # 5 concurrent voices, cap 2, steal: keep the LAST 2 per block
        """Mirror of tests/test_bake_caps.py::TestBlockTableCaps::
        test_overflow_steals_oldest."""
        n = 5
        starts = np.arange(n, dtype=np.int64)  # staggered trigger order
        ends = starts + 64
        idx = B.block_table(starts, ends, 0, 1, 32, p_cap=2, steal=True)
        assert idx.shape == (1, 2)
        kept = set(idx[0].tolist())
        assert kept == {3, 4}  # newest voices survive; oldest stolen


class TestClockFold:
    def test_cumsum_matches_sequential_f32_fold(self):
        """Mirror of tests/test_bake_caps.py::TestClockFold::
        test_cumsum_matches_sequential_f32_fold.
        The whole f32-parity scheme rests on np.cumsum(dtype=float32)
        accumulating in the same order as the reference's sequential
        `t = f32(t + delta)` fold (extensions.rs:526-527). That is an
        implementation property of numpy's add.accumulate — pin it."""
        for sr, bl in ((48000, 1024), (44100, 256), (8000, 256)):
            delta = B.f32_div(bl, sr)
            for start in (np.float32(0.0), -B.f32_div(500, sr),
                          np.float32(123.456)):
                n = 4000
                got = B.clock_fold(start, n, delta)
                t = np.float32(start)
                for j in range(n):
                    assert got[j] == t, (sr, bl, float(start), j)
                    t = np.float32(t + delta)


    def test_batched_fold_matches_per_row_clock_fold(self):
        """Mirror of tests/test_bake_caps.py::TestClockFold::
        test_batched_fold_matches_per_row_clock_fold.
        batched_clock_fold (one 2-D f32 cumsum for every note) must be
        elementwise-identical to per-note clock_fold on its segment and
        exactly zero outside it — np.add.accumulate is sequential per
        lane, and the leading zeros are exact (f32(0+v0) == v0)."""
        rng = np.random.default_rng(3)
        nb = 375
        delta = B.f32_div(1024, 48000)
        k0 = rng.integers(0, nb - 1, 200)
        hi = np.minimum(nb - 1, k0 + rng.integers(0, nb, 200))
        v0 = rng.uniform(-2, 2, 200).astype(np.float32)
        got = B.batched_clock_fold(k0, v0, hi, nb, delta)
        for r in range(200):
            want = B.clock_fold(v0[r], hi[r] - k0[r] + 1, delta)
            assert np.array_equal(got[r, k0[r]:hi[r] + 1], want), r
            assert not got[r, :k0[r]].any(), r
            assert not got[r, hi[r] + 1:].any(), r


class TestCapped:
    def test_capped_floor_and_growth(self):
        """Mirror of tests/test_bake_caps.py::TestCapped::
        test_capped_floor_and_growth."""
        assert B._capped(3, None) == 4
        assert B._capped(3, 16) == 16
        assert B._capped(33, 16) == 64
        assert B._capped(0, None) == 1


def _make_state(tmp_path, n_tracks=6, length_sec=4.0, sr=8000, bl=256,
                seed=0, device="cpu"):
    """Small stream-driven project with deliberately bursty event density
    (the shape that minted per-window program variants in round 2)."""
    from termdaw_tpu_torch.config import Config
    from termdaw_tpu_torch.engine.state import State
    from termdaw_tpu_torch.utils.fixtures import drum
    from termdaw_tpu_torch.fileio.packets import encode_events, PacketDecoder

    d = tmp_path / "proj"
    d.mkdir(exist_ok=True)
    drum(d / "hit.wav", sr, 0.05, 300.0, 30.0)
    lines = [
        f"set_length({length_sec});",
        f"set_render_samplerate({sr});",
        "set_render_bitdepth(16);",
        f'set_output_file("{d}/outp.wav");',
        f'load_sample("hit", "{d}/hit.wav", "");',
        'add_normalize("sum", 1.0, 0.0);',
    ]
    for i in range(n_tracks):
        lines += [
            f'declare_stream("s{i}");',
            f'add_sample_multi("t{i}", 1.0, 0.0, "hit", "s{i}", -1);',
            f'connect("t{i}", "sum");',
        ]
    lines.append('set_output("sum");')
    (d / "project.lua").write_text("\n".join(lines))
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = {bl}\n'
        f"project_samplerate = {sr}\n"
    )
    st = State(Config.read(d / "project.toml"), str(d),
               device=device)
    st.refresh()
    assert st.loaded
    rng = np.random.default_rng(seed)
    blob = b""
    for i in range(n_tracks):
        # bursty: all of track i's events land in one random half-second
        t0 = rng.uniform(0.0, length_sec - 0.6)
        times = np.sort(rng.uniform(t0, t0 + 0.5, size=12)).astype(np.float32)
        ev = np.stack(
            [np.zeros(12, np.float32), times, np.full(12, 36.0, np.float32),
             rng.uniform(0.4, 1.0, 12).astype(np.float32)], axis=1,
        )
        blob += encode_events(f"s{i}", ev)
    st.fb.append_streams(PacketDecoder().feed(blob))
    return st


class TestStableLayouts:
    def test_one_layout_across_all_windows(self, tmp_path):
        """Mirror of tests/test_bake_caps.py::TestStableLayouts::
        test_one_layout_across_all_windows.
        After seed_caps, every render window of a bursty multi-track
        project packs to the SAME layout -> one jitted program."""
        st = _make_state(tmp_path)
        cg = st.compiled
        st.fb.set_time(0)
        cg.set_time(0)
        step = render_chunk_blocks(st.cs)
        cg.seed_caps(st.fb, st.cs, step)
        layouts = set()
        left, t = st.cs, 0
        while left > 0:
            nb = min(left, step)
            bakes, nc = cg._bake_all(st.fb, t, nb)
            _, _, layout = _pack_bakes(bakes)
            layouts.add((nb, layout))
            cg.carries.update(nc)
            st.fb.advance_blocks(nb)
            t += nb * cg.bl
            left -= nb
        n_window_sizes = len({nb for nb, _ in layouts})
        assert len(layouts) == n_window_sizes  # one layout per window size

    def test_program_cache_fixed_over_randomized_schedules(self, tmp_path,
                                                           device):
        """Mirror of tests/test_bake_caps.py::TestStableLayouts::
        test_program_cache_fixed_over_randomized_schedules.
        Many randomized schedules of the SAME project -> the packed
        layout set stays fixed once caps are seeded (jit keys = layouts,
        so the program cache cannot grow). Cap stickiness is scoped per
        project dir, so every rebuild uses the same dir — the real
        refresh/stream-append story. The port also renders each schedule
        through the program cache on a second State of the same seed:
        every schedule makes (on the card: captures) one program per
        window size, a fixed count."""
        layouts = set()
        captures = []
        for seed in range(4):
            st = _make_state(tmp_path, seed=seed)
            cg = st.compiled
            st.fb.set_time(0)
            step = render_chunk_blocks(st.cs)
            cg.seed_caps(st.fb, st.cs, step)
            left, t = st.cs, 0
            while left > 0:
                nb = min(left, step)
                bakes, nc = cg._bake_all(st.fb, t, nb)
                _, _, layout = _pack_bakes(bakes)
                layouts.add((nb, layout))
                cg.carries.update(nc)
                st.fb.advance_blocks(nb)
                t += nb * cg.bl
                left -= nb
            st2 = _make_state(tmp_path, seed=seed, device=device)
            with launched(device, "voice_mix"):
                st2.render_device()
            captures.append(st2.compiled.captures)
            assert len(captured_programs(st2.compiled)) == captures[-1]
        # all randomized schedules share the cap-pinned layouts; caps are
        # sticky across the State rebuilds via the module high-water map
        n_window_sizes = 1
        assert len(layouts) <= n_window_sizes + 1  # allow one growth step
        assert captures == [n_window_sizes] * 4


class TestTimeTablePinned:
    def test_one_ttab_shape_across_all_windows(self, tmp_path):
        """Mirror of tests/test_bake_caps.py::TestTimeTablePinned::
        test_one_ttab_shape_across_all_windows.
        seed_caps pins the frame->seconds table to the full song length:
        every window then passes the SAME pow2-rounded table shape to jit
        (before the fix, a long render walked 2^k brackets and minted one
        program per bracket despite identical window sizes)."""
        from termdaw_tpu_torch.graph.compile import time_table

        st = _make_state(tmp_path, length_sec=4.0)
        cg = st.compiled
        step = 8  # force several windows whose end frames straddle pow2s
        cg.seed_caps(st.fb, st.cs, step)
        assert cg._ttab_min_frames == st.cs * cg.bl
        shapes = set()
        left, t = st.cs, 0
        while left > 0:
            nb = min(left, step)
            shapes.add(int(time_table(
                cg.sr, max(t + nb * cg.bl, cg._ttab_min_frames)
            ).shape[0]))
            t += nb * cg.bl
            left -= nb
        assert len(shapes) == 1
        # unpinned, the same walk spans more than one bracket (the bug)
        raw = {int(time_table(cg.sr, e).shape[0])
               for e in (8 * cg.bl, st.cs * cg.bl)}
        assert len(raw) == 2


class TestSeedCapsPreservesState:
    def test_fb_cursor_and_carries_untouched(self, tmp_path):
        """Mirror of tests/test_bake_caps.py::TestSeedCapsPreservesState::
        test_fb_cursor_and_carries_untouched."""
        st = _make_state(tmp_path)
        cg = st.compiled
        st.fb.set_time(3 * 256)
        frame_before = st.fb.frame
        starts_before = list(st.fb.start_indices)
        carries_before = {k: repr(v) for k, v in cg.carries.items()}
        cg.seed_caps(st.fb, st.cs, render_chunk_blocks(st.cs))
        assert st.fb.frame == frame_before
        assert st.fb.start_indices == starts_before
        assert {k: repr(v) for k, v in cg.carries.items()} == carries_before


class TestProgramCacheLru:
    def test_bounded_lru_eviction(self, monkeypatch):
        """Mirror of tests/test_bake_caps.py::TestProgramCacheLru::
        test_bounded_lru_eviction.
        _PROGRAM_CACHE is a bounded LRU: compiled programs pin their
        CompiledGraph (device sample buffers), so dead-spec entries must
        eventually evict."""
        from termdaw_tpu_torch.graph import compile as C

        monkeypatch.setattr(C, "_PROGRAM_CACHE", {})
        monkeypatch.setattr(C, "_PROGRAM_CACHE_CAP", 3)
        for k in "abc":
            C._cache_put(k, k)
        assert C._cache_get("a") == "a"  # refreshes 'a' to most-recent
        C._cache_put("d", "d")           # evicts 'b', the oldest
        assert C._cache_get("b") is None
        assert C._cache_get("a") == "a"
        assert C._cache_get("d") == "d"

    def test_evicted_programs_release_their_graph(self, tmp_path,
                                                  monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestProgramCacheLru::
        test_evicted_programs_release_their_graph.
        Compiled programs pin CompiledGraph (device sample buffers)
        via their closures; once evicted, the old graph must become
        collectable — the device-memory leak across topology-changing
        refreshes. On the card an evicted program's CUDAGraph is freed
        with it and its graph's memory pool returns to the device."""
        import gc
        import weakref

        from termdaw_tpu_torch.config import Config
        from termdaw_tpu_torch.engine.state import State
        from termdaw_tpu_torch.graph import compile as C
        from termdaw_tpu_torch.utils.fixtures import drum

        monkeypatch.setattr(C, "_PROGRAM_CACHE", {})
        # small cap so each new topology fully evicts the previous
        # graph's programs (a render mints ~2: render + scan window)
        monkeypatch.setattr(C, "_PROGRAM_CACHE_CAP", 2)
        d = tmp_path / "p"
        d.mkdir()
        sr, bl = 8000, 256
        drum(d / "hit.wav", sr, 0.05, 300.0, 30.0)
        (d / "project.toml").write_text(
            f'[settings]\nmain = "project.lua"\nbuffer_length = {bl}\n'
            f"project_samplerate = {sr}\n"
        )
        refs, graphs, pools = [], [], []
        for n in range(2, 7):  # 5 distinct topologies
            lines = [
                "set_length(0.5);",
                f"set_render_samplerate({sr});",
                f'set_output_file("{d}/o.wav");',
                f'load_sample("hit", "{d}/hit.wav", "");',
                'add_normalize("sum", 1.0, 0.0);',
            ]
            for i in range(n):
                lines += [
                    f'add_sampleloop("t{i}", 1.0, 0.0, "hit");',
                    f'connect("t{i}", "sum");',
                ]
            lines.append('set_output("sum");')
            (d / "project.lua").write_text("\n".join(lines))
            st = State(Config.read(d / "project.toml"), str(d),
                       device=device)
            st.refresh()
            assert st.loaded
            with launched(device):
                st.render()
            refs.append(weakref.ref(st.compiled))
            progs = captured_programs(st.compiled)
            graphs.append([weakref.ref(p.graph) for p in progs
                           if p.graph is not None])
            pools.append(st.compiled._graph_pool)
            del st, progs
        assert len(C._PROGRAM_CACHE) <= 2
        for _ in range(3):
            gc.collect()
        # the OLD graphs must be collectable once their programs evict
        # (JAX runtime internals may briefly pin the most recent one or
        # two beyond the newest; before the LRU, NONE ever released)
        dead = sum(1 for r in refs[:-1] if r() is None)
        assert dead >= len(refs) - 2, f"only {dead} old graphs released"
        if device.type == "cuda":
            # the last graph's program is cached: captured, pool in use
            assert graphs[-1] and all(g() is not None for g in graphs[-1])
            assert pool_segment_bytes(pools[-1]) > 0
            # the first three graphs' programs were evicted
            for g, pool in zip(graphs[:3], pools[:3]):
                assert g and all(r() is None for r in g)
                assert pool_segment_bytes(pool) == 0


class TestWindowCost:
    def test_cost_analysis_of_compiled_window(self, tmp_path, device):
        """Mirror of tests/test_bake_caps.py::TestWindowCost::
        test_cost_analysis_of_compiled_window.
        window_cost (the bench roofline hook) returns the cost of the
        exact cached program without advancing time or minting a new
        program (graph/compile.py:window_cost). The reference reads XLA's
        cost analysis; the port counts its program op by op, the same on
        the CPU and the card."""
        from termdaw_tpu_torch.graph import compile as gc
        from termdaw_tpu_torch.engine.state import render_chunk_blocks

        st = _make_state(tmp_path, device=device)
        step = render_chunk_blocks(st.cs)
        st.compiled.seed_caps(st.fb, st.cs, step)
        st.compiled.set_time(0)
        st.fb.set_time(0)
        with launched(device, "voice_mix"):
            st.compiled.render_window(st.fb, step)  # capture + replay once
        st.compiled.set_time(0)
        st.fb.set_time(0)
        keys_before = set(gc._PROGRAM_CACHE.keys())
        ca = st.compiled.window_cost(st.fb, step)
        assert st.compiled.get_time() == 0  # no time advance
        assert set(gc._PROGRAM_CACHE.keys()) == keys_before
        assert float(ca["flops"]) > 0.0
        assert ca["ops"]["kernel:voice_mix_stereo"][0] >= 1
        if device.type == "cuda":  # the captured program's own bytes
            assert ca["_mem"]["peak_bytes"] > 0


class TestPrebakedChain:
    """seed_caps pass 2 (round 5): renders of an unchanged schedule are
    served from the prebaked window chain — bit-identically, with zero
    per-window host bakes — and anything that invalidates the chain
    (schedule feed, seek, disabled prebake) falls back to live baking
    with identical output."""

    @staticmethod
    def _render_np(st):
        import numpy as np

        st.fb.set_time(st.compiled.get_time())
        chunks = st.render_device()
        out = np.concatenate([host(c) for c in chunks])
        st.compiled.set_time(0)
        return out

    @staticmethod
    def _count_bakes(cg):
        """Wrap cg._bake_all with a call counter."""
        calls = {"n": 0}
        orig = cg._bake_all

        def wrapped(*a, **k):
            calls["n"] += 1
            return orig(*a, **k)

        cg._bake_all = wrapped
        return calls

    def test_repeat_render_serves_prebaked_bit_identically(
            self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_repeat_render_serves_prebaked_bit_identically."""
        import numpy as np

        # the prebaked chain covers the single-device grid (the real-TPU
        # bench path); under the conftest's 8-CPU mesh render_device
        # would take the sharded live-bake path instead
        monkeypatch.setenv("TERMDAW_MESH", "0")
        # 20 s at 8 kHz / 256 = 625 blocks -> two windows (512 + 113):
        # the second window exercises the chain lineage (expect pointer)
        st = _make_state(tmp_path, length_sec=20.0, device=device)
        with launched(device, "voice_mix"):
            r1 = self._render_np(st)
        captures = st.compiled.captures
        calls = self._count_bakes(st.compiled)
        # the Normalize vertex's running max legitimately grows across
        # renders (reference extensions.rs:321-329 self-adapting
        # semantics) — reset it so render 2's only variable is the bake
        st.compiled.reset_normalize_vertices()
        r2 = self._render_np(st)
        assert calls["n"] == 0, "second render must not re-bake anything"
        assert np.array_equal(r1, r2)
        # the served render replays the programs the first one made
        assert st.compiled.captures == captures
        assert len(captured_programs(st.compiled)) == captures
        # the chain is served window-by-window in order
        pb = st.compiled._prebaked
        assert pb is not None and len(pb["index"]) >= 2

    def test_prebake_off_is_bit_identical(
            self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_prebake_off_is_bit_identical."""
        import numpy as np

        monkeypatch.setenv("TERMDAW_MESH", "0")
        st = _make_state(tmp_path, seed=3, device=device)
        with launched(device, "voice_mix"):
            on1 = self._render_np(st)
        on2 = self._render_np(st)
        monkeypatch.setenv("TERMDAW_PREBAKE", "0")
        st2 = _make_state(tmp_path, seed=3, device=device)
        assert st2.compiled._prebake_on is False
        off1 = self._render_np(st2)
        off2 = self._render_np(st2)
        assert np.array_equal(on1, off1)
        assert np.array_equal(on2, off2)

    def test_feed_invalidates_and_matches_live(
            self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_feed_invalidates_and_matches_live."""
        import numpy as np

        from termdaw_tpu_torch.fileio.packets import encode_events, PacketDecoder

        def feed(st):
            ev = np.array([[0.0, 1.2, 36.0, 0.9], [0.0, 2.1, 36.0, 0.7]],
                          np.float32)
            st.fb.append_streams(PacketDecoder().feed(
                encode_events("s0", ev)
            ))

        monkeypatch.setenv("TERMDAW_MESH", "0")
        st = _make_state(tmp_path, seed=5, device=device)
        with launched(device, "voice_mix"):
            base = self._render_np(st)
        feed(st)  # version bump -> stale chain must NOT be served
        fed = self._render_np(st)
        assert not np.array_equal(base, fed), "new events must be audible"
        # ground truth: same project + same feed with prebake disabled
        monkeypatch.setenv("TERMDAW_PREBAKE", "0")
        st2 = _make_state(tmp_path, seed=5, device=device)
        base2 = self._render_np(st2)
        feed(st2)
        fed2 = self._render_np(st2)
        assert np.array_equal(base, base2)
        assert np.array_equal(fed, fed2)

    def test_seek_breaks_chain_and_matches_live(
            self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_seek_breaks_chain_and_matches_live."""
        import numpy as np

        monkeypatch.setenv("TERMDAW_MESH", "0")
        st = _make_state(tmp_path, seed=7, device=device)
        with launched(device, "voice_mix"):
            self._render_np(st)  # seed + first render
        # seek to a mid-timeline frame, render one window live
        bl = st.config.settings.buffer_length
        st.compiled.set_time(4 * bl)
        st.fb.set_time(4 * bl)
        calls = self._count_bakes(st.compiled)
        w1 = host(st.compiled.render_window(st.fb, 2))
        assert calls["n"] == 1, "an off-grid window must live-bake"
        monkeypatch.setenv("TERMDAW_PREBAKE", "0")
        st2 = _make_state(tmp_path, seed=7, device=device)
        self._render_np(st2)
        st2.compiled.set_time(4 * bl)
        st2.fb.set_time(4 * bl)
        w2 = host(st2.compiled.render_window(st2.fb, 2))
        assert np.array_equal(w1, w2)

    def test_budget_bounds_chain_with_live_tail(
            self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_budget_bounds_chain_with_live_tail.
        TERMDAW_PREBAKE_MB bounds the stored chain: windows past the
        budget live-bake, and the output still matches a fully-live
        render bit-exactly (the chain prefix hands off mid-render)."""
        import numpy as np

        monkeypatch.setenv("TERMDAW_MESH", "0")
        # ~0 MB budget: at most one window is stored
        monkeypatch.setenv("TERMDAW_PREBAKE_MB", "0.000001")
        st = _make_state(tmp_path, seed=9, length_sec=20.0, device=device)
        with launched(device, "voice_mix"):
            r1 = self._render_np(st)
        pb = st.compiled._prebaked
        assert pb is not None and len(pb["wins"]) <= 1, (
            "budget must stop the chain after the first window"
        )
        monkeypatch.setenv("TERMDAW_PREBAKE", "0")
        st2 = _make_state(tmp_path, seed=9, length_sec=20.0, device=device)
        assert np.array_equal(r1, self._render_np(st2))

    def test_stateful_carries_serve_recorded_chain(self, tmp_path,
                                                   monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_stateful_carries_serve_recorded_chain.
        Carries that stay legitimately stateful across renders (a
        SampleLerp voice holding its last trigger — reference
        extensions.rs:383-421) miss the fresh-start seed chain, but they
        reach a STEADY state: render 2 is live-baked and RECORDED, and
        renders 3+ serve the recording (zero bakes), bit-identically."""
        import numpy as np

        from termdaw_tpu_torch.config import Config
        from termdaw_tpu_torch.engine.state import State
        from termdaw_tpu_torch.utils.fixtures import drum
        from termdaw_tpu_torch.fileio.midi import write_midi

        monkeypatch.setenv("TERMDAW_MESH", "0")
        d = tmp_path / "lerp"
        d.mkdir()
        drum(d / "hit.wav", 8000, 0.05, 300.0, 30.0)
        write_midi(d / "hits.mid",
                   [(0.2, 0.1, 36, 100), (1.1, 0.1, 36, 90),
                    (2.3, 0.1, 36, 80)], bpm=120)
        (d / "project.lua").write_text(f"""
set_length(4.0);
set_render_samplerate(8000);
set_render_bitdepth(16);
set_output_file("{d}/o.wav");
load_sample("hit", "{d}/hit.wav", "");
load_midi_floww("hits", "{d}/hits.mid");
add_sample_lerp("lerp", 1.0, 0.0, "hit", "hits", -1, 40);
add_normalize("sum", 1.0, 0.0);
connect("lerp", "sum");
set_output("sum");
""")
        (d / "project.toml").write_text(
            '[settings]\nmain = "project.lua"\nbuffer_length = 256\n'
            "project_samplerate = 8000\n"
        )
        st = State(Config.read(d / "project.toml"), str(d),
                   device=device)
        st.refresh()
        assert st.loaded
        with launched(device):  # a SampleLerp: no hand-written kernel
            self._render_np(st)         # render 1: seed chain serves
        st.compiled.reset_normalize_vertices()
        r2 = self._render_np(st)        # render 2: live-baked + recorded
        assert st.compiled._recorded, "render 2 must have been recorded"
        calls = self._count_bakes(st.compiled)
        st.compiled.reset_normalize_vertices()
        r3 = self._render_np(st)        # render 3: served from recording
        assert calls["n"] == 0, "steady-state render must not re-bake"
        assert np.array_equal(r2, r3)

    def test_seek_after_served_render_keeps_chain_intact(
            self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_seek_after_served_render_keeps_chain_intact.
        Served carry deltas are ALIASED into the live engine (carries
        are immutable values -- every engine change rebinds). The one
        historical in-place mutation site, set_time's SampSyn clock
        remap, now rebinds too: a seek right after a served render must
        leave the chain's stored objects bit-untouched (with an in-place
        remap + aliasing they would shift by dt), and later renders must
        match a prebake-disabled ground truth exactly."""
        import numpy as np

        from termdaw_tpu_torch.config import Config
        from termdaw_tpu_torch.engine.state import State
        from termdaw_tpu_torch.fileio.midi import write_midi
        from termdaw_tpu_torch.fileio.wavetable import WaveTable, write_wavetable

        monkeypatch.setenv("TERMDAW_MESH", "0")

        def build(sub):
            d = tmp_path / sub
            d.mkdir()
            # a note held past the schedule end leaves the SampSyn carry
            # non-empty after the render -- the served seed chain's final
            # delta then aliases a live NotesCarry, which the seek remaps
            write_midi(d / "m.mid", [(0.1, 9.0, 60, 100)], bpm=120)
            write_wavetable(d / "t.wt", WaveTable.default())
            (d / "project.lua").write_text(f"""
set_length(4.0);
set_render_samplerate(8000);
set_render_bitdepth(16);
set_output_file("{d}/o.wav");
load_midi_floww("m", "{d}/m.mid");
load_resource("tbl", "{d}/t.wt");
add_sampsyn("syn", 0.8, 0.0, "m", {{0.01, 0.1, 0.8, 5.0, 0.2, 0.5}}, "tbl");
add_normalize("sum", 1.0, 0.0);
connect("syn", "sum");
set_output("sum");
""")
            (d / "project.toml").write_text(
                '[settings]\nmain = "project.lua"\nbuffer_length = 256\n'
                "project_samplerate = 8000\n"
            )
            st = State(Config.read(d / "project.toml"), str(d),
                       device=device)
            st.refresh()
            assert st.loaded
            return st

        st = build("syn")
        # render 1 serves the seed chain; do NOT reset time yet -- the
        # engine's own set_time(0) reset IS the remap under test
        st.fb.set_time(st.compiled.get_time())
        with launched(device, "sampsyn", "vertex_post"):
            r1 = np.concatenate([
                host(c) for c in st.render_device()
            ])
        # the live carry must alias a stored chain object for this
        # regression guard to be meaningful
        pb = st.compiled._prebaked
        assert pb is not None
        stored_notes = [
            c for w in pb["wins"] for c in w[3].values()
            if getattr(c, "notes", None)
        ]
        live = list(st.compiled.carries.values())
        assert any(
            any(c is lv for lv in live) for c in stored_notes
        ), "served delta should alias stored carry objects"
        snap = [
            (n.on_f, n.off_f, n.dead_f, n.env_t, n.rel_t)
            for c in stored_notes for n in c.notes
        ]
        st.compiled.set_time(0)  # SampSyn clock remap (dt = -total)
        st.fb.set_time(0)
        assert snap == [
            (n.on_f, n.off_f, n.dead_f, n.env_t, n.rel_t)
            for c in stored_notes for n in c.notes
        ], "seek must not mutate chain-stored carries"
        r2 = self._render_np(st)      # starts from the remapped carry

        # ground truth: identical project + identical op sequence with
        # the chain machinery off entirely
        monkeypatch.setenv("TERMDAW_PREBAKE", "0")
        st2 = build("syn_live")
        g1 = self._render_np(st2)
        g2 = self._render_np(st2)
        assert np.array_equal(r1, g1)
        assert np.array_equal(r2, g2)

    def test_unfresh_index_matches_brute_force(
            self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_unfresh_index_matches_brute_force.
        The incremental _unfresh index (chain-serve eligibility rides
        on it) must equal a from-scratch freshness scan at every state
        transition: refresh, served render, live render, seek, off-grid
        window, stream feed."""
        import numpy as np

        from termdaw_tpu_torch.config import Config
        from termdaw_tpu_torch.engine.state import State
        from termdaw_tpu_torch.fileio.midi import write_midi
        from termdaw_tpu_torch.fileio.packets import encode_events, PacketDecoder
        from termdaw_tpu_torch.graph.compile import _FRESH_CARRIES
        from termdaw_tpu_torch.utils.fixtures import drum

        def brute(cg):
            return {
                vi for vi, c in cg.carries.items()
                if _FRESH_CARRIES.get(cg.statics[vi].kind) != c
            }

        def check(cg, where):
            assert cg._unfresh == brute(cg), where
            assert cg._carries_fresh() == (not brute(cg)), where

        monkeypatch.setenv("TERMDAW_MESH", "0")
        d = tmp_path / "inv"
        d.mkdir()
        drum(d / "hit.wav", 8000, 0.05, 300.0, 30.0)
        # notes held across window boundaries + a lerp retrigger: several
        # kinds end renders legitimately stateful
        write_midi(d / "hits.mid",
                   [(0.2, 0.8, 36, 100), (1.4, 2.4, 40, 90)], bpm=120)
        (d / "project.lua").write_text(f"""
set_length(4.0);
set_render_samplerate(8000);
set_render_bitdepth(16);
set_output_file("{d}/o.wav");
load_sample("hit", "{d}/hit.wav", "");
load_midi_floww("hits", "{d}/hits.mid");
declare_stream("live");
add_sample_multi("m", 1.0, 0.0, "hit", "live", -1);
add_sample_lerp("lerp", 1.0, 0.0, "hit", "hits", -1, 40);
add_synth("syn", 0.5, 0.0, "hits",
    0.4, 0.3, {{0.001, 0.02, 0.0, 0.0, 0.0, 0.0}},
    1.0, 0.8, {{0.01, 0.1, 0.8, 0.5, 0.2, 0.5}},
    0.5, {{0.01, 0.1, 0.8, 0.5, 0.2, 0.5}});
add_adsr("env", 1.0, 0.0, 1.0, "hits", false, true, -1,
    {{0.01, 0.1, 0.8, 0.4, 0.2, 0.6}});
add_normalize("sum", 1.0, 0.0);
connect("m", "sum");
connect("lerp", "env");
connect("env", "sum");
connect("syn", "sum");
set_output("sum");
""")
        (d / "project.toml").write_text(
            '[settings]\nmain = "project.lua"\nbuffer_length = 256\n'
            "project_samplerate = 8000\n"
        )
        st = State(Config.read(d / "project.toml"), str(d),
                   device=device)
        st.refresh()
        assert st.loaded
        cg = st.compiled
        check(cg, "after refresh")
        with launched(device, "voice_mix", "synth", "vertex_post"):
            self._render_np(st)
        check(cg, "after render 1 (+closing set_time)")
        self._render_np(st)
        check(cg, "after render 2 (recorded path)")
        bl = st.config.settings.buffer_length
        cg.set_time(5 * bl)
        st.fb.set_time(5 * bl)
        check(cg, "after mid-timeline seek")
        cg.render_window(st.fb, 3)
        check(cg, "after off-grid live window")
        ev = np.array([[0.0, 3.2, 36.0, 0.9]], np.float32)
        st.fb.append_streams(PacketDecoder().feed(encode_events("live", ev)))
        cg.set_time(0)
        st.fb.set_time(0)
        self._render_np(st)
        check(cg, "after feed + re-render")

    def test_feed_purges_stale_recorded_chains(
            self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_feed_purges_stale_recorded_chains.
        A content-version bump can never revert, so recorded chains
        from older bank versions are purged (releasing their byte-budget
        share) as soon as a new recording starts — they must not wait
        for LRU eviction while holding device memory."""
        import numpy as np

        from termdaw_tpu_torch.config import Config
        from termdaw_tpu_torch.engine.state import State
        from termdaw_tpu_torch.fileio.midi import write_midi
        from termdaw_tpu_torch.fileio.packets import encode_events, PacketDecoder
        from termdaw_tpu_torch.utils.fixtures import drum

        monkeypatch.setenv("TERMDAW_MESH", "0")
        d = tmp_path / "purge"
        d.mkdir()
        drum(d / "hit.wav", 8000, 0.05, 300.0, 30.0)
        write_midi(d / "hits.mid", [(0.2, 0.1, 36, 100)], bpm=120)
        (d / "project.lua").write_text(f"""
set_length(4.0);
set_render_samplerate(8000);
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
        (d / "project.toml").write_text(
            '[settings]\nmain = "project.lua"\nbuffer_length = 256\n'
            "project_samplerate = 8000\n"
        )
        st = State(Config.read(d / "project.toml"), str(d),
                   device=device)
        st.refresh()
        assert st.loaded
        cg = st.compiled
        with launched(device, "voice_mix"):
            self._render_np(st)   # seed chain serves (fresh)
        self._render_np(st)   # stateful lerp -> live + RECORDED (v1)
        assert cg._recorded and cg._prebake_used > 0
        v1_banks = {r["bank"] for r in cg._recorded}
        # feed -> version v2; next stateful render records under v2 and
        # must purge the v1 chain
        ev = np.array([[0.0, 1.5, 36.0, 0.7]], np.float32)
        st.fb.append_streams(PacketDecoder().feed(encode_events("live", ev)))
        self._render_np(st)
        banks_now = {r["bank"] for r in cg._recorded}
        assert banks_now, "the v2 render must have recorded"
        assert not (v1_banks & banks_now), "stale-bank chains must purge"

    def test_refresh_releases_replaced_graphs_chains(self, tmp_path,
                                                     monkeypatch, device):
        """Mirror of tests/test_bake_caps.py::TestPrebakedChain::
        test_refresh_releases_replaced_graphs_chains.
        The program cache can pin a replaced CompiledGraph; its chains
        are pure cache and must be dropped at refresh so they never hold
        device memory from the pin."""
        monkeypatch.setenv("TERMDAW_MESH", "0")
        st = _make_state(tmp_path, seed=21, device=device)
        with launched(device, "voice_mix"):
            self._render_np(st)  # builds the seed chain
        old = st.compiled
        assert old._prebaked is not None
        assert captured_programs(old)
        pool = old._graph_pool
        st.refresh()
        assert old._prebaked is None
        assert not old._recorded and old._prebake_used == 0
        # and its programs and memory pool (known deviation 9)
        assert old.programs() == [] and old._graph_pool is None
        if device.type == "cuda":
            assert pool_segment_bytes(pool) == 0
