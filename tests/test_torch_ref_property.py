"""The port held to the reference's property suite
(tests/test_property.py): hypothesis-drawn block tables, clock folds,
pooled cursors and merged group tables against their naive references,
through termdaw_tpu_torch with the same strategies and settings.
Host-only (no device). Imports nothing of JAX or termdaw_tpu."""

import numpy as np
from hypothesis import given, settings, strategies as st

from termdaw_tpu_torch.graph import bake as B


def _naive_block_table(starts, ends, t0, nb, bl, p_cap, steal):
    """Reference semantics of bake.block_table, one block at a time."""
    per_block: list[list[int]] = []
    for k in range(nb):
        b0 = t0 + k * bl
        b1 = b0 + bl
        live = [
            i for i in range(len(starts))
            if starts[i] < b1 and ends[i] > b0
        ]
        per_block.append(live)  # trigger order == index order
    pmax = max((len(x) for x in per_block), default=0)
    if p_cap is not None and pmax > p_cap and steal:
        per_block = [x[-p_cap:] for x in per_block]  # keep the NEWEST
        pmax = p_cap
    if p_cap is not None and pmax <= p_cap:
        p = p_cap
    else:
        p = 1
        while p < max(pmax, 1):
            p *= 2
    idx = np.full((nb, p), -1, np.int32)
    for k, live in enumerate(per_block):
        idx[k, : len(live)] = live
    return idx


spans = st.lists(
    st.tuples(
        st.integers(min_value=-64, max_value=512),   # start
        st.integers(min_value=1, max_value=300),     # duration
    ),
    min_size=0, max_size=24,
)


class TestBlockTableProperty:
    @settings(max_examples=200, deadline=None)
    @given(
        spans,
        st.integers(min_value=0, max_value=128),  # t0
        st.integers(min_value=1, max_value=8),    # nb
        st.sampled_from([16, 32]),                # bl
        st.sampled_from([None, 1, 2, 4, 8]),      # p_cap
        st.booleans(),                            # steal
    )
    def test_matches_naive(self, sp, t0, nb, bl, p_cap, steal):
        """Mirror of tests/test_property.py::TestBlockTableProperty::
        test_matches_naive."""
        starts = np.asarray([s for s, _ in sp], np.int64)
        ends = np.asarray([s + d for s, d in sp], np.int64)
        got = B.block_table(starts, ends, t0, nb, bl, p_cap, steal)
        want = _naive_block_table(starts, ends, t0, nb, bl, p_cap, steal)
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


class TestClockFoldProperty:
    @settings(max_examples=50, deadline=None)
    @given(
        st.floats(min_value=-10.0, max_value=1000.0, allow_nan=False,
                  allow_subnormal=False, width=32),
        st.integers(min_value=1, max_value=3000),
        st.floats(min_value=0.0009765625, max_value=1.0, allow_nan=False,
                  allow_subnormal=False, width=32),
    )
    def test_fold_is_sequential_f32(self, start, n, delta):
        """Mirror of tests/test_property.py::TestClockFoldProperty::
        test_fold_is_sequential_f32."""
        got = B.clock_fold(np.float32(start), n, np.float32(delta))
        t = np.float32(start)
        for j in range(n):
            assert got[j] == t
            t = np.float32(t + np.float32(delta))


class TestPooledCursorProperty:
    """FlowwBank's pooled cursor (one searchsorted across all sorted
    flowws, banks/flowwbank.py:_cursor_pool) must be operation-for-
    operation identical to the per-floww loop path over randomized
    event layouts (sorted, unsorted, empty flowws mixed) and op
    sequences (set_time / advance_blocks / set_time_to_next_block /
    stream appends)."""

    @settings(max_examples=60, deadline=None)
    @given(st.data())
    def test_matches_loop_path(self, data):
        """Mirror of tests/test_property.py::TestPooledCursorProperty::
        test_matches_loop_path."""
        from termdaw_tpu_torch.banks.flowwbank import FlowwBank

        n_flowws = data.draw(st.integers(min_value=16, max_value=24))
        bl = 16
        sr = 1000

        def build():
            fb = FlowwBank(sr, bl)
            return fb

        fb_pool = build()
        fb_loop = build()
        # force the loop path on the control bank
        fb_loop._POOL_MIN_FLOWWS = 10**9

        for i in range(n_flowws):
            kind = data.draw(
                st.sampled_from(["sorted", "unsorted", "empty"])
            )
            if kind == "empty":
                ev = np.zeros((0, 4), np.float32)
            else:
                times = data.draw(
                    st.lists(
                        st.floats(min_value=0.0, max_value=2.0,
                                  allow_nan=False, width=32),
                        min_size=1, max_size=12,
                    )
                )
                if kind == "sorted":
                    times = sorted(times)
                ev = np.zeros((len(times), 4), np.float32)
                ev[:, 1] = times
                ev[:, 2] = 36.0
                ev[:, 3] = 0.9
            for fb in (fb_pool, fb_loop):
                fb.declare_floww(f"f{i}", ev.copy())

        ops = data.draw(
            st.lists(
                st.tuples(
                    st.sampled_from(
                        ["set_time", "advance", "next_block"]
                    ),
                    st.integers(min_value=0, max_value=40),
                ),
                min_size=1, max_size=10,
            )
        )
        for op, arg in ops:
            for fb in (fb_pool, fb_loop):
                if op == "set_time":
                    fb.set_time(arg * bl // 2)
                elif op == "advance":
                    fb.advance_blocks(arg % 8)
                else:
                    fb.set_time_to_next_block()
            assert fb_pool.frame == fb_loop.frame
            assert fb_pool.start_indices == fb_loop.start_indices, (
                op, arg
            )


class TestMergeGroupProperty:
    """_merge_group's segmented per-voice block ranges (compile.py) must
    reproduce the dense-mask semantics exactly: voice p is live in block
    k iff starts[p] < b0+bl and b0 < starts[p]+slen[p]; slot order per
    block = member order then trigger order; per-(block, member)
    voice_cap keeps the NEWEST voices; begins clamp to [0, slen+bl] plus
    the member's concat-buffer base."""

    @staticmethod
    def _naive(starts, vels, mid, slen_by_m, base_by_m, t0, nb, bl,
               pf_cap, voice_cap):
        rows = []
        for k in range(nb):
            b0 = t0 + k * bl
            live = [
                p for p in range(len(starts))
                if starts[p] < b0 + bl and b0 < starts[p] + slen_by_m[mid[p]]
            ]
            if voice_cap is not None:
                by_m: dict[int, list[int]] = {}
                for p in live:
                    by_m.setdefault(mid[p], []).append(p)
                live = [
                    p for m in sorted(by_m)
                    for p in by_m[m][-voice_cap:]
                ]
            rows.append(live)
        pmax = max((len(r) for r in rows), default=0)
        if pf_cap is not None and pmax <= pf_cap:
            pf = max(pf_cap, 1)
        else:
            pf = 1
            while pf < max(pmax, 1):
                pf *= 2
        begins = np.zeros((nb, pf), np.int32)
        vel = np.zeros((nb, pf), np.float32)
        member = np.zeros((nb, pf), np.int32)
        for k, live in enumerate(rows):
            b0 = t0 + k * bl
            for j, p in enumerate(live):
                m = mid[p]
                begins[k, j] = (
                    min(max(b0 - starts[p] + bl, 0), slen_by_m[m] + bl)
                    + base_by_m[m]
                )
                vel[k, j] = vels[p]
                member[k, j] = m
        return begins, vel, member

    @settings(max_examples=120, deadline=None)
    @given(st.data())
    def test_matches_dense_reference(self, data):
        """Mirror of tests/test_property.py::TestMergeGroupProperty::
        test_matches_dense_reference."""
        from types import SimpleNamespace

        from termdaw_tpu_torch.graph.compile import CompiledGraph

        bl = 16
        n_members = data.draw(st.integers(min_value=1, max_value=4))
        slen_by_m = [
            data.draw(st.integers(min_value=1, max_value=90))
            for _ in range(n_members)
        ]
        base_by_m = [1000 * m for m in range(n_members)]
        nb = data.draw(st.integers(min_value=1, max_value=8))
        t0 = data.draw(st.integers(min_value=0, max_value=64))
        voice_cap = data.draw(st.sampled_from([None, 1, 2]))
        pf_cap = data.draw(st.sampled_from([None, 1, 4, 8]))
        parts_f, parts_v, parts_m = [], [], []
        for m in range(n_members):
            k = data.draw(st.integers(min_value=0, max_value=6))
            f = sorted(
                data.draw(st.integers(min_value=-120, max_value=220))
                for _ in range(k)
            )
            parts_f += f
            parts_v += [0.1 + 0.01 * i for i in range(k)]
            parts_m += [m] * k
        starts = np.asarray(parts_f, np.int64)
        vels = np.asarray(parts_v, np.float32)
        mid = np.asarray(parts_m, np.int32)

        stub = SimpleNamespace(
            bl=bl,
            voice_cap=voice_cap,
            bake_caps={"fused0": {"pf": pf_cap} if pf_cap else {}},
            _fused_vecs={},
            _fused_layout={0: (None, {m: base_by_m[m]
                                      for m in range(n_members)})},
            statics={m: SimpleNamespace(sample_len=slen_by_m[m],
                                        sample_pos=m)
                     for m in range(n_members)},
            _fused_member_vecs=CompiledGraph._fused_member_vecs,
        )
        stub._fused_member_vecs = (
            lambda consumer, members: CompiledGraph._fused_member_vecs(
                stub, consumer, members
            )
        )
        got = CompiledGraph._merge_group(
            stub, (starts, vels, mid), 0, list(range(n_members)), t0, nb
        )
        wb, wv, wm = self._naive(
            starts, vels, mid, slen_by_m, base_by_m, t0, nb, bl,
            pf_cap, voice_cap,
        )
        np.testing.assert_array_equal(got["begins"], wb)
        np.testing.assert_array_equal(got["vel"], wv)
        np.testing.assert_array_equal(got["member"], wm)
