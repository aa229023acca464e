"""The port held to the reference's event suite (tests/test_events.py):
MIDI, the FlowwBank and its cursors and memos, packets, the sorted bake
fast path, and a stream feed reaching the next window through
termdaw_tpu_torch, with the same events, seeds and assertions.

The feed case runs on the device of its parameter (tests/torch_ref.py):
`cpu` here, `cuda` on the card, where the fed window replays the
program captured before the feed (no new capture) and the voice mix
(csrc/voice_mix.cu) launched. The host cases have no device. Imports
nothing of JAX or termdaw_tpu:

    python -m pytest tests/test_torch_ref_events.py -m cuda -q
"""

import numpy as np
import pytest

from termdaw_tpu_torch.fileio.midi import read_floww_from_midi, write_midi, MidiError
from termdaw_tpu_torch.fileio.packets import (
    encode_events, encode_text, PacketDecoder, KIND_EVENTS, KIND_TEXT,
)
from termdaw_tpu_torch.banks.flowwbank import FlowwBank, event_frames

from .torch_ref import captured_programs, device, host, launched  # noqa: F401


def ev(t, note, vel, chan=0.0):
    return [chan, t, note, vel]


class TestMidi:
    def test_roundtrip(self, tmp_path):
        """Mirror of tests/test_events.py::TestMidi::test_roundtrip."""
        p = tmp_path / "t.mid"
        notes = [(0.0, 0.5, 60, 100), (0.5, 0.25, 64, 80), (1.0, 1.0, 67, 127)]
        write_midi(p, notes, bpm=120.0)
        fl = read_floww_from_midi(p)
        ons = fl[fl[:, 3] > 0.001]
        offs = fl[fl[:, 3] <= 0.001]
        assert len(ons) == 3 and len(offs) == 3
        np.testing.assert_allclose(ons[:, 1], [0.0, 0.5, 1.0], atol=1e-4)
        np.testing.assert_allclose(ons[:, 2], [60, 64, 67])
        np.testing.assert_allclose(ons[:, 3], [100 / 127, 80 / 127, 1.0],
                                   atol=1e-6)
        np.testing.assert_allclose(offs[:, 1], [0.5, 0.75, 2.0], atol=1e-4)

    def test_tempo_change_scaling(self, tmp_path):
        """Mirror of tests/test_events.py::TestMidi::
        test_tempo_change_scaling."""
        p = tmp_path / "t240.mid"
        write_midi(p, [(1.0, 0.5, 60, 100)], bpm=240.0)
        fl = read_floww_from_midi(p)
        np.testing.assert_allclose(fl[0, 1], 1.0, atol=1e-4)

    def test_bad_file(self, tmp_path):
        """Mirror of tests/test_events.py::TestMidi::test_bad_file."""
        p = tmp_path / "bad.mid"
        p.write_bytes(b"garbage data")
        with pytest.raises(MidiError):
            read_floww_from_midi(p)

    def test_truncated_track_is_midi_error(self, tmp_path):
        """Mirror of tests/test_events.py::TestMidi::
        test_truncated_track_is_midi_error.
        A track body that ends mid-event must raise MidiError (which
        refresh excludes gracefully), not IndexError."""
        import struct

        # delta 0, note-on status, note byte... then EOF (missing vel)
        body = bytes([0x00, 0x90, 60])
        blob = b"MThd" + struct.pack(">IHHH", 6, 0, 1, 96)
        blob += b"MTrk" + struct.pack(">I", len(body)) + body
        p = tmp_path / "trunc.mid"
        p.write_bytes(blob)
        with pytest.raises(MidiError):
            read_floww_from_midi(p)

    def test_noteon_vel0_is_off(self, tmp_path):
        """Mirror of tests/test_events.py::TestMidi::
        test_noteon_vel0_is_off.
        Note-on with velocity 0 is a note-off per the MIDI spec."""
        import struct

        def varlen0():
            return bytes([0])

        body = varlen0() + bytes([0x90, 60, 100])
        body += bytes([0x60]) + bytes([0x90, 60, 0])  # running status, vel 0
        body += varlen0() + bytes([0xFF, 0x2F, 0x00])
        blob = b"MThd" + struct.pack(">IHHH", 6, 0, 1, 96)
        blob += b"MTrk" + struct.pack(">I", len(body)) + body
        p = tmp_path / "v0.mid"
        p.write_bytes(blob)
        fl = read_floww_from_midi(p)
        assert fl[0, 3] > 0.5 and fl[1, 3] == 0.0


class TestFlowwBank:
    def make(self, events, sr=100, bl=10):
        fb = FlowwBank(sr, bl)
        fb.declare_floww("f", np.asarray(events, np.float32))
        return fb

    def test_drum_basic(self):
        # events at frames 5, 15 (t = f/sr)
        """Mirror of tests/test_events.py::TestFlowwBank::test_drum_basic."""
        fb = self.make([ev(0.05, 60, 0.9), ev(0.15, 62, 0.8)])
        bake = fb.bake_drum(0, 2)
        np.testing.assert_array_equal(bake.frames, [5, 15])
        np.testing.assert_allclose(bake.vels, [0.9, 0.8])

    def test_drum_skips_offs_and_duplicates(self):
        # off at frame 5, two ons at frame 5: only first on fires
        """Mirror of tests/test_events.py::TestFlowwBank::
        test_drum_skips_offs_and_duplicates."""
        fb = self.make([
            ev(0.05, 60, 0.0), ev(0.05, 61, 0.9), ev(0.05, 62, 0.7),
        ])
        bake = fb.bake_drum(0, 1)
        np.testing.assert_array_equal(bake.frames, [5])
        np.testing.assert_allclose(bake.notes, [61])

    def test_drum_note_filter(self):
        """Mirror of tests/test_events.py::TestFlowwBank::
        test_drum_note_filter."""
        fb = self.make([ev(0.01, 60, 0.9), ev(0.02, 62, 0.9)])
        bake = fb.bake_drum(0, 1).filter_note(62)
        np.testing.assert_array_equal(bake.frames, [2])

    def test_simple_on_off(self):
        """Mirror of tests/test_events.py::TestFlowwBank::
        test_simple_on_off."""
        fb = self.make([ev(0.03, 60, 0.9), ev(0.07, 60, 0.0)])
        bake = fb.bake_simple(0, 1)
        np.testing.assert_array_equal(bake.frames, [3, 7])
        np.testing.assert_array_equal(bake.ons, [True, False])

    def test_cursor_advance_and_set_time(self):
        """Mirror of tests/test_events.py::TestFlowwBank::
        test_cursor_advance_and_set_time."""
        fb = self.make([ev(0.05, 60, 0.9), ev(0.25, 62, 0.8)])
        # consume first block: only frame-5 hit
        b0 = fb.bake_drum(0, 1)
        np.testing.assert_array_equal(b0.frames, [5])
        fb.set_time_to_next_block()
        b1 = fb.bake_drum(0, 2)  # blocks [10,30): frame-25 hit
        np.testing.assert_array_equal(b1.frames, [25])
        fb.set_time(0)
        b_all = fb.bake_drum(0, 3)
        np.testing.assert_array_equal(b_all.frames, [5, 25])

    def test_bake_does_not_mutate(self):
        """Mirror of tests/test_events.py::TestFlowwBank::
        test_bake_does_not_mutate."""
        fb = self.make([ev(0.05, 60, 0.9)])
        fb.bake_drum(0, 5)
        assert fb.frame == 0 and fb.start_indices[0] == 0

    def test_streams_append_trim(self):
        """Mirror of tests/test_events.py::TestFlowwBank::
        test_streams_append_trim."""
        fb = FlowwBank(100, 10)
        fb.declare_stream("s")
        pkts = PacketDecoder().feed(
            encode_events("s", np.asarray([ev(0.05, 60, 0.9)], np.float32))
            + encode_text("hello")
        )
        msgs = fb.append_streams(pkts)
        assert msgs == ["hello"]
        assert fb.flowws[0].shape == (1, 4)
        bake = fb.bake_drum(0, 1)
        np.testing.assert_array_equal(bake.frames, [5])
        # quirk preserved (reference floww.rs:70-81): with no event at/after
        # the new frame, the start index does NOT advance, so trim keeps it
        fb.set_time_to_next_block()
        fb.trim_streams()
        assert fb.flowws[0].shape[0] == 1
        # once a later event exists, the cursor advances past consumed ones
        fb.append_streams(
            PacketDecoder().feed(
                encode_events("s", np.asarray([ev(0.15, 61, 0.9)], np.float32))
            )
        )
        fb.set_time(fb.frame)  # re-sync like the stream workflow does
        fb.trim_streams()
        assert fb.flowws[0].shape[0] == 1  # old frame-5 event dropped
        np.testing.assert_allclose(fb.flowws[0][0, 2], 61)

    def test_event_frames_f32_faithful(self):
        # t*sr computed in f32 then truncated
        """Mirror of tests/test_events.py::TestFlowwBank::
        test_event_frames_f32_faithful."""
        events = np.asarray([ev(0.1, 60, 1.0)], np.float32)
        f = event_frames(events, 44100)
        expect = int(np.float32(0.1) * np.float32(44100))
        assert f[0] == expect

    def test_unknown_stream_reports(self):
        """Mirror of tests/test_events.py::TestFlowwBank::
        test_unknown_stream_reports."""
        fb = FlowwBank(100, 10)
        msgs = fb.append_streams(
            PacketDecoder().feed(
                encode_events("nope", np.zeros((0, 4), np.float32))
            )
        )
        assert msgs == ["unknown stream: nope"]


class TestPackets:
    def test_roundtrip_split_feed(self):
        """Mirror of tests/test_events.py::TestPackets::
        test_roundtrip_split_feed."""
        evs = np.asarray([ev(0.5, 64, 0.7), ev(1.0, 65, 0.0)], np.float32)
        blob = encode_events("drums", evs) + encode_text("msg")
        dec = PacketDecoder()
        got = []
        # feed one byte at a time: decoder must handle partial frames
        for i in range(len(blob)):
            got.extend(dec.feed(blob[i : i + 1]))
        assert len(got) == 2
        assert got[0].kind == KIND_EVENTS and got[0].name == "drums"
        np.testing.assert_allclose(got[0].events, evs)
        assert got[1].kind == KIND_TEXT and got[1].text == "msg"


class TestSortedBakeFastPath:
    """The vectorized sorted-floww fast paths in bake_drum/bake_simple must
    be frame-for-frame identical to the per-block Python replay of the
    reference cursor semantics (floww.rs:93-141)."""

    def _banks(self, events, sr=100, bl=10):
        a = FlowwBank(sr, bl)
        a.declare_floww("f", np.asarray(events, np.float32))
        b = FlowwBank(sr, bl)
        b.declare_floww("f", np.asarray(events, np.float32))
        # force the loop path on b regardless of sortedness
        b._frames_sorted = lambda i: False
        return a, b

    def _assert_drum_equal(self, x, y):
        np.testing.assert_array_equal(x.frames, y.frames)
        np.testing.assert_array_equal(x.notes, y.notes)
        np.testing.assert_array_equal(x.vels, y.vels)

    def _assert_simple_equal(self, x, y):
        np.testing.assert_array_equal(x.frames, y.frames)
        np.testing.assert_array_equal(x.ons, y.ons)
        np.testing.assert_array_equal(x.notes, y.notes)
        np.testing.assert_array_equal(x.vels, y.vels)

    def test_randomized_schedules_match(self, rng):
        """Mirror of tests/test_events.py::TestSortedBakeFastPath::
        test_randomized_schedules_match."""
        for trial in range(30):
            n = int(rng.integers(0, 40))
            times = np.sort(rng.uniform(0.0, 2.0, n)).astype(np.float32)
            # inject duplicate frames and on/off mixtures
            if n > 3:
                times[1] = times[0]
                times[3] = times[2]
            notes = rng.integers(50, 70, n).astype(np.float32)
            vels = rng.uniform(0.0, 1.0, n).astype(np.float32)
            vels[rng.uniform(size=n) < 0.3] = 0.0  # offs
            events = np.stack(
                [np.zeros(n, np.float32), times, notes, vels], axis=1
            )
            fast, loop = self._banks(events)
            # walk in windows with interleaved cursor ops
            for fbk in (fast, loop):
                fbk.set_time(0)
            for w in range(4):
                nb = int(rng.integers(1, 8))
                self._assert_drum_equal(
                    fast.bake_drum(0, nb), loop.bake_drum(0, nb)
                )
                self._assert_simple_equal(
                    fast.bake_simple(0, nb), loop.bake_simple(0, nb)
                )
                fast.advance_blocks(nb)
                loop.advance_blocks(nb)
            # seek semantics stay aligned too
            t = int(rng.integers(0, 150))
            fast.set_time(t)
            loop.set_time(t)
            self._assert_drum_equal(
                fast.bake_drum(0, 5), loop.bake_drum(0, 5)
            )
            self._assert_simple_equal(
                fast.bake_simple(0, 5), loop.bake_simple(0, 5)
            )

    def test_unsorted_floww_uses_loop_path(self):
        # out-of-order events: the fast path must not engage (frames
        # unsorted), and behavior must follow the reference stale rules
        """Mirror of tests/test_events.py::TestSortedBakeFastPath::
        test_unsorted_floww_uses_loop_path."""
        ev_list = [ev(0.15, 62, 0.8), ev(0.05, 60, 0.9)]
        fb = FlowwBank(100, 10)
        fb.declare_floww("f", np.asarray(ev_list, np.float32))
        assert not fb._frames_sorted(0)
        bake = fb.bake_drum(0, 2)
        # block 0: event@15 out of range; block 1: 15 hits, then 5 is stale
        np.testing.assert_array_equal(bake.frames, [15])


class TestStreamRebake:
    """The live-feed path: a packet appended to a stream must reach the
    very next rendered window (incremental re-bake via the FlowwBank
    version bump) WITHOUT minting a new program (bake layouts are
    cap-pinned; a feed that made one would stall the stream workflow).
    On the card: no new capture after the feed, and every window a
    replay of the program captured before it."""

    def _project(self, tmp_path, device, n_tracks=4, sr=8000, bl=256):
        from termdaw_tpu_torch.config import Config
        from termdaw_tpu_torch.engine.state import State
        from termdaw_tpu_torch.utils.fixtures import drum

        drum(tmp_path / "hit.wav", sr, 0.05, 300.0, 30.0)
        lines = [
            "set_length(2.0);",
            f"set_render_samplerate({sr});",
            'set_output_file("mix.wav");',
            f'load_sample("hit", "{tmp_path}/hit.wav", "");',
            'add_normalize("sum", 1.0, 0.0);',
        ]
        for i in range(n_tracks):
            lines += [
                f'declare_stream("s{i}");',
                f'add_sample_multi("t{i}", 1.0, 0.0, "hit", "s{i}", -1);',
                f'connect("t{i}", "sum");',
            ]
        lines.append('set_output("sum");')
        (tmp_path / "project.lua").write_text("\n".join(lines))
        (tmp_path / "project.toml").write_text(
            f'[settings]\nmain = "project.lua"\nbuffer_length = {bl}\n'
            f"project_samplerate = {sr}\n"
        )
        st = State(Config.read(tmp_path / "project.toml"), str(tmp_path),
                   device=device)
        st.refresh()
        assert st.loaded
        return st

    def test_feed_reaches_next_window_without_recompile(self, tmp_path,
                                                        device):
        """Mirror of tests/test_events.py::TestStreamRebake::
        test_feed_reaches_next_window_without_recompile."""
        from termdaw_tpu_torch.graph import compile as gc

        sr, bl = 8000, 256
        st = self._project(tmp_path, device, sr=sr, bl=bl)
        cg = st.compiled
        # live mode warmup, like the stream workflow's play(): caps seeded
        # from the (empty) schedule, first nb=1 window made
        cg.seed_caps(st.fb, st.cs, 4)
        with launched(device, "voice_mix"):
            silent = host(cg.render_window(st.fb, 1))
        st.fb.advance_blocks(1)
        assert np.max(np.abs(silent)) == 0.0
        keys_before = set(gc._PROGRAM_CACHE.keys())
        (prog,) = captured_programs(cg)
        captures, replays = cg.captures, prog.replays

        # feed one hit landing exactly 2 blocks ahead, the workflow way
        # (workflows/stream.py): trim, append, resync cursor.
        # mid-window target: the f32 multiply-truncate frame mapping
        # (banks/flowwbank.event_frames) can land a boundary-placed event
        # on the window's final frame, where the drum's first sample is
        # ~0 — aim 16 frames in so the hit has audible body
        t_now = cg.get_time()
        ev = np.array(
            [[0.0, (t_now + bl + 16) / sr, 36.0, 0.9]], np.float32
        )
        pkts = PacketDecoder().feed(encode_events("s1", ev))
        st.fb.trim_streams()
        assert st.fb.append_streams(pkts) == []
        st.fb.set_time(t_now)

        with launched(device):  # replays only: no warm-up, no capture
            quiet = host(cg.render_window(st.fb, 1))
            st.fb.advance_blocks(1)
            hit = host(cg.render_window(st.fb, 1))
            st.fb.advance_blocks(1)
        assert np.max(np.abs(quiet)) == 0.0  # event is 1 block away still
        assert np.max(np.abs(hit)) > 0.01, "fed event missed its window"
        # frame-exact placement: silent before the in-window event frame,
        # energy from it on
        assert np.max(np.abs(hit[:8])) == 0.0
        assert np.max(np.abs(hit[14:64])) > 0.0

        keys_after = set(gc._PROGRAM_CACHE.keys())
        assert keys_after == keys_before, (
            "stream feed minted a new compiled program: "
            f"{keys_after - keys_before}"
        )
        assert cg.captures == captures
        assert captured_programs(cg) == [prog]
        assert prog.replays == replays + 2


class TestSetTimeMemo:
    """set_time's per-(version, roster, t) rescan memo must be invisible:
    identical cursor state to a memo-free bank through arbitrary
    interleavings, and never built/served when any floww disqualifies
    (empty, all events before t, identity-replaced roster)."""

    def _bank(self, flowws, sr=100, bl=10):
        fb = FlowwBank(sr, bl)
        for i, events in enumerate(flowws):
            fb.declare_floww(
                f"f{i}", np.asarray(events, np.float32).reshape(-1, 4)
            )
        return fb

    def _rand_flowws(self, rng, n_flowws, min_events=1):
        out = []
        for _ in range(n_flowws):
            n = int(rng.integers(min_events, 12))
            times = np.sort(rng.uniform(0.0, 2.0, n)).astype(np.float32)
            notes = rng.integers(50, 70, n).astype(np.float32)
            vels = rng.uniform(0.0, 1.0, n).astype(np.float32)
            out.append(
                np.stack([np.zeros(n, np.float32), times, notes, vels], 1)
            )
        return out

    def test_memo_matches_memoless_walk(self, rng):
        """Mirror of tests/test_events.py::TestSetTimeMemo::
        test_memo_matches_memoless_walk."""
        for _ in range(15):
            flowws = self._rand_flowws(rng, 20)  # >= _POOL_MIN_FLOWWS
            a = self._bank(flowws)
            b = self._bank(flowws)
            b._memo_rescan = lambda t: None  # b never builds the memo
            for _ in range(12):
                op = int(rng.integers(0, 3))
                if op == 0:
                    nb = int(rng.integers(1, 6))
                    a.advance_blocks(nb)
                    b.advance_blocks(nb)
                elif op == 1:
                    t = int(rng.integers(0, 260))  # past some schedules
                    a.set_time(t)
                    b.set_time(t)
                else:  # the render-reset hot case: repeat seeks to 0
                    a.set_time(0)
                    b.set_time(0)
                assert a.frame == b.frame
                assert a.start_indices == b.start_indices

    def test_memo_is_served_si_independent(self):
        """Mirror of tests/test_events.py::TestSetTimeMemo::
        test_memo_is_served_si_independent."""
        flowws = [
            [ev(0.05 * (i + 1), 60, 0.9), ev(1.5, 60, 0.0)]
            for i in range(20)
        ]
        fb = self._bank(flowws)
        fb.set_time(0)
        assert fb._rescan_memo is not None and 0 in fb._rescan_memo[2]
        want = list(fb._si)
        fb.advance_blocks(3)  # leave a deferred lag pending
        fb._si[0] = 7  # scribble: the rescan overwrites every index
        fb.set_time(0)  # memo hit: no reconcile, full overwrite
        assert fb._si == want and fb._lag == 0 and fb.frame == 0

    def test_empty_floww_disables_memo(self):
        """Mirror of tests/test_events.py::TestSetTimeMemo::
        test_empty_floww_disables_memo."""
        flowws = [[ev(0.1, 60, 0.9)]] * 19 + [np.zeros((0, 4), np.float32)]
        fb = self._bank(flowws)
        fb.set_time(0)
        assert fb._rescan_memo is None

    def test_all_events_before_t_not_memoized(self):
        """Mirror of tests/test_events.py::TestSetTimeMemo::
        test_all_events_before_t_not_memoized."""
        flowws = [[ev(0.1, 60, 0.9)] for _ in range(20)]
        fb = self._bank(flowws)
        fb.set_time(0)  # eligible: memoized
        fb.set_time(500)  # past every event: the quirk fires, no memo
        m = fb._rescan_memo
        assert m is not None and 0 in m[2] and 500 not in m[2]

    def test_roster_replacement_invalidates_memo(self):
        """Mirror of tests/test_events.py::TestSetTimeMemo::
        test_roster_replacement_invalidates_memo."""
        flowws = [
            [ev(0.0, 60, 0.9), ev(0.5, 60, 0.9)] for _ in range(20)
        ]
        fb = self._bank(flowws)
        fb.set_time(40)
        assert fb._rescan_memo is not None and 40 in fb._rescan_memo[2]
        assert fb._si[0] == 1
        # direct replacement (the supported external mutation path — no
        # version bump): the identity guard must force a fresh rescan
        fb.flowws[0] = np.asarray(
            [ev(0.0, 61, 0.9), ev(0.1, 61, 0.9), ev(0.5, 61, 0.9)],
            np.float32,
        )
        fb.set_time(40)
        assert fb._si[0] == 2

    def test_small_bank_memoizes_too(self):
        # below _POOL_MIN_FLOWWS the rescan uses the per-floww loop;
        # the memo sits above both paths and must behave identically
        """Mirror of tests/test_events.py::TestSetTimeMemo::
        test_small_bank_memoizes_too."""
        flowws = [[ev(0.3, 60, 0.9), ev(0.9, 60, 0.0)] for _ in range(3)]
        fb = self._bank(flowws)
        fb.set_time(50)
        first = list(fb._si)
        fb.advance_blocks(4)
        fb.set_time(50)  # memo hit
        assert fb._si == first

    def test_memo_lru_keeps_rehit_entry(self):
        # the render-reset t=0 entry must survive scrubbing through many
        # distinct seek targets as long as it keeps getting hit (LRU
        # eviction, not wholesale clearing)
        """Mirror of tests/test_events.py::TestSetTimeMemo::
        test_memo_lru_keeps_rehit_entry."""
        flowws = [
            [ev(0.1, 60, 0.9), ev(3.0, 60, 0.0)] for _ in range(20)
        ]
        fb = self._bank(flowws)
        fb.set_time(0)
        for i in range(1, 15):  # 14 distinct seek targets
            fb.set_time(10 * i)
            fb.set_time(0)  # re-hit keeps the hot entry alive
        m = fb._rescan_memo
        assert m is not None and 0 in m[2] and len(m[2]) <= 8
