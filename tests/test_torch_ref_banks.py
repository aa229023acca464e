"""The port held to the reference's bank suite (tests/test_banks.py):
the sample bank's load modes, the FlowwBank's composed block advance and
deferred reconcile, and its pooled cursor on malformed events, through
termdaw_tpu_torch with the same files, seeds and assertions. Host-only
(no device). Imports nothing of JAX or termdaw_tpu."""

import numpy as np
import pytest

from termdaw_tpu_torch.banks import SampleBank, SampleLoadMethod
from termdaw_tpu_torch.fileio.wav import write_wav

SR = 8000


def make_stereo(tmp_path, name="s.wav"):
    # left: loud ramp; right: quiet sine
    n = 400
    l = np.linspace(0, 0.8, n).astype(np.float32)
    r = (0.2 * np.sin(np.linspace(0, 12, n))).astype(np.float32)
    p = tmp_path / name
    write_wav(p, np.stack([l, r], 1), SR, bits=32)
    return p, l, r


def make_mono(tmp_path, name="m.wav"):
    n = 300
    x = (0.5 * np.sin(np.linspace(0, 20, n))).astype(np.float32)
    p = tmp_path / name
    write_wav(p, x[:, None], SR, bits=32)
    return p, x


class TestLoadModes:
    def test_stereo_requires_two_channels(self, tmp_path):
        """Mirror of tests/test_banks.py::TestLoadModes::
        test_stereo_requires_two_channels."""
        p, x = make_mono(tmp_path)
        sb = SampleBank(SR)
        with pytest.raises(ValueError, match="2 channel"):
            sb.add("m", str(p), SampleLoadMethod.STEREO)

    def test_stereo_peak_normalized_jointly(self, tmp_path):
        """Mirror of tests/test_banks.py::TestLoadModes::
        test_stereo_peak_normalized_jointly."""
        p, l, r = make_stereo(tmp_path)
        sb = SampleBank(SR)
        sb.add("s", str(p), SampleLoadMethod.STEREO)
        s = sb.get_sample(0)
        # joint peak normalize: L peaks at 1, R keeps relative level
        assert abs(np.max(np.abs(s.l)) - 1.0) < 1e-5
        assert np.max(np.abs(s.r)) < 0.3

    def test_left_copies_left(self, tmp_path):
        """Mirror of tests/test_banks.py::TestLoadModes::
        test_left_copies_left."""
        p, l, r = make_stereo(tmp_path)
        sb = SampleBank(SR)
        sb.add("s", str(p), SampleLoadMethod.LEFT)
        s = sb.get_sample(0)
        np.testing.assert_allclose(s.l, s.r)
        np.testing.assert_allclose(s.l, l / np.max(np.abs(l)), atol=1e-5)

    def test_right_copies_right(self, tmp_path):
        """Mirror of tests/test_banks.py::TestLoadModes::
        test_right_copies_right."""
        p, l, r = make_stereo(tmp_path)
        sb = SampleBank(SR)
        sb.add("s", str(p), SampleLoadMethod.RIGHT)
        s = sb.get_sample(0)
        np.testing.assert_allclose(s.l, s.r)
        np.testing.assert_allclose(
            s.l, r / np.max(np.abs(r)), atol=1e-5
        )

    def test_loudest_picks_louder_channel(self, tmp_path):
        """Mirror of tests/test_banks.py::TestLoadModes::
        test_loudest_picks_louder_channel."""
        p, l, r = make_stereo(tmp_path)  # left has higher mean energy
        sb = SampleBank(SR)
        sb.add("s", str(p), SampleLoadMethod.LOUDEST)
        s = sb.get_sample(0)
        np.testing.assert_allclose(s.l, l / np.max(np.abs(l)), atol=1e-5)

    def test_normalize_seperate(self, tmp_path):
        """Mirror of tests/test_banks.py::TestLoadModes::
        test_normalize_seperate."""
        p, l, r = make_stereo(tmp_path)
        sb = SampleBank(SR)
        sb.add("s", str(p), SampleLoadMethod.NORM)
        s = sb.get_sample(0)
        # per-channel peaks both at 1
        assert abs(np.max(np.abs(s.l)) - 1.0) < 1e-5
        assert abs(np.max(np.abs(s.r)) - 1.0) < 1e-5

    def test_mix_down(self, tmp_path):
        """Mirror of tests/test_banks.py::TestLoadModes::test_mix_down."""
        p, l, r = make_stereo(tmp_path)
        sb = SampleBank(SR)
        sb.add("s", str(p), SampleLoadMethod.MIX)
        s = sb.get_sample(0)
        mix = l + r
        mix = mix / np.max(np.abs(mix))
        np.testing.assert_allclose(s.l, mix, atol=1e-5)
        np.testing.assert_allclose(s.l, s.r)

    def test_unknown_mode_string_falls_back_to_stereo(self):
        """Mirror of tests/test_banks.py::TestLoadModes::
        test_unknown_mode_string_falls_back_to_stereo."""
        assert SampleLoadMethod.from_str("whatever") \
            == SampleLoadMethod.STEREO
        assert SampleLoadMethod.from_str("mix-down") == SampleLoadMethod.MIX

    def test_mono_left_mode(self, tmp_path):
        """Mirror of tests/test_banks.py::TestLoadModes::
        test_mono_left_mode."""
        p, x = make_mono(tmp_path)
        sb = SampleBank(SR)
        sb.add("m", str(p), SampleLoadMethod.LEFT)
        s = sb.get_sample(0)
        np.testing.assert_allclose(s.l, x / np.max(np.abs(x)), atol=1e-5)


class TestAdvanceBlocksComposition:
    def test_advance_blocks_equals_stepping(self, rng):
        """Mirror of tests/test_banks.py::TestAdvanceBlocksComposition::
        test_advance_blocks_equals_stepping.
        advance_blocks(n) must equal n single-block steps — including
        the no-event-after-boundary quirk (floww.rs:70-91) — on random,
        unsorted, duplicate-laden event sets."""
        from termdaw_tpu_torch.banks.flowwbank import FlowwBank

        sr, bl = 8000, 64
        for trial in range(30):
            n_ev = int(rng.integers(0, 20))
            times = rng.uniform(-0.1, 2.0, n_ev).astype(np.float32)
            if trial % 3 == 0:
                times = np.sort(times)
            ev = np.stack(
                [np.zeros(n_ev, np.float32), times,
                 rng.uniform(30, 90, n_ev).astype(np.float32),
                 rng.uniform(0, 1, n_ev).astype(np.float32)], axis=1,
            )
            fa = FlowwBank(sr, bl)
            fb_ = FlowwBank(sr, bl)
            t_start = int(rng.integers(0, 3)) * bl
            for b in (fa, fb_):
                b.declare_floww("x", ev)
                b.set_time(t_start)
            n = int(rng.integers(1, 40))
            # oracle: the reference's literal per-block skip (floww.rs:88-91),
            # NOT set_time_to_next_block (which now defers into the same
            # vectorized advance under test)
            for _ in range(n):
                fa.frame += bl
                fa._set_start_indices_to_frame(fa.frame, do_skip=True)
            fb_.advance_blocks(n)
            assert fa.frame == fb_.frame
            assert fa.start_indices == fb_.start_indices, (
                trial, n, times,
            )

    def test_deferred_advance_reconciles_on_read(self, rng):
        """Mirror of tests/test_banks.py::TestAdvanceBlocksComposition::
        test_deferred_advance_reconciles_on_read.
        advance_blocks defers index movement (frame moves eagerly);
        any read of start_indices / bake / set_time / stream mutation
        reconciles to exactly the eager result."""
        from termdaw_tpu_torch.banks.flowwbank import FlowwBank

        sr, bl = 8000, 64
        times = np.sort(rng.uniform(0.0, 1.0, 25).astype(np.float32))
        ev = np.stack(
            [np.zeros(25, np.float32), times,
             np.full(25, 60, np.float32),
             rng.uniform(0.1, 1.0, 25).astype(np.float32)], axis=1,
        )
        lazy = FlowwBank(sr, bl)
        eager = FlowwBank(sr, bl)
        for b in (lazy, eager):
            b.declare_floww("x", ev)
        lazy.advance_blocks(3)
        lazy.advance_blocks(4)  # folds: lag now 7 blocks
        assert lazy._lag == 7 and lazy._si == [0]  # raw state lags
        assert lazy.frame == 7 * bl                # frame is eager
        eager.frame += 7 * bl
        eager._set_start_indices_to_frame(eager.frame, do_skip=True)
        assert lazy.start_indices == eager.start_indices  # read reconciles
        assert lazy._lag == 0
        # bake reconciles too: a deferred-advance bank bakes identically
        lazy2 = FlowwBank(sr, bl)
        lazy2.declare_floww("x", ev)
        lazy2.advance_blocks(7)
        d1 = lazy2.bake_drum(0, 2)
        d2 = eager.bake_drum(0, 2)
        np.testing.assert_array_equal(d1.frames, d2.frames)
        np.testing.assert_array_equal(d1.vels, d2.vels)
        # set_time reconciles before its rescan (the no-event-after-t
        # quirk depends on current indices)
        lazy2.advance_blocks(200)  # past every event
        lazy2.set_time(0)
        eager.advance_blocks(200)
        eager.set_time(0)
        assert lazy2.start_indices == eager.start_indices
        assert lazy2.frame == eager.frame == 0


class TestPooledCursorMalformedEvents:
    def test_nan_event_time_falls_back_to_loop_path(self):
        """Mirror of tests/test_banks.py::TestPooledCursorMalformedEvents::
        test_nan_event_time_falls_back_to_loop_path.
        A malformed packet time (NaN/inf -> INT64_MIN frame via the
        f32 cast) must not corrupt the pooled cursor: the pool declines
        banks with negative frames and every cursor op keeps matching the
        per-floww loop path (review finding, banks/flowwbank.py)."""
        import numpy as np

        from termdaw_tpu_torch.banks.flowwbank import FlowwBank

        def build(poison: bool):
            fb = FlowwBank(1000, 16)
            for i in range(20):
                ev = np.zeros((3, 4), np.float32)
                ev[:, 1] = [0.1 * i, 0.5 + 0.1 * i, 1.0 + 0.1 * i]
                ev[:, 3] = 0.9
                if poison and i == 7:
                    ev[0, 1] = np.nan  # sorts FIRST as INT64_MIN
                fb.declare_floww(f"s{i}", ev)
            return fb

        fb_pool = build(True)
        fb_loop = build(True)
        fb_loop._POOL_MIN_FLOWWS = 10**9
        for t in (0, 8, 40, 96, 512):
            fb_pool.set_time(t)
            fb_loop.set_time(t)
            assert fb_pool.start_indices == fb_loop.start_indices, t
            fb_pool.advance_blocks(3)
            fb_loop.advance_blocks(3)
            assert fb_pool.start_indices == fb_loop.start_indices, t
        # clean banks still take the pooled path (sanity: pool exists)
        fb_clean = build(False)
        fb_clean.advance_blocks(1)
        assert fb_clean._cursor_pool() is not None
        assert fb_pool._cursor_pool() is None  # poisoned: declined
