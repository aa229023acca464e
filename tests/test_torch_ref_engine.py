"""The port held to the reference's engine suite (tests/test_engine.py):
Lua project -> refresh -> window programs -> WAV, with the same Lua,
shapes, seeds and tolerances, through termdaw_tpu_torch.

Every case that builds a State runs on the device of its parameter
(tests/torch_ref.py): `cpu` here, `cuda` on the card, where it also
asserts which hand-written kernels launched and, where the reference
case is about its program cache, what the card's captured programs do.
Imports nothing of JAX or termdaw_tpu:

    python -m pytest tests/test_torch_ref_engine.py -m cuda -q
"""

import threading

import numpy as np

from termdaw_tpu_torch.config import Config
from termdaw_tpu_torch.engine import state as state_mod
from termdaw_tpu_torch.engine.state import State
from termdaw_tpu_torch.fileio.midi import write_midi
from termdaw_tpu_torch.fileio.wav import read_wav, write_wav
from termdaw_tpu_torch.fileio.wavetable import WaveTable, write_wavetable
from termdaw_tpu_torch.graph import compile as gc

from .torch_ref import captured_programs, device, host, launched  # noqa: F401

SR = 8000
BL = 256


def make_project(tmp_path, lua_src, device, name="test", bl=BL, sr=SR):
    (tmp_path / "project.toml").write_text(
        f'[project]\nname = "{name}"\n[settings]\nmain = "project.lua"\n'
        f"buffer_length = {bl}\nproject_samplerate = {sr}\n"
    )
    (tmp_path / "project.lua").write_text(lua_src)
    cfg = Config.read(tmp_path / "project.toml")
    return State(cfg, str(tmp_path), device=device)


def tone_wav(path, freq=440.0, dur=0.25, sr=SR, amp=0.5):
    t = np.arange(int(sr * dur)) / sr
    x = (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    write_wav(path, np.stack([x, x], 1), sr, bits=16)
    return x


class TestSampleLoopNormalize:
    def test_render_matches_numpy_oracle(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestSampleLoopNormalize::
        test_render_matches_numpy_oracle."""
        tone_wav(tmp_path / "tone.wav", freq=200.0, dur=0.1)
        out = tmp_path / "out.wav"
        st = make_project(
            tmp_path,
            f"""
            set_length(0.5);
            set_render_samplerate({SR});
            set_render_bitdepth(16);
            set_output_file("{out}");
            load_sample("tone", "{tmp_path}/tone.wav", "");
            add_sampleloop("loop", 1.0, 0.0, "tone");
            add_normalize("sum", 1.0, 0.0);
            connect("loop", "sum");
            set_output("sum");
            """, device,
        )
        st.refresh()
        assert st.loaded
        assert st.cs == int(np.ceil(SR * 0.5 / BL))
        with launched(device):
            st.render()
        captured_programs(st.compiled)

        got, spec = read_wav(out, scale=False)
        assert spec.sample_rate == SR and spec.bits_per_sample == 16

        # NumPy oracle of the reference semantics
        raw, _ = read_wav(tmp_path / "tone.wav", scale=False)
        sample = raw[:, 0] / np.max(np.abs(raw))  # bank peak-normalize
        L = len(sample)
        T = st.cs * BL
        x = sample[np.arange(T) % L].astype(np.float32)
        xb = x.reshape(st.cs, BL)
        bm = np.max(np.abs(xb), axis=1)
        running = np.maximum.accumulate(np.maximum(bm, 1e-6))
        y = (xb / running[:, None]).reshape(-1)
        expect = np.trunc(np.clip(y * 32767.0, -32768, 32767))

        np.testing.assert_allclose(got[:, 0], expect, atol=1.0)
        np.testing.assert_array_equal(got[:, 0], got[:, 1])

    def test_second_render_identical(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestSampleLoopNormalize::
        test_second_render_identical. Render twice: the fb-resync
        deviation makes renders idempotent, but Normalize's max persists
        (reference behavior) — the second render starts with the adapted
        max, so only assert file health + equality of a third render with
        the second."""
        tone_wav(tmp_path / "tone.wav")
        out = tmp_path / "out.wav"
        st = make_project(
            tmp_path,
            f"""
            set_length(0.25);
            set_output_file("{out}");
            load_sample("tone", "{tmp_path}/tone.wav", "");
            add_sampleloop("loop", 1.0, 0.0, "tone");
            add_normalize("sum", 1.0, 0.0);
            connect("loop", "sum");
            set_output("sum");
            """, device,
        )
        st.refresh()
        with launched(device):
            st.render()
            second, _ = read_wav(out)
            st.render()
            third, _ = read_wav(out)
        np.testing.assert_array_equal(second, third)


class TestWindowInvariance:
    def build(self, tmp_path, device):
        tone_wav(tmp_path / "kick.wav", freq=60.0, dur=0.05)
        write_midi(
            tmp_path / "beat.mid",
            [(0.01, 0.05, 36, 100), (0.13, 0.05, 38, 90),
             (0.29, 0.08, 36, 60), (0.4, 0.3, 48, 110)],
            bpm=120,
        )
        out = tmp_path / "out.wav"
        st = make_project(
            tmp_path,
            f"""
            set_length(0.75);
            set_output_file("{out}");
            load_sample("kick", "{tmp_path}/kick.wav", "");
            load_midi_floww("beat", "{tmp_path}/beat.mid");
            add_sample_multi("hits", 1.0, 10.0, "kick", "beat", -1);
            add_sample_lerp("mono", 0.8, -10.0, "kick", "beat", -1, 32);
            add_synth("syn", 0.5, 0.0, "beat",
                0.4, 0.3, {{0.001, 0.02, 0.0, 0.0, 0.0, 0.0}},
                1.0, 0.8, {{0.01, 0.1, 0.8, 5.0, 0.2, 0.5}},
                0.5, {{0.01, 0.1, 0.8, 5.0, 0.2, 0.5}});
            add_adsr("env", 1.0, 0.0, 1.0, "beat", false, true, -1,
                {{0.01, 0.1, 0.8, 0.1, 0.2, 0.01}});
            add_bandpass("band", 1.0, 0.0, 1.0, 1000, 0, true);
            add_normalize("sum", 1.0, 0.0);
            connect("hits", "env");
            connect("env", "band");
            connect("band", "sum");
            connect("mono", "sum");
            connect("syn", "sum");
            set_output("sum");
            """, device,
        )
        st.refresh()
        assert st.loaded
        return st, out

    def test_windowed_equals_oneshot(self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_engine.py::TestWindowInvariance::
        test_windowed_equals_oneshot."""
        st, out = self.build(tmp_path, device)
        monkeypatch.setattr(state_mod, "RENDER_WINDOW_BLOCKS", 1024)
        with launched(device, "voice_mix", "affine_scan", "synth"):
            st.render()
        oneshot, _ = read_wav(out)

        # rebuild fresh state, render in small windows
        st2, out2 = self.build(tmp_path, device)
        monkeypatch.setattr(state_mod, "RENDER_WINDOW_BLOCKS", 3)
        st2.render()
        chunked, _ = read_wav(out2)
        # the reference's bound, 4 LSB (its window shapes change XLA's
        # fusion and so f32 sin() rounding at large phase arguments)
        np.testing.assert_allclose(oneshot, chunked, atol=4.0)
        assert np.max(np.abs(oneshot)) > 1000  # actually made sound
        # one program a window size: 1024 -> the song's 24 blocks; 3 ->
        # 3-block windows (the song is 8 of them)
        assert len(captured_programs(st.compiled)) == 1
        assert len(captured_programs(st2.compiled)) == 1

    def test_no_nans_and_envelope_gates(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestWindowInvariance::
        test_no_nans_and_envelope_gates."""
        st, out = self.build(tmp_path, device)
        with launched(device, "voice_mix", "affine_scan", "synth"):
            st.render()
        audio, _ = read_wav(out, scale=True)
        assert not np.any(np.isnan(audio))
        assert np.max(np.abs(audio)) <= 1.0 + 1e-6


class TestNormalizeScan:
    def test_scan_freezes_max(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestNormalizeScan::
        test_scan_freezes_max."""
        tone_wav(tmp_path / "tone.wav", freq=100.0, dur=0.3)
        out = tmp_path / "out.wav"
        st = make_project(
            tmp_path,
            f"""
            set_length(0.5);
            set_output_file("{out}");
            load_sample("tone", "{tmp_path}/tone.wav", "");
            add_sampleloop("loop", 2.0, 0.0, "tone");
            add_normalize("sum", 1.0, 0.0);
            connect("loop", "sum");
            set_output("sum");
            """, device,
        )
        st.refresh()
        with launched(device):
            st.scan_exact()
        vals = st.compiled.get_normalization_values()
        assert len(vals) == 1
        name, mx = vals[0]
        assert name == "sum"
        # loop gain 2.0 on a peak-normalized sample -> peak 2.0
        assert abs(mx - 2.0) < 1e-3
        st.render()
        audio, _ = read_wav(out, scale=True)
        # scanned normalize: flat scaling, peak ~1.0, no first-block blowup
        assert abs(np.max(np.abs(audio)) - 1.0) < 1e-2
        # the scan window and the render window: two programs
        assert len(captured_programs(st.compiled)) == 2


class TestSampSynAndFx:
    def test_wavetable_and_fx_chain(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestSampSynAndFx::
        test_wavetable_and_fx_chain."""
        write_midi(tmp_path / "m.mid", [(0.02, 0.2, 60, 100)], bpm=120)
        write_wavetable(tmp_path / "table.wt", WaveTable.default())
        out = tmp_path / "out.wav"
        st = make_project(
            tmp_path,
            f"""
            set_length(0.5);
            set_output_file("{out}");
            load_midi_floww("m", "{tmp_path}/m.mid");
            load_resource("tbl", "{tmp_path}/table.wt");
            load_lv2("verb", "http://calf.sourceforge.net/plugins/Reverb");
            load_lv2("comp", "http://calf.sourceforge.net/plugins/Compressor");
            parameter("comp", "Attack", 40.0);
            parameter("comp", "Ratio", 2.0);
            add_sampsyn("syn", 0.8, 0.0, "m",
                {{0.01, 0.1, 0.8, 5.0, 0.2, 0.5}}, "tbl");
            add_lv2fx("fx1", 1.0, 0.0, 0.9, "verb");
            add_lv2fx("fx2", 1.0, 0.0, 1.0, "comp");
            add_normalize("sum", 1.0, 0.0);
            connect("syn", "fx1");
            connect("fx1", "fx2");
            connect("fx2", "sum");
            set_output("sum");
            """, device,
        )
        st.refresh()
        assert st.loaded
        with launched(device, "affine_scan", "max_decay_scan", "sampsyn"):
            st.render()
        audio, _ = read_wav(out, scale=True)
        assert not np.any(np.isnan(audio))
        assert np.max(np.abs(audio)) > 0.05

    def test_pack_fx_memoized_until_param_change(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestSampSynAndFx::
        test_pack_fx_memoized_until_param_change. _pack_fx is served from
        its PluginHost.version memo between windows and re-packs (new
        values, same layout) after set_value. The port's form: the same
        per-vertex dict of 0-d views of one device vector, whose values
        are copied in place at a version change (a captured program reads
        the vector by address), where the reference returns a new array
        and the same layout."""
        write_midi(tmp_path / "m.mid", [(0.02, 0.2, 60, 100)], bpm=120)
        st = make_project(
            tmp_path,
            f"""
            set_length(0.25);
            load_midi_floww("m", "{tmp_path}/m.mid");
            load_lv2("comp", "http://calf.sourceforge.net/plugins/Compressor");
            add_debug_sine("s", 0.5, 0.0, "m");
            add_lv2fx("fx", 1.0, 0.0, 1.0, "comp");
            connect("s", "fx");
            set_output("fx");
            """, device,
        )
        st.refresh()
        assert st.loaded
        cg = st.compiled
        p1 = cg._pack_fx()
        ver1 = cg._fx_version
        ptr = cg._fx_vec.data_ptr()
        p2 = cg._pack_fx()
        assert p2 is p1 and cg._fx_version == ver1  # memo hit, no upload
        (vi,) = p1
        ratio_before = float(p1[vi]["ratio"])
        cg.plugin_host.set_value("comp", "Ratio", 9.5)
        p3 = cg._pack_fx()
        assert cg._fx_version != ver1  # re-packed
        assert p3 is p1 and set(p3[vi]) == set(p1[vi])  # layout is static
        assert cg._fx_vec.data_ptr() == ptr  # the same device vector
        assert ratio_before != 9.5
        assert float(p3[vi]["ratio"]) == 9.5

    def test_eq3_crossover_moves_with_parameter(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestSampSynAndFx::
        test_eq3_crossover_moves_with_parameter. `parameter("eq", "low
        freq", x)` must move the eq3 crossover (static fx param bound at
        refresh)."""

        def render_rms(d, low_freq_line):
            d.mkdir()
            tone_wav(d / "tone.wav", freq=600.0, dur=0.5)
            out = d / "out.wav"
            st = make_project(
                d,
                f"""
                set_length(0.5);
                set_output_file("{out}");
                load_sample("tone", "{d}/tone.wav", "");
                load_lv2("eq", "native:eq3");
                parameter("eq", "low gain", -40.0);
                {low_freq_line}
                add_sampleloop("loop", 1.0, 0.0, "tone");
                add_lv2fx("fx", 1.0, 0.0, 1.0, "eq");
                connect("loop", "fx");
                set_output("fx");
                """, device,
            )
            st.refresh()
            assert st.loaded
            with launched(device, "eq3"):
                st.render()
            audio, _ = read_wav(out, scale=True)
            half = len(audio) // 2
            return float(np.sqrt(np.mean(audio[half:, 0] ** 2)))

        # default low_freq=250: the 600 Hz tone sits in the mid band, kept
        rms_default = render_rms(tmp_path / "a", "")
        # moved crossover 1600: the tone falls into the -40 dB low band
        rms_moved = render_rms(
            tmp_path / "b", 'parameter("eq", "low freq", 1600.0);'
        )
        assert rms_moved < rms_default * 0.1

    def test_bad_wavetable_falls_back(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestSampSynAndFx::
        test_bad_wavetable_falls_back."""
        write_midi(tmp_path / "m.mid", [(0.02, 0.1, 60, 100)], bpm=120)
        (tmp_path / "bad.wt").write_bytes(b"not a wavetable")
        out = tmp_path / "out.wav"
        st = make_project(
            tmp_path,
            f"""
            set_length(0.25);
            set_output_file("{out}");
            load_midi_floww("m", "{tmp_path}/m.mid");
            load_resource("tbl", "{tmp_path}/bad.wt");
            add_sampsyn("syn", 0.8, 0.0, "m", {{}}, "tbl");
            set_output("syn");
            """, device,
        )
        st.refresh()
        assert st.loaded  # default table fallback


class TestRefreshDiff:
    def test_hot_reload_keeps_unchanged_samples(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestRefreshDiff::
        test_hot_reload_keeps_unchanged_samples."""
        tone_wav(tmp_path / "a.wav")
        tone_wav(tmp_path / "b.wav", freq=300.0)
        src1 = f"""
            set_length(0.25);
            load_sample("a", "{tmp_path}/a.wav", "");
            add_sampleloop("l", 1.0, 0.0, "a");
            set_output("l");
        """
        st = make_project(tmp_path, src1, device)
        st.refresh()
        assert st.loaded
        sample_obj = st.sb.get_sample(st.sb.get_index("a"))
        # change the script: add a second sample, keep "a"
        (tmp_path / "project.lua").write_text(
            f"""
            set_length(0.25);
            load_sample("a", "{tmp_path}/a.wav", "");
            load_sample("b", "{tmp_path}/b.wav", "");
            add_sampleloop("l", 1.0, 0.0, "b");
            set_output("l");
            """
        )
        st.refresh()
        assert st.loaded
        # "a" was not reloaded (same object identity)
        assert st.sb.get_sample(st.sb.get_index("a")) is sample_obj
        assert st.sb.get_index("b") is not None

    def test_failed_resource_aborts_refresh(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestRefreshDiff::
        test_failed_resource_aborts_refresh."""
        st = make_project(
            tmp_path,
            """
            load_sample("ghost", "/nonexistent.wav", "");
            add_sampleloop("l", 1.0, 0.0, "ghost");
            set_output("l");
            """, device,
        )
        st.refresh()
        assert not st.loaded

    def test_lua_error_aborts(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestRefreshDiff::
        test_lua_error_aborts."""
        st = make_project(tmp_path, "this is not lua ===", device)
        st.refresh()
        assert not st.loaded

    def test_missing_output_fails_check(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestRefreshDiff::
        test_missing_output_fails_check."""
        tone_wav(tmp_path / "a.wav")
        st = make_project(
            tmp_path,
            f"""
            load_sample("a", "{tmp_path}/a.wav", "");
            add_sampleloop("l", 1.0, 0.0, "a");
            set_output("nope");
            """, device,
        )
        st.refresh()
        assert not st.loaded


def test_render_chunk_blocks_divisor_selection():
    """Mirror of tests/test_engine.py::
    test_render_chunk_blocks_divisor_selection. Equal-size chunks picked
    whenever a divisor in [256, 512] exists; ragged fallback otherwise."""
    from termdaw_tpu_torch.engine.state import (
        RENDER_WINDOW_BLOCKS, render_chunk_blocks,
    )

    assert render_chunk_blocks(1875) == 375       # 5 equal chunks
    assert render_chunk_blocks(1024) == 512
    assert render_chunk_blocks(512) == 512
    assert render_chunk_blocks(300) == 300        # cs itself in range
    assert render_chunk_blocks(941) == RENDER_WINDOW_BLOCKS  # prime: ragged
    assert render_chunk_blocks(1) == RENDER_WINDOW_BLOCKS    # tiny: one call
    for cs in (1875, 2048, 3000, 941, 37):
        step = render_chunk_blocks(cs)
        # chunk loop must terminate and cover exactly cs blocks
        left, total = cs, 0
        while left > 0:
            nb = min(left, step)
            total += nb
            left -= nb
        assert total == cs


class TestExactBiquadScoping:
    """The exact-biquad lane is fixed per graph (read at refresh), so
    graphs built with different TERMDAW_EXACT_BIQUAD values render
    concurrently without running under each other's setting. The exact
    lane and the pole cascade differ by ~3e-5, so a leaked setting shows
    as a bit-level mismatch against the isolated render. On the card both
    threads capture their first window at once: the exact graph's
    program holds csrc/biquad_seq.cu, the cascade's csrc/eq3.cu."""

    LUA = """
        set_length(0.25);
        set_output_file("{out}");
        load_sample("tone", "{d}/tone.wav", "");
        load_lv2("eq", "native:eq3");
        parameter("eq", "low gain", 5.0);
        add_sampleloop("loop", 1.0, 0.0, "tone");
        add_lv2fx("fx", 1.0, 0.0, 1.0, "eq");
        connect("loop", "fx");
        set_output("fx");
    """

    def _build(self, d, exact, monkeypatch, device):
        d.mkdir(exist_ok=True)
        tone_wav(d / "tone.wav", freq=800.0, dur=0.1)
        monkeypatch.setenv("TERMDAW_EXACT_BIQUAD", "1" if exact else "0")
        st = make_project(
            d, self.LUA.format(out=d / "o.wav", d=d), device,
        )
        st.refresh()
        assert st.loaded
        assert st.compiled.exact_biquad is exact
        return st

    @staticmethod
    def _render(st):
        st.compiled.set_time(0)
        st.fb.set_time(0)
        out = host(st.compiled.render_window(st.fb, 4))
        st.compiled.set_time(0)
        st.fb.set_time(0)
        return out

    @staticmethod
    def _kernels(st):
        (p,) = captured_programs(st.compiled)
        return set(p.kernels)

    def test_concurrent_graphs_do_not_cross_contaminate(
        self, tmp_path, monkeypatch, device
    ):
        """Mirror of tests/test_engine.py::TestExactBiquadScoping::
        test_concurrent_graphs_do_not_cross_contaminate."""
        # reference outputs: FIRST render of a fresh graph per setting
        # (fx state carries across renders, so only first renders of
        # identically built graphs are comparable bit-for-bit)
        with launched(device, "biquad_seq", "eq3"):
            st_a = self._build(tmp_path / "a", True, monkeypatch, device)
            st_b = self._build(tmp_path / "b", False, monkeypatch, device)
            ref_exact = self._render(st_a)
            ref_casc = self._render(st_b)
        # the two strategies genuinely differ (else this test proves nothing)
        assert not np.array_equal(ref_exact, ref_casc)
        on_card = device.type == "cuda"
        if on_card:
            assert self._kernels(st_a) == {"biquad_seq"}
            assert self._kernels(st_b) == {"eq3"}

        for rnd in range(2):
            st_exact = self._build(
                tmp_path / f"a{rnd}", True, monkeypatch, device
            )
            st_casc = self._build(
                tmp_path / f"b{rnd}", False, monkeypatch, device
            )
            # both graphs make their programs under thread contention:
            # clear the shared program cache, then race the first renders
            gc._PROGRAM_CACHE.clear()
            results: dict = {}
            errors: list = []
            barrier = threading.Barrier(2)

            def run(tag, st):
                try:
                    barrier.wait()
                    results[tag] = self._render(st)
                except BaseException as e:  # reraised below
                    errors.append(e)

            threads = [
                threading.Thread(target=run, args=("exact", st_exact)),
                threading.Thread(target=run, args=("casc", st_casc)),
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            assert not any(t.is_alive() for t in threads)
            if errors:
                raise errors[0]
            np.testing.assert_array_equal(results["exact"], ref_exact)
            np.testing.assert_array_equal(results["casc"], ref_casc)
            if on_card:
                assert self._kernels(st_exact) == {"biquad_seq"}
                assert self._kernels(st_casc) == {"eq3"}


class TestLuaCoroutineProjectScripts:
    """The registered DAW API must work when called from a coroutine's
    handoff thread (lua/coroutines.py): declarations append to the same
    refresh-scoped lists regardless of which Python thread the Lua frame
    runs on."""

    def test_api_calls_from_inside_a_coroutine(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestLuaCoroutineProjectScripts::
        test_api_calls_from_inside_a_coroutine."""
        tone_wav(tmp_path / "tone.wav", freq=200.0, dur=0.1)
        out = tmp_path / "out.wav"
        st = make_project(
            tmp_path,
            f"""
            set_length(0.25);
            set_render_samplerate({SR});
            set_output_file("{out}");
            -- build the whole graph from a coroutine: each resume
            -- declares one track, driven by a goto loop
            local build = coroutine.create(function()
              load_sample("tone", "{tmp_path}/tone.wav", "");
              local i = 0
              ::more::
              coroutine.yield()
              add_sampleloop("lp" .. i, 0.5, 0.0, "tone");
              connect("lp" .. i, "sum");
              i = i + 1
              if i < 3 then goto more end
            end)
            coroutine.resume(build)
            add_normalize("sum", 1.0, 0.0);
            set_output("sum");
            while coroutine.status(build) ~= "dead" do
              assert(coroutine.resume(build))
            end
            """, device,
        )
        st.refresh()
        assert st.loaded
        assert sorted(v.name for v in st.g.vertices) == [
            "lp0", "lp1", "lp2", "sum"
        ]
        with launched(device):
            st.render()
        got, _ = read_wav(out, scale=False)
        assert got.shape[0] == int(np.ceil(SR * 0.25 / BL)) * BL
        assert np.abs(got).max() > 1000  # real audio from all three loops


class TestInlineFlowwDeclaration:
    """declare_floww: the Lua-declared pattern extension must be
    indistinguishable from the same notes arriving through the MIDI path
    (same (ch, t, note, vel) float32 rows -> same bake -> same PCM)."""

    NOTES = [  # (start, dur, note, vel) on the 1/960 s tick grid
        (0.05, 0.10, 40, 100),
        (0.30, 0.10, 52, 80),
        (0.55, 0.10, 45, 127),
    ]

    def _project(self, tmp_path, floww_lua, device):
        tone_wav(tmp_path / "tone.wav", freq=300.0, dur=0.12)
        out = tmp_path / "out.wav"
        st = make_project(
            tmp_path,
            f"""
            set_length(1.0);
            set_render_samplerate({SR});
            set_output_file("{out}");
            load_sample("tone", "{tmp_path}/tone.wav", "");
            {floww_lua}
            add_sample_multi("v", 1.0, 0.0, "tone", "pat", -1);
            add_normalize("sum", 1.0, 0.0);
            connect("v", "sum");
            set_output("sum");
            """, device,
        )
        st.refresh()
        assert st.loaded
        with launched(device, "voice_mix"):
            st.render()
        got, _ = read_wav(out, scale=False)
        return got

    def test_matches_the_midi_path_bit_exactly(self, tmp_path, device):
        """Mirror of tests/test_engine.py::TestInlineFlowwDeclaration::
        test_matches_the_midi_path_bit_exactly."""
        mdir = tmp_path / "midi"
        ldir = tmp_path / "lua"
        mdir.mkdir()
        ldir.mkdir()
        write_midi(mdir / "pat.mid", self.NOTES, bpm=120)
        via_midi = self._project(
            mdir, f'load_midi_floww("pat", "{mdir}/pat.mid");', device
        )
        rows = []
        for start, dur, note, vel in self.NOTES:
            rows.append(f"{{ {start}, {note}, {vel}/127.0 }}")
            rows.append(f"{{ {start + dur}, {note}, 0.0 }}")
        via_lua = self._project(
            ldir, f'declare_floww("pat", {{ {", ".join(rows)} }});', device
        )
        np.testing.assert_array_equal(via_midi, via_lua)
        assert np.abs(via_midi).max() > 1000  # the pattern actually plays
