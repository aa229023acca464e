"""The port held to the reference's workflow suite
(tests/test_workflows.py): scripted stdin drives the UI and stream loops,
the Player's pacing, the sinks, the CLI and the palette, through
termdaw_tpu_torch, with the same scripts, shapes and bounds.

Every case that plays, renders or streams runs on the device of its
parameter (tests/torch_ref.py): `cpu` here, `cuda` on the card, where it
also asserts which hand-written kernels launched. Refresh during playback
is the port's known deviation 9 (ROADMAP.md §3), asserted as its own
contract: the refresh drops the replaced graph's programs and memory
pool, and the new graph makes its own. Imports nothing of JAX or
termdaw_tpu:

    python -m pytest tests/test_torch_ref_workflows.py -m cuda -q
"""

import io
import time
import weakref

import numpy as np
import pytest

from termdaw_tpu_torch.config import Config
from termdaw_tpu_torch.engine.player import Player
from termdaw_tpu_torch.engine.sink import FileSink, NullSink, make_sink
from termdaw_tpu_torch.engine.state import State
from termdaw_tpu_torch.fileio.packets import encode_events, encode_text
from termdaw_tpu_torch.fileio.wav import read_wav, write_wav
from termdaw_tpu_torch.graph import compile as C
from termdaw_tpu_torch.workflows.stream import run_stream_workflow
from termdaw_tpu_torch.workflows.ui import match_command, run_ui_workflow

from .torch_ref import (  # noqa: F401
    captured_programs, device, launched, pool_segment_bytes,
)

SR = 8000
BL = 256


def make_state(tmp_path, lua_src, device):
    (tmp_path / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = {BL}\n'
        f"project_samplerate = {SR}\n"
    )
    (tmp_path / "project.lua").write_text(lua_src)
    st = State(Config.read(tmp_path / "project.toml"), str(tmp_path),
               device=device)
    st.refresh()
    return st


def tone_project(tmp_path, out, device):
    t = np.arange(SR // 4) / SR
    x = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    write_wav(tmp_path / "tone.wav", np.stack([x, x], 1), SR, bits=16)
    return make_state(
        tmp_path,
        f"""
        set_length(0.5);
        set_output_file("{out}");
        load_sample("tone", "{tmp_path}/tone.wav", "");
        add_sampleloop("loop", 1.0, 0.0, "tone");
        add_normalize("sum", 1.0, 0.0);
        connect("loop", "sum");
        set_output("sum");
        """, device,
    )


class FiniteSink(NullSink):
    """A NullSink that checks every queued buffer is finite."""

    def queue_audio(self, interleaved: np.ndarray) -> None:
        assert np.all(np.isfinite(interleaved)), "non-finite audio queued"
        super().queue_audio(interleaved)


class TestCommandMatching:
    def test_exact_prefix_substring(self):
        """Mirror of tests/test_workflows.py::TestCommandMatching::
        test_exact_prefix_substring."""
        assert match_command("render") == "render"
        assert match_command("ren") == "render"
        assert match_command("q") == "quit"
        assert match_command("norm-") == "norm-vals"
        assert match_command("skip") == ">skip"  # unique substring
        assert match_command("zzz") is None
        assert match_command("") is None
        # ambiguous prefixes resolve to None
        assert match_command("p") is None  # play/pause/prev…


class TestUiWorkflow:
    def test_scripted_session(self, tmp_path, capsys, device):
        """Mirror of tests/test_workflows.py::TestUiWorkflow::
        test_scripted_session."""
        out = tmp_path / "out.wav"
        st = tone_project(tmp_path, out, device)
        assert st.loaded
        cmds = io.StringIO(
            "get\nset 0.25\nget\nnormalize\nnorm-vals\nrender\nquit\n"
        )
        with launched(device):
            run_ui_workflow(SR, BL, st, NullSink(SR), input_stream=cmds)
        captured = capsys.readouterr().out
        assert "Frame: 0" in captured
        assert f"Frame: {int(0.25 * SR)}" in captured
        assert "sum:" in captured  # norm-vals output
        assert out.exists()
        audio, spec = read_wav(out)
        assert spec.sample_rate == 48000  # default render sr
        assert len(audio) > 0
        assert captured_programs(st.compiled)

    def test_unknown_command(self, tmp_path, capsys, device):
        """Mirror of tests/test_workflows.py::TestUiWorkflow::
        test_unknown_command."""
        st = tone_project(tmp_path, tmp_path / "o.wav", device)
        cmds = io.StringIO("frobnicate\nquit\n")
        run_ui_workflow(SR, BL, st, NullSink(SR), input_stream=cmds)
        assert "command not found" in capsys.readouterr().out

    def test_not_loaded_gating(self, tmp_path, capsys, device):
        """Mirror of tests/test_workflows.py::TestUiWorkflow::
        test_not_loaded_gating."""
        st = make_state(tmp_path, "x = 1 +", device)  # refresh fails
        assert not st.loaded
        cmds = io.StringIO("render\nplay\nquit\n")
        run_ui_workflow(SR, BL, st, NullSink(SR), input_stream=cmds)
        assert "State not loaded!" in capsys.readouterr().out

    def test_play_produces_audio(self, tmp_path, device):
        """Mirror of tests/test_workflows.py::TestUiWorkflow::
        test_play_produces_audio."""
        st = tone_project(tmp_path, tmp_path / "o.wav", device)
        sink = FiniteSink(SR)
        with launched(device):
            p = Player(st, sink, SR, BL)
            p.play()
            p.since = time.monotonic() - 0.1  # pretend 100ms elapsed
            p.tick()
        # 0.1s at 8000Hz / 256-frame blocks -> at least 3 blocks queued
        assert sink.frames_queued >= 3 * BL
        assert st.compiled.get_time() == sink.frames_queued
        assert captured_programs(st.compiled)

    def test_set_prompt_form(self, tmp_path, capsys, device):
        """Mirror of tests/test_workflows.py::TestUiWorkflow::
        test_set_prompt_form. 'set' with the time on the NEXT line (the
        reference's prompt form): the reader thread owns the piped stream,
        so the engine must take the time from the command queue."""
        out = tmp_path / "out.wav"
        st = tone_project(tmp_path, out, device)
        cmds = io.StringIO("set\n0.25\nget\nquit\n")
        run_ui_workflow(SR, BL, st, NullSink(SR), input_stream=cmds)
        captured = capsys.readouterr().out
        assert f"Frame: {int(0.25 * SR)}" in captured
        assert "command not found" not in captured

    def test_seek_restores_lead(self, tmp_path, device):
        """Mirror of tests/test_workflows.py::TestUiWorkflow::
        test_seek_restores_lead. seek() clears the sink queue; while
        playing it must re-queue the prebuffer and restart the pacing
        epoch."""
        st = tone_project(tmp_path, tmp_path / "o.wav", device)
        sink = FiniteSink(SR)
        p = Player(st, sink, SR, BL)
        with launched(device):
            p.play()
            p.seek(4 * BL)
        # clear() empties the (Null)sink queue; seek must refill it with
        # exactly the prebuffer lead and restart the pacing clock
        assert sink.frames_queued == p.PREBUFFER_BLOCKS * BL
        assert p.millis_generated == pytest.approx(
            p.PREBUFFER_BLOCKS * BL / SR * 1e3
        )
        # when stopped, seek must NOT render anything
        p.stop()
        p.seek(0)
        assert sink.frames_queued == 0

    def test_tick_maintains_lead(self, tmp_path, device):
        """Mirror of tests/test_workflows.py::TestUiWorkflow::
        test_tick_maintains_lead. tick() keeps LEAD_BLOCKS of generated
        audio ahead of the wall clock, so a dispatch spike eats queued
        margin instead of starving the sink."""
        st = tone_project(tmp_path, tmp_path / "o.wav", device)
        p = Player(st, FiniteSink(SR), SR, BL)
        block_ms = BL / SR * 1000.0
        lead_ms = p.LEAD_BLOCKS * block_ms
        with launched(device):
            p.play()
            p.since = time.monotonic() - 0.5  # pretend 500ms elapsed
            p.tick()
        elapsed_ms = (time.monotonic() - p.since) * 1000.0
        # generated must sit a full lead (minus sub-block slack) ahead
        assert p.millis_generated - elapsed_ms >= lead_ms - 2 * block_ms
        # and pacing must not run away: at most one catch-up window over
        assert p.millis_generated - elapsed_ms <= lead_ms + 32 * block_ms

    def test_refresh_during_playback_and_cache_reuse(self, tmp_path, device):
        """Mirror of tests/test_workflows.py::TestUiWorkflow::
        test_refresh_during_playback_and_cache_reuse. A mid-play `refresh`
        with a topology change stops the device and rebuilds, then `play`
        restarts pacing: the rebuilt graph plays at once, with finite
        audio. Where the reference then reuses a prior topology's compiled
        programs across the refresh, the port keeps known deviation 9: the
        refresh drops the replaced graph's programs and its memory pool,
        and the new graph makes (on the card: captures) its own."""
        t = np.arange(SR // 4) / SR
        x = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        write_wav(tmp_path / "tone.wav", np.stack([x, x], 1), SR, bits=16)

        def lua_src(n_loops):
            lines = [
                "set_length(2.0);",
                f'set_output_file("{tmp_path}/o.wav");',
                f'load_sample("tone", "{tmp_path}/tone.wav", "");',
                'add_normalize("sum", 1.0, 0.0);',
            ]
            for i in range(n_loops):
                lines += [
                    f'add_sampleloop("l{i}", {1.0 / (i + 1):.3f}, 0.0, '
                    '"tone");',
                    f'connect("l{i}", "sum");',
                ]
            lines.append('set_output("sum");')
            return "\n".join(lines)

        (tmp_path / "project.toml").write_text(
            f'[settings]\nmain = "project.lua"\nbuffer_length = {BL}\n'
            f"project_samplerate = {SR}\n"
        )
        (tmp_path / "project.lua").write_text(lua_src(1))
        st = State(Config.read(tmp_path / "project.toml"), str(tmp_path),
                   device=device)
        st.refresh()
        assert st.loaded
        sink = FiniteSink(SR)
        p = Player(st, sink, SR, BL)

        def play_a_bit():
            p.play()
            for _ in range(6):
                p.tick()
                time.sleep(0.002)
            assert p.millis_generated > 0
            assert sink.frames_queued >= Player.PREBUFFER_BLOCKS * BL

        def refresh_mid_play(src):
            # the ui.py 'refresh' sequence, run while playing
            # (reference ui_workflow.rs:114-119 order)
            old = st.compiled
            progs = [weakref.ref(q) for q in captured_programs(old)]
            assert progs
            pool = old._graph_pool
            (tmp_path / "project.lua").write_text(src)
            st.refresh()
            p.playing = False
            sink.clear()
            sink.pause()
            assert st.loaded
            # deviation 9: the replaced graph's programs and pool are gone
            assert st.compiled is not old
            assert old.programs() == [] and old._graph_pool is None
            assert old.pool_bytes == 0
            assert all(r() is None for r in progs)
            if device.type == "cuda":
                assert pool is not None
                assert pool_segment_bytes(pool) == 0
            return old

        with launched(device, "vertex_post"):
            play_a_bit()
            g1 = refresh_mid_play(lua_src(2))  # topology change
            play_a_bit()                       # rebuilt graph plays at once
            g2 = refresh_mid_play(lua_src(1))  # back to the first topology
            play_a_bit()
        g3 = st.compiled
        assert g3 not in (g1, g2)
        # the cache holds none of the replaced graphs' programs: the new
        # graph made its own
        assert g3.captures == len(captured_programs(g3)) >= 1
        assert not any(q.cg in (g1, g2) for q in C._PROGRAM_CACHE.values())


class TestStreamWorkflow:
    def test_stream_events_render(self, tmp_path, device):
        """Mirror of tests/test_workflows.py::TestStreamWorkflow::
        test_stream_events_render."""
        t = np.arange(SR // 8) / SR
        x = (np.exp(-t * 60) * np.sin(2 * np.pi * 80 * t)).astype(np.float32)
        write_wav(tmp_path / "kick.wav", np.stack([x, x], 1), SR, bits=16)
        st = make_state(
            tmp_path,
            f"""
            load_sample("kick", "{tmp_path}/kick.wav", "");
            declare_stream("drums");
            add_sample_multi("hits", 1.0, 0.0, "kick", "drums", -1);
            set_output("hits");
            """, device,
        )
        assert st.loaded
        events = np.asarray(
            [[0.0, 0.05, 36.0, 0.9], [0.0, 0.2, 38.0, 0.8]], np.float32
        )
        blob = encode_events("drums", events) + encode_text("hello-stream")
        sink = FiniteSink(SR)
        with launched(device, "voice_mix"):
            run_stream_workflow(
                SR, BL, st, sink, input_stream=io.BytesIO(blob),
                max_idle_s=0.5
            )
        # events were appended into the declared stream
        idx = st.fb.get_index("drums")
        assert idx is not None
        assert sink.frames_queued > 0
        assert captured_programs(st.compiled)

    def test_decode_error_stops(self, tmp_path, capsys, device):
        """Mirror of tests/test_workflows.py::TestStreamWorkflow::
        test_decode_error_stops."""
        st = make_state(
            tmp_path,
            """
            declare_stream("s");
            add_debug_sine("v", 1.0, 0.0, "s");
            set_output("v");
            """, device,
        )
        bad = bytes([0xFF, 1, 2, 3])
        run_stream_workflow(
            SR, BL, st, NullSink(SR), input_stream=io.BytesIO(bad),
            max_idle_s=0.2,
        )
        assert "could not decode" in capsys.readouterr().out


class TestSinks:
    def test_file_sink_roundtrip(self, tmp_path):
        """Mirror of tests/test_workflows.py::TestSinks::
        test_file_sink_roundtrip."""
        p = tmp_path / "pb.wav"
        s = FileSink(SR, str(p))
        data = np.linspace(-0.5, 0.5, 512).astype(np.float32)
        s.queue_audio(data)
        s.close()
        audio, spec = read_wav(p, scale=True)
        assert spec.bits_per_sample == 32
        np.testing.assert_allclose(audio.reshape(-1), data, atol=1e-6)

    def test_make_sink_null(self, tmp_path):
        """Mirror of tests/test_workflows.py::TestSinks::
        test_make_sink_null."""
        assert isinstance(make_sink(SR, "null"), NullSink)
        assert isinstance(make_sink(SR, f"file:{tmp_path}/x.wav"), FileSink)

    def test_make_sink_auto_falls_back_headless(self):
        """Mirror of tests/test_workflows.py::TestSinks::
        test_make_sink_auto_falls_back_headless. `auto` tries ALSA and
        must fall back to null on a headless machine instead of
        raising."""
        s = make_sink(SR, "auto")
        assert isinstance(s, NullSink) or type(s).__name__ == "AlsaSink"


class TestCli:
    def test_cli_headless_render(self, tmp_path, monkeypatch, capsys,
                                 device):
        """Mirror of tests/test_workflows.py::TestCli::
        test_cli_headless_render, with the port's `--device` (its default
        is cuda)."""
        from termdaw_tpu_torch.cli import main

        out = tmp_path / "out.wav"
        tone_project(tmp_path, out, device)  # writes project files
        monkeypatch.setenv("TERMDAW_SINK", "null")
        monkeypatch.setattr("sys.stdin", io.StringIO("render\nquit\n"))
        with launched(device):
            rc = main(["--device", device.type, str(tmp_path)])
        assert rc == 0
        assert out.exists()
        captured = capsys.readouterr().out
        assert "TermDaw: loading" in captured

    def test_cli_missing_project(self, tmp_path, capsys):
        """Mirror of tests/test_workflows.py::TestCli::
        test_cli_missing_project."""
        from termdaw_tpu_torch.cli import main

        rc = main(["--device", "cpu", str(tmp_path / "nope")])
        assert rc == 1


class TestPalette:
    """Arrow-key fuzzy palette (reference ui_workflow.rs:35-45)."""

    def test_fuzzy_rank_ordering(self):
        """Mirror of tests/test_workflows.py::TestPalette::
        test_fuzzy_rank_ordering."""
        from termdaw_tpu_torch.workflows.palette import fuzzy_rank

        assert fuzzy_rank("render", "render") == 0      # exact
        assert fuzzy_rank("re", "render") == 1          # prefix
        assert fuzzy_rank("orm", "normalize") == 2      # substring
        assert fuzzy_rank("nv", "norm-vals") == 4       # subsequence
        assert fuzzy_rank("xyz", "render") is None
        assert fuzzy_rank("", "anything") == 3          # empty matches all

    def test_filter_commands(self):
        """Mirror of tests/test_workflows.py::TestPalette::
        test_filter_commands."""
        from termdaw_tpu_torch.workflows.palette import filter_commands
        from termdaw_tpu_torch.workflows.ui import COMMANDS

        # prefix beats substring beats subsequence; ties keep COMMANDS order
        assert filter_commands(COMMANDS, "p")[:2] == ["play", "pause"]
        assert filter_commands(COMMANDS, "norm")[:2] == [
            "norm-vals", "normalize",
        ] or filter_commands(COMMANDS, "norm")[:2] == [
            "normalize", "norm-vals",
        ]
        assert filter_commands(COMMANDS, "") == COMMANDS
        assert filter_commands(COMMANDS, "zzz") == []

    def test_palette_pty_arrow_select_and_args(self):
        """Mirror of tests/test_workflows.py::TestPalette::
        test_palette_pty_arrow_select_and_args. Drive the palette through
        a real pty: type a filter, arrow down, Enter; then a command with
        args."""
        import os
        import pty
        import threading

        from termdaw_tpu_torch.workflows.palette import Palette
        from termdaw_tpu_torch.workflows.ui import COMMANDS

        master, slave = pty.openpty()
        inp = os.fdopen(os.dup(slave), "r")
        outp = os.fdopen(os.dup(slave), "w")
        pal = Palette(COMMANDS, tty_in=inp, tty_out=outp)
        results = []

        def drive():
            results.append(pal.read_command())   # 1st submit
            results.append(pal.read_command())   # 2nd submit
            results.append(pal.read_command())   # EOF via Ctrl-D

        stop_drain = threading.Event()
        drew = threading.Event()

        def drain():  # keep the pty master from filling and blocking draws
            while not stop_drain.is_set():
                try:
                    if os.read(master, 65536):
                        drew.set()
                except OSError:
                    return

        td = threading.Thread(target=drain, daemon=True)
        td.start()
        t = threading.Thread(target=drive, daemon=True)
        t.start()
        # wait for the first prompt draw: cbreak mode is then active, so
        # keystrokes bypass the canonical line discipline
        assert drew.wait(timeout=10)

        def wait_results(n, timeout=10.0):
            # pace like a human: the next command only after the previous
            # submit was consumed (between read_command calls the TTY
            # briefly returns to canonical mode, where a queued ^D would
            # be eaten by the line discipline)
            end = time.monotonic() + timeout
            while len(results) < n and time.monotonic() < end:
                time.sleep(0.01)
            assert len(results) >= n, results

        # "p" filters to [play, pause, >skip]; Down selects "pause"; Enter
        os.write(master, b"p")
        os.write(master, b"\x1b[B")
        os.write(master, b"\r")
        wait_results(1)
        # "set 12.5" -> submits highlighted cmd + arg words
        os.write(master, b"set 12.5\r")
        wait_results(2)
        os.write(master, b"\x04")  # Ctrl-D on empty -> None
        t.join(timeout=10)
        alive = t.is_alive()
        stop_drain.set()
        assert not alive
        first, second, third = results
        assert first == "pause"  # arrow moved off the top item ("play")
        assert second == "set 12.5"
        assert third is None
        inp.close()
        outp.close()
        os.close(master)
        os.close(slave)
