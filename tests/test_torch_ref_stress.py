"""The port held to the reference's stress suite (tests/test_stress.py):
a many-track streaming mix with import resampling, the demo project's
pinned render statistics, and 30 feed/render cycles that keep chain
memory bounded, through termdaw_tpu_torch with the same projects, seeds
and bounds.

The reference marks the whole module slow (its demo render takes minutes
on the CPU); the port's cases run in seconds, so these mirrors are not
marked. Every case runs on the device of its parameter
(tests/torch_ref.py): `cpu` here, `cuda` on the card, where it also
asserts which hand-written kernels launched and, in the churn, that a
program is captured only in the first cycle or where the bake caps grew,
and that the card's reserved memory over cycles 11-30 stays at or under
its most over cycles 1-10 plus what later captures added. Imports nothing of JAX or termdaw_tpu:

    python -m pytest tests/test_torch_ref_stress.py -m cuda -q
"""

import numpy as np
import torch

from termdaw_tpu_torch.config import Config
from termdaw_tpu_torch.engine.state import State
from termdaw_tpu_torch.fileio.midi import write_midi
from termdaw_tpu_torch.fileio.packets import PacketDecoder, encode_events
from termdaw_tpu_torch.fileio.wav import read_wav, write_wav
from termdaw_tpu_torch.utils.fixtures import drum, load_state, write_c4_project

from .torch_ref import captured_programs, device, host, launched  # noqa: F401


class TestManyTrackStream:
    def test_16_track_stream_mix(self, tmp_path, device):
        """Mirror of tests/test_stress.py::TestManyTrackStream::
        test_16_track_stream_mix."""
        sr, bl = 16000, 256
        n_tracks = 12
        # one 32k-rate sample -> import-resamples to 16k
        t = np.arange(int(32000 * 0.05)) / 32000
        hit = (np.exp(-t * 80) * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
        write_wav(tmp_path / "hit.wav", np.stack([hit, hit], 1), 32000,
                  bits=16)

        lines = [
            "set_length(0.75);",
            "set_render_samplerate(16000);",
            "set_render_bitdepth(32);",
            f'set_output_file("{tmp_path}/mix.wav");',
            f'load_sample("hit", "{tmp_path}/hit.wav", "");',
            'add_normalize("sum", 1.0, 0.0);',
        ]
        for i in range(n_tracks):
            angle = (i / n_tracks) * 180.0 - 90.0
            lines += [
                f'declare_stream("s{i}");',
                f'add_sample_multi("t{i}", 1.0, {angle}, "hit", "s{i}", -1);',
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

        # feed each track a burst of hits via the packet protocol
        rng = np.random.default_rng(7)
        blob = b""
        for i in range(n_tracks):
            times = np.sort(rng.uniform(0.0, 0.7, size=8)).astype(np.float32)
            ev = np.stack(
                [np.zeros(8, np.float32), times,
                 np.full(8, 36.0, np.float32),
                 rng.uniform(0.5, 1.0, 8).astype(np.float32)], axis=1,
            )
            blob += encode_events(f"s{i}", ev)
        pkts = PacketDecoder().feed(blob)
        msgs = st.fb.append_streams(pkts)
        assert msgs == []
        with launched(device, "voice_mix"):
            st.render()

        audio, spec = read_wav(tmp_path / "mix.wav", scale=True)
        assert spec.bits_per_sample == 32
        assert audio.shape[0] == st.cs * bl
        assert not np.any(np.isnan(audio))
        assert 0.5 < np.max(np.abs(audio)) <= 1.0 + 1e-6  # normalized mix
        # stereo spread: channels must differ (tracks panned across field)
        assert np.max(np.abs(audio[:, 0] - audio[:, 1])) > 0.05


class TestGoldenStats:
    def test_demo_project_statistics_pinned(self, tmp_path, device):
        """Mirror of tests/test_stress.py::TestGoldenStats::
        test_demo_project_statistics_pinned. Regression pin for the full
        demo graph (every vertex kind + fx): statistics stable across
        backends and float reordering but sensitive to semantic
        regressions (envelope gating, mixing, filter response,
        normalization). The reference's build_demo_project(include_fx=
        True) is the port's write_c4_project (the same files byte for
        byte) + load_state."""
        write_c4_project(tmp_path, 2.0, 8000, 256)
        st = load_state(tmp_path, device)
        assert st.loaded
        with launched(device, "voice_mix", "affine_scan", "max_decay_scan",
                      "eq3", "sampsyn", "synth"):
            st.scan_exact()
            st.render()
        audio, spec = read_wav(st._resolve(st.output_file), scale=True)
        assert spec.sample_rate == 44100  # render sr from the fixture
        peak = float(np.max(np.abs(audio)))
        rms = float(np.sqrt(np.mean(audio**2)))
        # spectral split (filter + mix balance); psr < render_sr means no
        # resample happens — chunks are written unchanged under the
        # declared higher rate (reference state.rs:562-574)
        n = audio.shape[0]
        spec_l = np.abs(np.fft.rfft(audio[:, 0]))
        freqs = np.fft.rfftfreq(n, 1 / spec.sample_rate)
        low = float(np.sum(spec_l[freqs < 1000.0]))
        high = float(np.sum(spec_l[freqs >= 1000.0]))
        ratio = low / max(high, 1e-9)

        # the reference's pins (its first verified CPU render of the 2 s
        # song: peak 1.0, rms ~0.15, low/high ratio ~0.86)
        assert 0.9 <= peak <= 1.001, peak
        assert 0.05 <= rms <= 0.35, rms
        assert 0.4 <= ratio <= 2.0, ratio
        assert not np.any(np.isnan(audio))


class TestChainChurn:
    def test_feed_render_cycles_keep_chain_memory_bounded(
            self, tmp_path, monkeypatch, device):
        """Mirror of tests/test_stress.py::TestChainChurn::
        test_feed_render_cycles_keep_chain_memory_bounded. A generative
        session alternating stream feeds and renders churns the prebaked
        and recorded chains (every feed bumps the content version, every
        stateful render records): the byte budget and the stale-bank
        purge keep chain memory bounded across 30 cycles, with every
        render finite. A program is made (on the card: captured) in the
        first cycle and then only in a cycle where the bake caps grew (a
        new layout: at cycle 13 two live events share a block, and the
        reference makes its second program there too). On the card the
        reserved memory over cycles 11-30 stays at or under its most over
        cycles 1-10, plus what the captures of cycles 11-30 added."""
        monkeypatch.setenv("TERMDAW_MESH", "0")
        d = tmp_path / "churn"
        d.mkdir()
        drum(d / "hit.wav", 8000, 0.05, 300.0, 30.0)
        write_midi(d / "hits.mid", [(0.2, 0.1, 36, 100)], bpm=120)
        (d / "project.lua").write_text(f"""
set_length(2.0);
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
        st = State(Config.read(d / "project.toml"), str(d), device=device)
        st.refresh()
        assert st.loaded
        cg = st.compiled
        on_card = device.type == "cuda"
        rng = np.random.default_rng(17)
        reserved, growths = [], 0
        with launched(device, "voice_mix"):
            for cycle in range(30):
                ev = np.array(
                    [[0.0, float(rng.uniform(0.1, 1.8)), 36.0, 0.8]],
                    np.float32,
                )
                st.fb.append_streams(PacketDecoder().feed(
                    encode_events("live", ev)
                ))
                st.fb.set_time(st.compiled.get_time())
                caps = {k: dict(v) for k, v in cg.bake_caps.items()}
                captures = cg.captures
                chunks = st.render_device()
                assert all(np.all(np.isfinite(host(c))) for c in chunks)
                st.compiled.set_time(0)
                assert len(cg._recorded) <= cg._REC_MAX
                assert cg._prebake_used <= cg._prebake_budget
                if cycle == 0:
                    assert cg.captures == 1
                    first = captured_programs(cg)
                elif cg.captures != captures:
                    assert cg.bake_caps != caps, \
                        f"cycle {cycle} made a program with the same caps"
                    growths += 1
                if cycle == 9:
                    made_by_10 = captured_programs(cg)
                if on_card:
                    torch.cuda.synchronize()
                    reserved.append(torch.cuda.memory_reserved(device))
        # the seed-chain memo must not have grown one entry per feed's
        # worth of stored windows beyond the budget either
        assert cg._prebake_used >= 0
        progs = captured_programs(cg)
        assert first[0] in progs
        assert cg.captures == len(progs) == 1 + growths <= 2
        if on_card:
            late = sum(p.pool_bytes for p in progs if p not in made_by_10)
            assert max(reserved[10:]) <= max(reserved[:10]) + late, reserved
