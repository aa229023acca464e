"""The port against the independent float64 per-frame oracle
(tests/oracle.py): the counterpart of tests/test_oracle_equivalence.py,
with its shapes (4 kHz, 128-frame blocks, 16 blocks), its events, Lua,
`compare` and tolerances, on the CPU and on a CUDA card.

Every case renders with the port's State on the device of its parameter:
`cpu` here, `cuda` on the card (marked `cuda`, skipped without one),
where each case also asserts which hand-written kernels its render
launched through the wrappers' counters: the voice mix
(csrc/voice_mix.cu) for every SampleMulti, the affine scan
(csrc/affine_scan.cu) for the band-pass, no other. The oracle imports
only numpy and shares no code with either package, and this file imports
nothing of JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_oracle.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from termdaw_tpu_torch.config import Config
from termdaw_tpu_torch.engine import state as state_mod
from termdaw_tpu_torch.engine.state import State
from termdaw_tpu_torch.fileio.wav import read_wav, write_wav
from termdaw_tpu_torch.fileio.wavetable import WaveTable, write_wavetable
from termdaw_tpu_torch.graph.compile import _kernel_counts

from . import oracle as O

SR = 4000
BL = 128
N_BLOCKS = 16
LEN_SEC = N_BLOCKS * BL / SR

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(request.param)


def drum_sample(rng, sr, dur=0.06):
    t = np.arange(int(sr * dur)) / sr
    x = (np.exp(-t * 50) * np.sin(2 * np.pi * 120 * t)).astype(np.float32)
    x = 0.9 * x / np.max(np.abs(x))
    return np.stack([x, x], 1)


def random_events(rng, n, t_max, notes=(36, 38, 40), with_offs=True):
    """Sorted note events; ons with matching offs at random gaps."""
    rows = []
    for _ in range(n):
        t_on = rng.uniform(0.0, t_max * 0.8)
        note = float(rng.choice(notes))
        vel = float(rng.uniform(0.3, 1.0))
        rows.append((0.0, t_on, note, vel))
        if with_offs:
            rows.append((0.0, t_on + rng.uniform(0.02, 0.3), note, 0.0))
    rows.sort(key=lambda r: r[1])
    return np.asarray(rows, np.float32)


def build_state(tmp_path, sample, events, lua_body, device):
    write_wav(tmp_path / "smp.wav", sample, SR, bits=32)
    (tmp_path / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = {BL}\n'
        f"project_samplerate = {SR}\n"
    )
    (tmp_path / "project.lua").write_text(
        f"""
set_length({LEN_SEC});
set_render_samplerate({SR});
set_render_bitdepth(32);
set_output_file("{tmp_path}/out.wav");
load_sample("smp", "{tmp_path}/smp.wav", "");
declare_stream("ev");
{lua_body}
"""
    )
    st = State(Config.read(tmp_path / "project.toml"), str(tmp_path),
               device=device)
    st.refresh()
    assert st.loaded
    idx = st.fb.get_index("ev")
    st.fb.flowws[idx] = np.asarray(events, np.float32).reshape(-1, 4)
    return st


def engine_audio(st, kernels=()):
    """Render st and read its WAV back; on the card, `kernels` (names of
    graph.compile._kernel_counts) must have launched and no other."""
    before = _kernel_counts()
    st.render()
    grew = {k for k, v in _kernel_counts().items() if v > before[k]}
    assert grew == (set(kernels) if st.device.type == "cuda" else set())
    audio, _ = read_wav(st.output_file, scale=True)
    return audio


def bank_sample(st):
    """The post-import sample (the bank peak-normalizes on load) — the
    oracle models the graph, not the import, so it consumes what the
    port's bank holds."""
    return st.sb.get_sample(0).as_array().astype(np.float64)


def compare(got, expect, atol):
    assert got.shape == expect.shape
    # apply the port's 32-bit quantization to the oracle: scale by
    # amplitude (2^31 - 1), truncate toward zero, saturate (the reference's
    # `as i32` semantics) — audio overdriven past 1.0 clips in both
    amp = float(2**31 - 1)
    q = np.trunc(np.clip(expect * amp, -(2.0**31), 2147483520.0)) / 2.0**31
    err = np.max(np.abs(got - q))
    assert err < atol, f"engine vs oracle max err {err}"


@pytest.fixture
def sample(rng):
    return drum_sample(rng, SR)


class TestOracleEquivalence:
    def test_sample_multi(self, tmp_path, rng, sample, device):
        ev = random_events(rng, 14, LEN_SEC)
        st = build_state(
            tmp_path, sample, ev,
            'add_sample_multi("v", 1.3, 25.0, "smp", "ev", -1);\n'
            'set_output("v");', device,
        )
        got = engine_audio(st, ["voice_mix", "vertex_post"])
        fl = O.OracleFloww(ev, SR, BL)
        verts = {"v": O.SampleMulti(bank_sample(st), "ev", gain=1.3, angle=25.0)}
        expect = O.oracle_render(verts, [], "v", {"ev": fl}, SR, BL, N_BLOCKS)
        compare(got, expect, 2e-4)

    def test_sample_multi_note_filter(self, tmp_path, rng, sample, device):
        ev = random_events(rng, 14, LEN_SEC)
        st = build_state(
            tmp_path, sample, ev,
            'add_sample_multi("v", 1.0, 0.0, "smp", "ev", 38);\n'
            'set_output("v");', device,
        )
        got = engine_audio(st, ["voice_mix"])
        fl = O.OracleFloww(ev, SR, BL)
        verts = {"v": O.SampleMulti(bank_sample(st), "ev", note=38)}
        expect = O.oracle_render(verts, [], "v", {"ev": fl}, SR, BL, N_BLOCKS)
        compare(got, expect, 2e-4)

    def test_sample_lerp(self, tmp_path, rng, sample, device):
        ev = random_events(rng, 12, LEN_SEC)
        st = build_state(
            tmp_path, sample, ev,
            'add_sample_lerp("v", 1.0, 0.0, "smp", "ev", -1, 33);\n'
            'set_output("v");', device,
        )
        got = engine_audio(st)
        fl = O.OracleFloww(ev, SR, BL)
        verts = {"v": O.SampleLerp(bank_sample(st), "ev", lerp_len=33)}
        expect = O.oracle_render(verts, [], "v", {"ev": fl}, SR, BL, N_BLOCKS)
        compare(got, expect, 2e-4)

    def test_debug_sine(self, tmp_path, rng, sample, device):
        ev = random_events(rng, 8, LEN_SEC)
        st = build_state(
            tmp_path, sample, ev,
            'add_debug_sine("v", 0.4, -40.0, "ev");\nset_output("v");',
            device,
        )
        got = engine_audio(st, ["vertex_post"])
        fl = O.OracleFloww(ev, SR, BL)
        verts = {"v": O.DebugSine("ev", gain=0.4, angle=-40.0)}
        expect = O.oracle_render(verts, [], "v", {"ev": fl}, SR, BL, N_BLOCKS)
        compare(got, expect, 5e-4)

    def test_synth(self, tmp_path, rng, sample, device):
        ev = random_events(rng, 10, LEN_SEC, notes=(48, 52, 55))
        hit = "{0.005, 0.02, 0.3, 0.05, 0.2, 0.1}"
        note = "{0.01, 0.05, 0.8, 0.5, 0.4, 0.15}"
        st = build_state(
            tmp_path, sample, ev,
            f'add_synth("v", 0.7, 0.0, "ev", 0.5, 0.4, {hit}, '
            f'0.8, 0.6, {note}, 0.3, {note});\nset_output("v");', device,
        )
        got = engine_audio(st, ["synth", "vertex_post"])
        fl = O.OracleFloww(ev, SR, BL)
        hit9 = O.hit6([0.005, 0.02, 0.3, 0.05, 0.2, 0.1])
        note9 = O.hit6([0.01, 0.05, 0.8, 0.5, 0.4, 0.15])
        verts = {
            "v": O.Synth(
                "ev", (0.5, 0.4, hit9), (0.8, 0.6, note9), (0.3, 0.0, note9),
                gain=0.7,
            )
        }
        # 2e-3: f32 port vs f64 oracle — sin() at large phase arguments
        # and steep envelope slopes round differently at segment boundaries
        expect = O.oracle_render(verts, [], "v", {"ev": fl}, SR, BL, N_BLOCKS)
        compare(got, expect, 2e-3)

    def test_synth_zero_length_note(self, tmp_path, rng, sample, device):
        """A note whose ON and OFF land in the same frame captures
        rel_t == 0.0 — the reference's held sentinel — so it stays in
        ADS phase with a restarted clock and only a LATER off releases
        it. Exercises the bake's re-held representation across window
        boundaries."""
        ev = np.asarray(
            [
                (0.0, 0.05, 48.0, 0.8),   # on
                (0.0, 0.05, 48.0, 0.0),   # off in the SAME frame
                (0.0, 0.10, 55.0, 0.7),   # unrelated normal note
                (0.0, 0.35, 55.0, 0.0),
                (0.0, 0.60, 48.0, 0.0),   # releases the re-held note
            ],
            np.float32,
        )
        hit = "{0.005, 0.02, 0.3, 0.05, 0.2, 0.1}"
        note = "{0.01, 0.05, 0.8, 0.5, 0.4, 0.15}"
        st = build_state(
            tmp_path, sample, ev,
            f'add_synth("v", 0.7, 0.0, "ev", 0.5, 0.4, {hit}, '
            f'0.8, 0.6, {note}, 0.3, {note});\nset_output("v");', device,
        )
        got = engine_audio(st, ["synth", "vertex_post"])
        fl = O.OracleFloww(ev, SR, BL)
        hit9 = O.hit6([0.005, 0.02, 0.3, 0.05, 0.2, 0.1])
        note9 = O.hit6([0.01, 0.05, 0.8, 0.5, 0.4, 0.15])
        verts = {
            "v": O.Synth(
                "ev", (0.5, 0.4, hit9), (0.8, 0.6, note9), (0.3, 0.0, note9),
                gain=0.7,
            )
        }
        expect = O.oracle_render(verts, [], "v", {"ev": fl}, SR, BL, N_BLOCKS)
        # the re-held note must still be sounding mid-song (it never
        # decays) — guard that the scenario actually triggered
        assert np.max(np.abs(expect[len(expect) // 2:])) > 1e-4
        compare(got, expect, 2e-3)

    @pytest.mark.parametrize("use_off,use_max", [
        (False, True), (False, False), (True, True), (True, False),
    ])
    def test_adsr_modes(self, tmp_path, rng, sample, use_off, use_max,
                        device):
        ev = random_events(rng, 10, LEN_SEC)
        conf6 = [0.01, 0.05, 0.6, 0.1, 0.4, 0.08]
        lua_conf = "{" + ", ".join(str(x) for x in conf6) + "}"
        st = build_state(
            tmp_path, sample, ev,
            'add_sampleloop("l", 1.0, 0.0, "smp");\n'
            f'add_adsr("v", 1.0, 0.0, 0.8, "ev", '
            f'{str(use_off).lower()}, {str(use_max).lower()}, -1, {lua_conf});\n'
            'connect("l", "v");\nset_output("v");', device,
        )
        got = engine_audio(st)
        fl = O.OracleFloww(ev, SR, BL)
        verts = {
            "l": O.SampleLoop(bank_sample(st)),
            "v": O.Adsr("ev", O.hit6(conf6), use_off=use_off,
                        use_max=use_max, wet=0.8),
        }
        expect = O.oracle_render(
            verts, [("l", "v")], "v", {"ev": fl}, SR, BL, N_BLOCKS
        )
        compare(got, expect, 1e-3)

    def test_bandpass_and_normalize_chain(self, tmp_path, rng, sample,
                                          device):
        ev = random_events(rng, 10, LEN_SEC)
        st = build_state(
            tmp_path, sample, ev,
            'add_sample_multi("m", 1.0, 0.0, "smp", "ev", -1);\n'
            'add_bandpass("b", 1.0, 0.0, 1.0, 800, 60, true);\n'
            'add_normalize("n", 1.0, 0.0);\n'
            'connect("m", "b");\nconnect("b", "n");\nset_output("n");',
            device,
        )
        got = engine_audio(st, ["voice_mix", "affine_scan"])
        fl = O.OracleFloww(ev, SR, BL)
        verts = {
            "m": O.SampleMulti(bank_sample(st), "ev"),
            "b": O.BandPass(800.0, 60.0, True, SR, wet=1.0),
            "n": O.Normalize(),
        }
        expect = O.oracle_render(
            verts, [("m", "b"), ("b", "n")], "n", {"ev": fl}, SR, BL,
            N_BLOCKS,
        )
        compare(got, expect, 2e-3)

    def test_full_mix_graph(self, tmp_path, rng, sample, device,
                            monkeypatch):
        """Several vertex kinds mixed through sum -> normalize, rendered
        in small windows (window chaining + oracle together)."""
        ev = random_events(rng, 8, LEN_SEC)
        ev2 = random_events(rng, 6, LEN_SEC, notes=(50, 53))
        st = build_state(
            tmp_path, sample, ev,
            'declare_stream("ev2");\n'
            'add_sample_multi("m", 0.8, 15.0, "smp", "ev", -1);\n'
            'add_sample_lerp("p", 0.7, -15.0, "smp", "ev", -1, 21);\n'
            'add_debug_sine("d", 0.2, 0.0, "ev2");\n'
            'add_sum("s", 1.0, 0.0);\n'
            'add_normalize("n", 1.0, 0.0);\n'
            'connect("m", "s");\nconnect("p", "s");\nconnect("d", "s");\n'
            'connect("s", "n");\nset_output("n");', device,
        )
        idx2 = st.fb.get_index("ev2")
        st.fb.flowws[idx2] = ev2
        # force window chaining
        monkeypatch.setattr(state_mod, "RENDER_WINDOW_BLOCKS", 5)
        got = engine_audio(st, ["voice_mix", "vertex_post"])

        flowws = {
            "ev": O.OracleFloww(ev, SR, BL),
            "ev2": O.OracleFloww(ev2, SR, BL),
        }
        verts = {
            "m": O.SampleMulti(bank_sample(st), "ev", gain=0.8, angle=15.0),
            "p": O.SampleLerp(bank_sample(st), "ev", lerp_len=21, gain=0.7,
                              angle=-15.0),
            "d": O.DebugSine("ev2", gain=0.2),
            "s": O.Sum(),
            "n": O.Normalize(),
        }
        expect = O.oracle_render(
            verts, [("m", "s"), ("p", "s"), ("d", "s"), ("s", "n")], "n",
            flowws, SR, BL, N_BLOCKS,
        )
        compare(got, expect, 2e-3)


class TestSampSynOracle:
    def test_sampsyn(self, tmp_path, rng, sample, device):
        """Wavetable synth vs the per-frame oracle."""
        w = 256
        xw = np.arange(w) / w
        waves = np.stack([
            np.sin(2 * np.pi * xw) + 0.3 * np.sin(6 * np.pi * xw),
            np.sin(2 * np.pi * xw),
        ]).astype(np.float32)
        times = np.asarray([0.0, 0.35], np.float32)
        write_wavetable(tmp_path / "t.wt", WaveTable(times, waves))

        ev = random_events(rng, 8, LEN_SEC, notes=(48, 55, 60))
        st = build_state(
            tmp_path, sample, ev,
            f'load_resource("tbl", "{tmp_path}/t.wt");\n'
            'add_sampsyn("v", 0.9, 10.0, "ev",\n'
            '    {0.01, 0.08, 0.7, 0.4, 0.3, 0.12}, "tbl");\n'
            'set_output("v");', device,
        )
        got = engine_audio(st, ["sampsyn", "vertex_post"])
        fl = O.OracleFloww(ev, SR, BL)
        conf9 = [0.0, 0.01, 1.0, 0.08, 0.7, 0.4, 0.3, 0.12, 0.0]
        verts = {
            "v": O.SampSyn("ev", conf9, times, waves, gain=0.9, angle=10.0),
        }
        expect = O.oracle_render(verts, [], "v", {"ev": fl}, SR, BL, N_BLOCKS)
        compare(got, expect, 2e-3)


class TestFusedGroupOracle:
    def test_18_track_fused_mix(self, tmp_path, rng, sample, device):
        """The fused SampleMulti path (pooled floww cursor, pooled and
        memoized group bake, one voice-mix call for the group) vs the
        per-frame oracle at a track count that engages each of them
        (>=16 flowws pools the cursor; >=2 members fuse the group). On
        the CPU the mix is the kernel's plain version, on the card
        csrc/voice_mix.cu."""
        n_tracks = 18
        evs = [
            random_events(rng, 5, LEN_SEC, with_offs=False)
            for _ in range(n_tracks)
        ]
        body = []
        for i in range(1, n_tracks):
            body.append(f'declare_stream("ev{i}");')
        for i in range(n_tracks):
            fl = "ev" if i == 0 else f"ev{i}"
            ang = (i / n_tracks) * 120.0 - 60.0
            body.append(
                f'add_sample_multi("m{i}", 0.9, {ang:.2f}, "smp", "{fl}", -1);'
            )
        body.append('add_sum("s", 1.0, 0.0);')
        for i in range(n_tracks):
            body.append(f'connect("m{i}", "s");')
        body.append('set_output("s");')
        st = build_state(tmp_path, sample, evs[0], "\n".join(body), device)
        assert st.compiled.fused_groups, "fused path did not engage"
        for i in range(1, n_tracks):
            st.fb.flowws[st.fb.get_index(f"ev{i}")] = evs[i]

        got = engine_audio(st, ["voice_mix"])

        flowws = {"ev": O.OracleFloww(evs[0], SR, BL)}
        verts = {"s": O.Sum()}
        edges = []
        for i in range(n_tracks):
            fl = "ev" if i == 0 else f"ev{i}"
            if i > 0:
                flowws[fl] = O.OracleFloww(evs[i], SR, BL)
            ang = (i / n_tracks) * 120.0 - 60.0
            verts[f"m{i}"] = O.SampleMulti(
                bank_sample(st), fl, gain=0.9, angle=ang
            )
            edges.append((f"m{i}", "s"))
        expect = O.oracle_render(verts, edges, "s", flowws, SR, BL, N_BLOCKS)
        compare(got, expect, 2e-3)
