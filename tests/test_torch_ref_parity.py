"""Cross-package values where a reference behaviour test pins what the
reference computed: the two packages on the same project, on the CPU.

* the demo project's peak, rms and low/high ratio
  (tests/test_stress.py::TestGoldenStats): the port within 1e-4 relative
  of the reference;
* the vertex list and `loaded` flag after each refresh-diff case
  (tests/test_engine.py::TestRefreshDiff): equal;
* the `declare_floww` render's PCM
  (tests/test_engine.py::TestInlineFlowwDeclaration): equal;
* windowed against one-shot (tests/test_engine.py::TestWindowInvariance):
  the port's difference within the reference test's bound, 4 LSB, and
  each of the port's renders within it of the reference's.

Imports both packages, so it runs only where JAX is installed; the
mirrors themselves (tests/test_torch_ref_<suite>.py) import no JAX."""

import numpy as np
import pytest
import torch

from termdaw_tpu.config import Config as RefConfig
from termdaw_tpu.engine import state as ref_state_mod
from termdaw_tpu.engine.state import State as RefState
from termdaw_tpu.utils.fixtures import build_demo_project

from termdaw_tpu_torch.config import Config
from termdaw_tpu_torch.engine import state as state_mod
from termdaw_tpu_torch.engine.state import State
from termdaw_tpu_torch.fileio.midi import write_midi
from termdaw_tpu_torch.fileio.wav import read_wav, write_wav
from termdaw_tpu_torch.utils.fixtures import load_state, write_c4_project

CPU = torch.device("cpu")
SR = 8000
BL = 256


def _toml(d, name="test"):
    (d / "project.toml").write_text(
        f'[project]\nname = "{name}"\n[settings]\nmain = "project.lua"\n'
        f"buffer_length = {BL}\nproject_samplerate = {SR}\n"
    )


def both(d, lua):
    """The port's and the reference's State of one project (not yet
    refreshed)."""
    _toml(d)
    (d / "project.lua").write_text(lua)
    port = State(Config.read(d / "project.toml"), str(d), device=CPU)
    ref = RefState(RefConfig.read(d / "project.toml"), str(d))
    return port, ref


def tone_wav(path, freq=440.0, dur=0.25, amp=0.5):
    t = np.arange(int(SR * dur)) / SR
    x = (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    write_wav(path, np.stack([x, x], 1), SR, bits=16)


def _stats(path):
    audio, spec = read_wav(path, scale=True)
    spec_l = np.abs(np.fft.rfft(audio[:, 0]))
    freqs = np.fft.rfftfreq(audio.shape[0], 1 / spec.sample_rate)
    low = float(np.sum(spec_l[freqs < 1000.0]))
    high = float(np.sum(spec_l[freqs >= 1000.0]))
    return {"peak": float(np.max(np.abs(audio))),
            "rms": float(np.sqrt(np.mean(audio ** 2))),
            "ratio": low / max(high, 1e-9)}


def test_demo_project_statistics_match_the_reference(tmp_path):
    """tests/test_stress.py::TestGoldenStats::
    test_demo_project_statistics_pinned in both packages: the port's
    peak, rms and low/high ratio within 1e-4 relative of the
    reference's."""
    ref = build_demo_project(tmp_path / "ref", sr=8000, bl=256,
                             length_sec=2.0, include_fx=True)
    ref.scan_exact()
    ref.render()
    write_c4_project(tmp_path / "port", 2.0, 8000, 256)
    assert (tmp_path / "port" / "project.lua").read_text() == \
        (tmp_path / "ref" / "project.lua").read_text().replace(
            str(tmp_path / "ref"), str(tmp_path / "port"))
    port = load_state(tmp_path / "port", CPU)
    port.scan_exact()
    port.render()
    want = _stats(ref._resolve(ref.output_file))
    got = _stats(port._resolve(port.output_file))
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), (k, got, want)


REFRESH_CASES = {
    "hot_reload": (
        """set_length(0.25);
        load_sample("a", "{d}/a.wav", "");
        add_sampleloop("l", 1.0, 0.0, "a");
        set_output("l");""",
        """set_length(0.25);
        load_sample("a", "{d}/a.wav", "");
        load_sample("b", "{d}/b.wav", "");
        add_sampleloop("l", 1.0, 0.0, "b");
        set_output("l");"""),
    "failed_resource": ("""load_sample("ghost", "/nonexistent.wav", "");
        add_sampleloop("l", 1.0, 0.0, "ghost");
        set_output("l");""",),
    "lua_error": ("this is not lua ===",),
    "missing_output": ("""load_sample("a", "{d}/a.wav", "");
        add_sampleloop("l", 1.0, 0.0, "a");
        set_output("nope");""",),
}


@pytest.mark.parametrize("case", sorted(REFRESH_CASES))
def test_refresh_diff_matches_the_reference(tmp_path, case):
    """tests/test_engine.py::TestRefreshDiff in both packages: after each
    refresh the vertex list, the loaded flag and the sample bank's names
    are equal."""
    tone_wav(tmp_path / "a.wav")
    tone_wav(tmp_path / "b.wav", freq=300.0)
    scripts = [s.format(d=tmp_path) for s in REFRESH_CASES[case]]
    port, ref = both(tmp_path, scripts[0])
    for src in scripts:
        (tmp_path / "project.lua").write_text(src)
        port.refresh()
        ref.refresh()
        assert port.loaded == ref.loaded
        assert [(v.name, v.kind) for v in port.g.vertices] == \
            [(v.name, v.kind) for v in ref.g.vertices]
        assert [port.sb.get_index(n) for n in ("a", "b", "ghost")] == \
            [ref.sb.get_index(n) for n in ("a", "b", "ghost")]
    assert port.loaded == (case == "hot_reload")


NOTES = [(0.05, 0.10, 40, 100), (0.30, 0.10, 52, 80), (0.55, 0.10, 45, 127)]


def test_declare_floww_pcm_matches_the_reference(tmp_path):
    """tests/test_engine.py::TestInlineFlowwDeclaration in both packages:
    the declare_floww render's PCM is equal, and equal to the MIDI
    path's in each."""
    rows = []
    for start, dur, note, vel in NOTES:
        rows.append(f"{{ {start}, {note}, {vel}/127.0 }}")
        rows.append(f"{{ {start + dur}, {note}, 0.0 }}")
    pcm = {}
    for via in ("lua", "midi"):
        for pkg in ("port", "ref"):
            d = tmp_path / f"{via}_{pkg}"
            d.mkdir()
            floww = (f'declare_floww("pat", {{ {", ".join(rows)} }});'
                     if via == "lua" else
                     f'load_midi_floww("pat", "{d}/pat.mid");')
            write_midi(d / "pat.mid", NOTES, bpm=120)
            t = np.arange(int(SR * 0.12)) / SR
            x = (0.5 * np.sin(2 * np.pi * 300.0 * t)).astype(np.float32)
            write_wav(d / "tone.wav", np.stack([x, x], 1), SR, bits=16)
            port, ref = both(d, f"""
                set_length(1.0);
                set_render_samplerate({SR});
                set_output_file("{d}/out.wav");
                load_sample("tone", "{d}/tone.wav", "");
                {floww}
                add_sample_multi("v", 1.0, 0.0, "tone", "pat", -1);
                add_normalize("sum", 1.0, 0.0);
                connect("v", "sum");
                set_output("sum");
                """)
            st = port if pkg == "port" else ref
            st.refresh()
            assert st.loaded
            st.render()
            pcm[via, pkg], _ = read_wav(d / "out.wav", scale=False)
    np.testing.assert_array_equal(pcm["lua", "port"], pcm["lua", "ref"])
    np.testing.assert_array_equal(pcm["lua", "port"], pcm["midi", "port"])
    np.testing.assert_array_equal(pcm["lua", "ref"], pcm["midi", "ref"])
    assert np.abs(pcm["lua", "port"]).max() > 1000


def test_windowed_equals_oneshot_in_both_packages(tmp_path, monkeypatch):
    """tests/test_engine.py::TestWindowInvariance::
    test_windowed_equals_oneshot in both packages: one-shot (1024-block
    windows) and chunked (3-block windows) renders, each within the
    reference test's 4 LSB of the other and of the other package's."""
    tone = (0.5 * np.sin(2 * np.pi * 60.0 * np.arange(int(SR * 0.05))
                         / SR)).astype(np.float32)
    out = {}
    for blocks in (1024, 3):
        monkeypatch.setattr(state_mod, "RENDER_WINDOW_BLOCKS", blocks)
        monkeypatch.setattr(ref_state_mod, "RENDER_WINDOW_BLOCKS", blocks)
        for pkg in ("port", "ref"):
            d = tmp_path / f"{pkg}{blocks}"
            d.mkdir()
            write_wav(d / "kick.wav", np.stack([tone, tone], 1), SR, bits=16)
            write_midi(d / "beat.mid",
                       [(0.01, 0.05, 36, 100), (0.13, 0.05, 38, 90),
                        (0.29, 0.08, 36, 60), (0.4, 0.3, 48, 110)], bpm=120)
            port, ref = both(d, f"""
                set_length(0.75);
                set_output_file("{d}/out.wav");
                load_sample("kick", "{d}/kick.wav", "");
                load_midi_floww("beat", "{d}/beat.mid");
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
                """)
            st = port if pkg == "port" else ref
            st.refresh()
            assert st.loaded
            st.render()
            out[pkg, blocks], _ = read_wav(d / "out.wav")
    for pkg in ("port", "ref"):
        np.testing.assert_allclose(out[pkg, 1024], out[pkg, 3], atol=4.0)
    for blocks in (1024, 3):
        np.testing.assert_allclose(out["port", blocks], out["ref", blocks],
                                   atol=4.0)
    assert np.max(np.abs(out["port", 1024])) > 1000
