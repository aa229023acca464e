"""The port's render path (termdaw_tpu_torch State -> CompiledGraph ->
resample -> quantize -> WAV) against the JAX reference's State on the same
small projects, both on the CPU.

The reference renders with TERMDAW_PALLAS_INTERPRET=1 (its fused voice-mix
kernel in interpret mode, the bake layout the port copies) and
TERMDAW_MESH=0 (without it the suite's 8 virtual CPU devices would shard
the render and take the unfused gather path)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from termdaw_tpu.config import Config
from termdaw_tpu.engine.state import State as RefState
from termdaw_tpu.fileio.packets import PacketDecoder

from termdaw_tpu_torch import cli
from termdaw_tpu_torch.graph import bake as B
from termdaw_tpu_torch.ops import voices
from termdaw_tpu_torch.utils.fixtures import (
    load_state, read_wav_ints, write_c1_project, write_c2_project,
    write_c3_project, write_c4_project, write_c5_project,
)

from .conftest import scrubbed_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# small c5: 8 tracks, 8 kHz / 256, 2 s, a 16 kHz hit (import resample)
C5 = dict(length_sec=2.0, sr=8000, bl=256, n_tracks=8, hit_sr=16000, bd=16)
# small c1 with a 2:1 render resample
C1 = dict(length_sec=2.0, sr=8000, bl=256, render_sr=4000, bd=16)
# small c2 (SampleLerp, Adsr) and c3 (Synth, SampSyn, BandPass)
SMALL = dict(length_sec=2.0, sr=8000, bl=256)
# small c4 (every kind + reverb -> compressor -> eq3 -> delay), rendered
# at the project rate
C4 = dict(SMALL, render_sr=8000)
WRITERS = {"c2": write_c2_project, "c3": write_c3_project}


def _ref_state(d, monkeypatch, packets=b""):
    monkeypatch.setenv("TERMDAW_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TERMDAW_MESH", "0")
    st = RefState(Config.read(Path(d) / "project.toml"), str(d))
    st.refresh()
    assert st.loaded
    if packets:
        st.fb.append_streams(PacketDecoder().feed(packets))
    return st


def _render_ints(st, wav):
    st.render()
    return read_wav_ints(wav)


def _window(st, nb):
    st.fb.set_time(st.compiled.get_time())
    audio = st.compiled.render_window(st.fb, nb)
    st.fb.advance_blocks(nb)
    return np.asarray(audio)


def test_c5_small_matches_reference(tmp_path, monkeypatch):
    packets = write_c5_project(tmp_path, **C5)
    ref = _ref_state(tmp_path, monkeypatch, packets)
    port = load_state(tmp_path, CPU, packets)
    assert port.compiled.fused_groups == ref.compiled.fused_groups
    assert len(port.compiled.fused_groups[0]) == C5["n_tracks"]
    nb = port.cs
    want = _window(ref, nb)
    got = _window(port, nb)
    assert got.shape == want.shape == (nb * C5["bl"], 2)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    ref.compiled.set_time(0)
    port.compiled.set_time(0)
    want_i, rate = _render_ints(ref, tmp_path / "mix.wav")
    got_i, rate_p = _render_ints(port, tmp_path / "mix.wav")
    assert rate == rate_p == C5["sr"] and got_i.shape == want_i.shape
    assert np.abs(got_i - want_i).max() <= 1  # one 16-bit count


def test_c1_small_with_render_resample_matches_reference(tmp_path,
                                                         monkeypatch):
    write_c1_project(tmp_path, **C1)
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    nb = 20
    np.testing.assert_allclose(_window(port, nb), _window(ref, nb), rtol=0,
                               atol=1e-5)
    ref.compiled.set_time(0)
    port.compiled.set_time(0)
    want_i, rate = _render_ints(ref, tmp_path / "outp.wav")
    got_i, rate_p = _render_ints(port, tmp_path / "outp.wav")
    assert rate == rate_p == C1["render_sr"]
    assert got_i.shape == want_i.shape
    assert np.abs(got_i - want_i).max() <= 1


def test_scan_exact_then_render_matches_reference(tmp_path, monkeypatch):
    write_c1_project(tmp_path, **C1)
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    ref.scan_exact()
    port.scan_exact()
    (name, want_max), = ref.compiled.get_normalization_values()
    (pname, got_max), = port.compiled.get_normalization_values()
    assert name == pname == "sum"
    assert got_max == pytest.approx(want_max, rel=1e-6)
    want_i, _ = _render_ints(ref, tmp_path / "outp.wav")
    got_i, _ = _render_ints(port, tmp_path / "outp.wav")
    assert np.abs(got_i - want_i).max() <= 1


def test_load_reference_state_continues_the_render(tmp_path, monkeypatch):
    """The reference renders window 1 and hands its numeric state, carries
    and time to the port; both render window 2."""
    packets = write_c5_project(tmp_path, **C5)
    ref = _ref_state(tmp_path, monkeypatch, packets)
    port = load_state(tmp_path, CPU, packets)
    nb = 24
    _window(ref, nb)
    rcg = ref.compiled
    assert any(c.voices for c in rcg.carries.values())  # voices spill over
    port.compiled.load_reference_state(
        {k: np.asarray(v) for k, v in rcg.num_state.items()},
        rcg.carries, rcg.get_time(),
    )
    assert port.compiled.carries == {
        vi: type(port.compiled.carries[vi])(list(c.voices))
        for vi, c in rcg.carries.items()
    }
    np.testing.assert_allclose(_window(port, nb), _window(ref, nb), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("cfg", ["c2", "c3"])
def test_c2_c3_small_match_reference(tmp_path, monkeypatch, cfg):
    """The whole song as one window at atol 1e-5, then both renders to
    16-bit WAVs within one count."""
    WRITERS[cfg](tmp_path, **SMALL)
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    nb = port.cs
    want = _window(ref, nb)
    got = _window(port, nb)
    assert got.shape == want.shape == (nb * SMALL["bl"], 2)
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    ref.compiled.set_time(0)
    port.compiled.set_time(0)
    want_i, rate = _render_ints(ref, tmp_path / "outp.wav")
    got_i, rate_p = _render_ints(port, tmp_path / "outp.wav")
    assert rate == rate_p == SMALL["sr"] and got_i.shape == want_i.shape
    assert np.abs(got_i - want_i).max() <= 1


def test_c3_set_time_mid_render_matches_reference(tmp_path, monkeypatch):
    """A seek mid-render re-primes the band-pass and clears the Synth's
    notes (SampSyn voices keep their clocks), as the reference does."""
    write_c3_project(tmp_path, **SMALL)
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    cg = port.compiled
    bass = cg.graph.name_map["bass"]
    band = cg.graph.name_map["band"]
    for st in (ref, port):
        _window(st, 20)
    assert cg.carries[bass].notes and not cg.num_state[f"{band}.bp"].first
    for st in (ref, port):
        st.compiled.set_time(3000)
    assert cg.carries[bass] == B.NotesCarry()
    assert bool(cg.num_state[f"{band}.bp"].first)
    np.testing.assert_allclose(_window(port, 24), _window(ref, 24), rtol=0,
                               atol=1e-5)


def test_load_reference_state_continues_c3(tmp_path, monkeypatch):
    """The reference renders c3 up to mid-timeline and hands over its
    band-pass state, its note carries and its time."""
    write_c3_project(tmp_path, **SMALL)
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    _window(ref, 30)
    rcg = ref.compiled
    port.compiled.load_reference_state(rcg.num_state, rcg.carries,
                                       rcg.get_time())
    pcg = port.compiled
    comp = pcg.graph.name_map["comp"]
    assert pcg.carries[comp].notes and all(
        isinstance(n, B.NoteInst) for n in pcg.carries[comp].notes)
    assert {vi: dataclasses.astuple(c) for vi, c in pcg.carries.items()} == {
        vi: dataclasses.astuple(c) for vi, c in rcg.carries.items()}
    band = pcg.graph.name_map["band"]
    np.testing.assert_array_equal(
        pcg.num_state[f"{band}.bp"].prevs.numpy(),
        np.asarray(rcg.num_state[f"{band}.bp"].prevs))
    np.testing.assert_allclose(_window(port, 24), _window(ref, 24), rtol=0,
                               atol=1e-5)


def test_port_render_never_imports_jax(tmp_path):
    script = f"""
import sys
import torch
from termdaw_tpu_torch.utils.fixtures import (
    load_state, write_c1_project, write_c2_project, write_c3_project,
    write_c4_project, write_c5_project)
packets = write_c5_project({str(tmp_path / 'c5')!r}, 1.0, 8000, 256,
                           n_tracks=3, hit_sr=16000, bd=16)
st5 = load_state({str(tmp_path / 'c5')!r}, torch.device('cpu'), packets)
st5.render()
st5.render()
assert st5.compiled.served_windows == 2 and st5.compiled.live_bakes == 0
import io
from termdaw_tpu_torch.engine.sink import NullSink
from termdaw_tpu_torch.workflows.stream import run_stream_workflow
st5.compiled.set_time(0)
run_stream_workflow(8000, 256, st5, NullSink(8000),
                    input_stream=io.BytesIO(packets), max_idle_s=0.3)
write_c1_project({str(tmp_path / 'c1')!r}, 1.0, 8000, 256, render_sr=4000)
load_state({str(tmp_path / 'c1')!r}, torch.device('cpu')).render()
write_c2_project({str(tmp_path / 'c2')!r}, 1.0, 8000, 256)
load_state({str(tmp_path / 'c2')!r}, torch.device('cpu')).render()
write_c3_project({str(tmp_path / 'c3')!r}, 2.0, 8000, 256)
load_state({str(tmp_path / 'c3')!r}, torch.device('cpu')).render()
write_c4_project({str(tmp_path / 'c4')!r}, 1.0, 8000, 256, render_sr=8000,
                 bd=24)
st4 = load_state({str(tmp_path / 'c4')!r}, torch.device('cpu'))
st4.render()
from termdaw_tpu_torch.utils import roofline
st4.fb.set_time(st4.compiled.get_time())
assert st4.compiled.window_cost(st4.fb, 32)['flops'] > 0
assert roofline.config_roofline(st4, 0.1, 1.0)['window_gflops'] > 0
from termdaw_tpu_torch import native
from termdaw_tpu_torch.fileio.packets import PacketDecoder
assert len(PacketDecoder().feed(packets)) > 0
assert native.calls['pack24'] > 0 and native.calls['scan_frames'] > 0, (
    native.calls, native.load_error)
import termdaw_tpu_torch.cli
import termdaw_tpu_torch.workflows.ui
assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)
assert 'termdaw_tpu.native' not in sys.modules
ref = sorted(m for m in sys.modules
             if m == 'termdaw_tpu' or m.startswith('termdaw_tpu.'))
assert not ref, ref
sys.path.insert(0, {str(tmp_path)!r})
import shard_job
from termdaw_tpu_torch.parallel import launch
ranks = launch(shard_job.render, 2, {str(tmp_path / 'c4')!r}, backend='gloo',
               device='cpu', timeout_s=120)
assert all(n == 1 and progs == 1 for n, progs, _ in ranks), ranks
assert not any(loaded for _, _, loaded in ranks), ranks
print('JAXFREE')
"""
    # a sharded render on 2 ranks, through the program cache: each rank
    # reports its sharded windows and program entries and the modules it
    # loaded
    (tmp_path / "shard_job.py").write_text("""
import sys
from termdaw_tpu_torch.tools import shard_render
from termdaw_tpu_torch.utils.fixtures import load_state


def render(mesh, d):
    st = load_state(d, mesh.device, mesh=mesh)
    st.render()
    loaded = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'jaxlib', 'termdaw_tpu'))
    return (st.compiled.sharded_windows,
            len(shard_render.sharded_programs(st.compiled)), loaded)
""")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=240, env=scrubbed_env(TERMDAW_SINK="null"),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAXFREE" in proc.stdout
    for cfg in ("c1", "c2", "c3", "c4"):
        assert (tmp_path / cfg / "outp.wav").exists()
    assert (tmp_path / "c5" / "mix.wav").exists()


def test_cli_render_writes_the_wav(tmp_path):
    write_c1_project(tmp_path, **C1)
    proc = subprocess.run(
        [sys.executable, "-m", "termdaw_tpu_torch", "--device", "cpu",
         str(tmp_path)],
        input="render\nquit\n", cwd=REPO, capture_output=True, text=True,
        timeout=240, env=scrubbed_env(TERMDAW_SINK="null"),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done rendering" in proc.stdout
    got, rate = read_wav_ints(tmp_path / "outp.wav")
    want, _ = _render_ints(load_state(tmp_path, CPU), tmp_path / "outp.wav")
    assert rate == C1["render_sr"]
    np.testing.assert_array_equal(got, want)


def test_cli_cuda_without_a_card_exits_nonzero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    write_c1_project(tmp_path, **C1)
    assert cli.main(["--device", "cuda", str(tmp_path)]) != 0
    assert "torch.cuda.is_available() is false" in capsys.readouterr().out


def _fx_project(d: Path, decl: str) -> None:
    """A synth through one effect vertex "fx" into a Sum, 1 s at 8 kHz."""
    (d / "project.toml").write_text(
        '[settings]\nmain = "project.lua"\nbuffer_length = 256\n'
        "project_samplerate = 8000\n"
    )
    (d / "project.lua").write_text(f"""
set_length(1.0);
declare_floww("f", {{ {{0.1, 60, 0.9}}, {{0.5, 60, 0.0}} }});
add_synth("syn", 1.0, 0.0, "f", 0.4, 0.3,
          {{ 0.01, 0.1, 0.8, 5.0, 0.2, 0.5 }}, 0.0, 0.0, {{}}, 0.0, {{}});
{decl}
add_sum("out", 1.0, 0.0);
connect("syn", "fx");
connect("fx", "out");
set_output("out");
""")


@pytest.mark.parametrize("decl", [
    'load_lv2("dly", "native:delay");\n'
    'add_lv2fx("fx", 1.0, 0.0, 0.5, "dly");',
    'load_lv2("verb", "native:reverb");\n'
    'add_lv2fx("fx", 1.0, 0.0, 0.5, "verb");',
])
def test_unported_vertex_aborts_the_refresh(tmp_path, monkeypatch, decl):
    """The effect vertices that aborted the refresh before the effects
    were ported (a delay and a reverb) now load, and the whole song
    matches the reference within 1e-5."""
    _fx_project(tmp_path, decl)
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    fxv = port.compiled.graph.name_map["fx"]
    assert set(port.compiled.num_state) == set(ref.compiled.num_state)
    assert f"{fxv}.fx" in port.compiled.num_state
    nb = port.cs
    want = _window(ref, nb)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(_window(port, nb), want, rtol=0, atol=1e-5)


def test_exact_biquad_lane_aborts_an_eq3_refresh(tmp_path, monkeypatch):
    """TERMDAW_EXACT_BIQUAD=1 no longer aborts an eq3 refresh: a small c4
    renders with the exact sequential lane in both packages, the WAVs
    within one 16-bit count, and the port's graph keeps the lane it read
    at build after the variable is unset."""
    write_c4_project(tmp_path, **C4)
    monkeypatch.setenv("TERMDAW_EXACT_BIQUAD", "1")
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    monkeypatch.setenv("TERMDAW_EXACT_BIQUAD", "0")
    assert port.compiled.exact_biquad and ref.compiled.exact_biquad
    want_i, rate = _render_ints(ref, tmp_path / "outp.wav")
    got_i, rate_p = _render_ints(port, tmp_path / "outp.wav")
    assert rate == rate_p == C4["sr"] and got_i.shape == want_i.shape
    assert np.abs(want_i).max() > 2 ** 14
    assert np.abs(got_i - want_i).max() <= 1  # one 16-bit count
    # the parallel lane renders a different (within 2e-3 of full scale)
    # song: the flag did switch the lane
    default = load_state(tmp_path, CPU)
    assert not default.compiled.exact_biquad
    lane_i, _ = _render_ints(default, tmp_path / "outp.wav")
    assert 0 < np.abs(lane_i - got_i).max() <= 2e-3 * 2 ** 15


def test_c4_small_matches_reference(tmp_path, monkeypatch):
    """The whole c4 song as one window within 1e-4 (eq3's bound), then
    both renders to 16-bit WAVs within one count."""
    write_c4_project(tmp_path, **C4)
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    kinds = {port.compiled.statics[vi].fx_kind
             for vi in port.compiled.order}
    assert kinds == {"", "reverb", "compressor", "eq3", "delay"}
    comp = port.host.param_values(port.host.get_index("comp"))
    assert comp["attack"] == 30.0 and comp["ratio"] == 3.0
    nb = port.cs
    want = _window(ref, nb)
    got = _window(port, nb)
    assert got.shape == want.shape == (nb * C4["bl"], 2)
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    ref.compiled.set_time(0)
    port.compiled.set_time(0)
    want_i, rate = _render_ints(ref, tmp_path / "outp.wav")
    got_i, rate_p = _render_ints(port, tmp_path / "outp.wav")
    assert rate == rate_p == C4["sr"] and got_i.shape == want_i.shape
    assert np.abs(got_i - want_i).max() <= 1


def test_load_reference_state_continues_c4(tmp_path, monkeypatch):
    """The reference renders c4 for a window and hands over every effect
    state (delay tails, scan carries, biquad states) with the rest."""
    write_c4_project(tmp_path, **C4)
    ref = _ref_state(tmp_path, monkeypatch)
    port = load_state(tmp_path, CPU)
    nb = 32  # half the song: the reverb's lines are ringing
    _window(ref, nb)
    rcg = ref.compiled
    port.compiled.load_reference_state(rcg.num_state, rcg.carries,
                                       rcg.get_time())
    pcg = port.compiled
    verb = pcg.graph.name_map["fxverb"]
    tails = pcg.num_state[f"{verb}.fx"]["comb_tails"]
    for got, want in zip(tails, rcg.num_state[f"{verb}.fx"]["comb_tails"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert max(float(t.abs().max()) for t in tails) > 1e-3
    np.testing.assert_allclose(_window(port, nb), _window(ref, nb), rtol=0,
                               atol=1e-4)


def test_refresh_with_a_new_delay_time_rebuilds_the_line(tmp_path):
    """`time` is a static param: a refresh that changes it binds the new
    comb length (the tail), as the reference does."""
    from termdaw_tpu.ops import fx as rfx

    write_c4_project(tmp_path, **C4)
    st = load_state(tmp_path, CPU)
    dly = st.compiled.graph.name_map["fxdel"]
    assert st.compiled.num_state[f"{dly}.fx"]["tail"].shape == (960, 2)
    lua = tmp_path / "project.lua"
    lua.write_text(lua.read_text().replace(
        'parameter("del", "time", 120.0);', 'parameter("del", "time", 250);'))
    st.refresh()
    assert st.loaded
    cg = st.compiled
    dly = cg.graph.name_map["fxdel"]
    assert cg.statics[dly].fx_static == (("time", 250.0),)
    D = rfx._delay_samples(8000, {"time": 250.0})
    assert cg.num_state[f"{dly}.fx"]["tail"].shape == (D, 2) == (2000, 2)
    assert set(cg._pack_fx()[str(dly)]) == {"feedback"}
    assert np.isfinite(_window(st, 8)).all()


def test_cuda_counter_untouched_by_cpu_render(tmp_path):
    packets = write_c5_project(tmp_path, **C5)
    before = voices.launches
    load_state(tmp_path, CPU, packets).render()
    assert voices.launches == before
