"""Generated projects of the shapes the port covers.

Five bench configurations of the render path (bench.py), written with
numpy and the port's file writers (fileio.wav, fileio.midi,
fileio.wavetable, copies of the reference's), so the same project can be
loaded by either package:

* c1 (bench.py:372-395): two SampleLoops -> Normalize, rendered at
  44.1 kHz 16-bit (a render resample when the project rate is higher);
* c2 (bench.py:398-434): a SampleLerp kick and an Adsr envelope (drum
  mode) ducking a looping pad on the kick hits -> Normalize, 16-bit;
* c3 (bench.py:437-474): a 3-oscillator Synth bass and a wavetable
  SampSyn chord track through a BandPass -> Normalize, 16-bit;
* c4 (bench.py:477-482, termdaw_tpu/utils/fixtures.py:36-161 with
  include_fx=True): every vertex kind but Sum, SampleLoop and DebugSine, with
  the reverb -> compressor -> eq3 -> delay effect chain on the synth bus;
* c5 (bench.py:485-528): n streamed SampleMulti tracks over one hit
  sample recorded at 96 kHz (resampled on import) -> Normalize, 32-bit.

All randomness comes from numpy generators with fixed seeds.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

from ..config import Config
from ..fileio.midi import write_midi
from ..fileio.packets import PacketDecoder, encode_events
from ..fileio.wav import write_wav
from ..fileio.wavetable import WaveTable, write_wavetable


def drum(path, sr, dur, freq, decay, noise=0.0, seed=0) -> None:
    """A decaying pitch-swept hit as a 16-bit stereo WAV (the generator of
    termdaw_tpu/utils/fixtures.py:_drum)."""
    t = np.arange(int(sr * dur)) / sr
    body = np.exp(-t * decay) * np.sin(2 * np.pi * freq * t * np.exp(-t * 4))
    if noise > 0:
        rng = np.random.default_rng(seed)
        body = body + noise * np.exp(-t * decay * 2) * rng.standard_normal(
            len(t)
        )
    peak = np.max(np.abs(body))
    body = (0.9 * body / peak).astype(np.float32)
    write_wav(path, np.stack([body, body], 1), sr, bits=16)


def _toml(d: Path, bl: int, sr: int) -> None:
    (d / "project.toml").write_text(
        f'[settings]\nmain = "project.lua"\nbuffer_length = {bl}\n'
        f"project_samplerate = {sr}\n"
    )


def write_c1_project(d: Path, length_sec: float, sr: int, bl: int,
                     render_sr: int = 44100, bd: int = 16) -> None:
    """Config 1: kick/snare sample loops -> normalize -> WAV at render_sr."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    drum(d / "kick.wav", sr, 0.5, 55.0, 10.0)
    drum(d / "snare.wav", sr, 0.4, 190.0, 12.0, noise=0.5, seed=7)
    (d / "project.lua").write_text(f"""
set_length({length_sec});
set_render_samplerate({render_sr});
set_render_bitdepth({bd});
set_output_file("{d}/outp.wav");
load_sample("kick", "{d}/kick.wav", "");
load_sample("snare", "{d}/snare.wav", "");
add_sampleloop("kick", 1.0, -10.0, "kick");
add_sampleloop("snare", 0.8, 10.0, "snare");
add_normalize("sum", 1.0, 0.0);
connect("kick", "sum");
connect("snare", "sum");
set_output("sum");
""")
    _toml(d, bl, sr)


def write_c2_project(d: Path, length_sec: float, sr: int, bl: int) -> None:
    """Config 2: an ADSR envelope ducking a looping pad on kick hits
    (reference examples/neg-adsr-env-example.lua:15-17 shape)."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    drum(d / "kick.wav", sr, 0.3, 55.0, 20.0)
    t = np.arange(sr * 2) / sr
    pad = (0.4 * np.sin(2 * np.pi * 110 * t)
           + 0.2 * np.sin(2 * np.pi * 220.3 * t)).astype(np.float32)
    write_wav(d / "bg.wav", np.stack([pad, pad], 1), sr, bits=16)
    kicks = [(b * 0.5, 0.1, 36, 110) for b in range(int(length_sec * 2) - 1)]
    write_midi(d / "kick.mid", kicks, bpm=120)
    (d / "project.lua").write_text(f"""
set_length({length_sec});
set_render_samplerate({sr});
set_render_bitdepth(16);
set_output_file("{d}/outp.wav");
load_sample("kick", "{d}/kick.wav", "");
load_sample("bg", "{d}/bg.wav", "");
load_midi_floww("kick", "{d}/kick.mid");
add_sample_lerp("kick", 1.0, 0.0, "kick", "kick", -1, 40);
add_sampleloop("bg", 1.0, 0.0, "bg");
add_adsr("env", 1.0, 0.0, 1.0, "kick", false, false, -1,
    {{ 1.0, 0.01, 0.3, 0.2, 0.3, 0.0, 0.0, 0.05, 1.0 }});
add_normalize("sum", 1.0, 0.0);
connect("kick", "sum");
connect("bg", "env");
connect("env", "sum");
set_output("sum");
""")
    _toml(d, bl, sr)


def write_c3_project(d: Path, length_sec: float, sr: int, bl: int) -> None:
    """Config 3: a subtractive synth and a wavetable synth driven by MIDI
    flowws through a band-pass."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    bass, chords = [], []
    for bar in range(int(length_sec / 2)):
        t0 = bar * 2.0
        root = [45, 41, 43, 48][bar % 4]
        bass += [(t0, 0.9, root - 12, 100), (t0 + 1.0, 0.9, root - 5, 90)]
        chords += [(t0, 1.8, root + 12, 70), (t0, 1.8, root + 16, 60),
                   (t0, 1.8, root + 19, 65)]
    write_midi(d / "bass.mid", bass, bpm=120)
    write_midi(d / "chords.mid", chords, bpm=120)
    write_wavetable(d / "table.wt", WaveTable.default())
    (d / "project.lua").write_text(f"""
set_length({length_sec});
set_render_samplerate({sr});
set_render_bitdepth(16);
set_output_file("{d}/outp.wav");
load_midi_floww("bass", "{d}/bass.mid");
load_midi_floww("chords", "{d}/chords.mid");
load_resource("tbl", "{d}/table.wt");
hit = {{ 0.001, 0.02, 0.0, 0.0, 0.0, 0.0 }};
note = {{ 0.01, 0.1, 0.8, 5.0, 0.2, 0.5 }};
add_synth("bass", 0.5, 0.0, "bass", 0.4, 0.3, hit, 1.0, 0.8, note, 0.0, {{}});
add_sampsyn("comp", 0.5, 0.0, "chords", note, "tbl");
add_bandpass("band", 1.0, 0.0, 1.0, 8000, 30, true);
add_normalize("sum", 1.0, 0.0);
connect("bass", "band");
connect("comp", "band");
connect("band", "sum");
set_output("sum");
""")
    _toml(d, bl, sr)


def write_c4_project(d: Path, length_sec: float, sr: int, bl: int,
                     render_sr: int = 44100, bd: int = 16,
                     live: bool = False) -> None:
    """Config 4: the reference's full demo project with effects
    (build_demo_project(include_fx=True)): SampleLerp kick and hat, a
    SampleMulti snare, a Synth bass and a SampSyn chord track ducked by an
    Adsr on the kick, a BandPass, then reverb -> compressor -> eq3 ->
    delay (effect params set by LV2-style names) into a Normalize.
    `live` adds two streams for the stream workflow: "drums" plays the
    snare sample into the Normalize, "keys" a Synth into the Adsr duck
    (and so through the effect chain)."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    drum(d / "kick.wav", sr, 0.18, 55.0, 28.0)
    drum(d / "snare.wav", sr, 0.15, 190.0, 35.0, noise=0.6, seed=1)
    drum(d / "hat.wav", sr, 0.06, 6000.0, 80.0, noise=1.0, seed=2)
    beats, snares, hats, bass, chords = [], [], [], [], []
    for bar in range(max(1, int(length_sec / 2.0))):
        t0 = bar * 2.0
        beats += [(t0, 0.1, 36, 110), (t0 + 1.0, 0.1, 36, 100)]
        snares += [(t0 + 0.5, 0.1, 38, 100), (t0 + 1.5, 0.1, 38, 105)]
        hats += [(t0 + i * 0.25, 0.05, 42, 70 + (i % 2) * 20)
                 for i in range(8)]
        root = [45, 41, 43, 48][bar % 4]
        bass += [(t0, 0.9, root - 12, 100), (t0 + 1.0, 0.9, root - 5, 90)]
        chords += [(t0, 1.8, root + 12, 70), (t0, 1.8, root + 16, 60),
                   (t0, 1.8, root + 19, 65)]
    for name, ev in (("kick", beats), ("snare", snares), ("hat", hats),
                     ("bass", bass), ("chords", chords)):
        write_midi(d / f"{name}.mid", ev, bpm=120)
    write_wavetable(d / "table.wt", WaveTable.default())
    streams = """
declare_stream("drums");
declare_stream("keys");
add_sample_multi("live_drums", 0.8, 10.0, "snare", "drums", -1);
add_synth("live_keys", 0.4, -10.0, "keys", 0.4, 0.3, note_adsr,
          0.0, 0.0, {}, 0.0, {});
connect("live_drums", "sum");
connect("live_keys", "duck");
""" if live else ""
    (d / "project.lua").write_text(f"""
set_length({length_sec});
set_render_samplerate({render_sr});
set_render_bitdepth({bd});
set_output_file("{d}/outp.wav");

load_sample("kick", "{d}/kick.wav", "");
load_sample("snare", "{d}/snare.wav", "");
load_sample("hat", "{d}/hat.wav", "");
load_midi_floww("kick", "{d}/kick.mid");
load_midi_floww("snare", "{d}/snare.mid");
load_midi_floww("hat", "{d}/hat.mid");
load_midi_floww("bass", "{d}/bass.mid");
load_midi_floww("chords", "{d}/chords.mid");
load_resource("tbl", "{d}/table.wt");

load_lv2("verb", "native:reverb");
load_lv2("comp", "native:compressor");
load_lv2("eq", "native:eq3");
load_lv2("del", "native:delay");
parameter("comp", "Attack", 30.0);
parameter("comp", "Ratio", 3.0);
parameter("eq", "low freq", 180.0);
parameter("eq", "low gain", -3.0);
parameter("eq", "high gain", 2.0);
parameter("del", "time", 120.0);
parameter("del", "feedback", 0.35);

add_sample_lerp("kick", 1.2, 0.0, "kick", "kick", -1, 40);
add_sample_multi("snare", 0.9, 0.0, "snare", "snare", -1);
add_sample_lerp("hat", 0.4, 40.0, "hat", "hat", -1, 40);

hit_adsr = {{ 0.001, 0.02, 0.0, 0.0, 0.0, 0.0 }};
note_adsr = {{ 0.01, 0.1, 0.8, 5.0, 0.2, 0.5 }};
add_synth("bass", 0.5, 0.0, "bass", 0.4, 0.3, hit_adsr,
          1.0, 0.8, note_adsr, 0.0, {{}});
add_sampsyn("chords", 0.35, -20.0, "chords", note_adsr, "tbl");

add_adsr("duck", 1.0, 0.0, 1.0, "kick", false, false, -1,
         {{ 1.0, 0.01, 0.4, 0.25, 0.4, 0.0, 0.0, 0.05, 1.0 }});
add_bandpass("band", 1.0, 0.0, 1.0, 8000, 30, true);

add_lv2fx("fxverb", 1.0, 0.0, 0.4, "verb");
add_lv2fx("fxcomp", 1.0, 0.0, 1.0, "comp");
add_lv2fx("fxeq", 1.0, 0.0, 1.0, "eq");
add_lv2fx("fxdel", 1.0, 0.0, 0.3, "del");

add_normalize("sum", 1.0, 0.0);

connect("kick", "sum");
connect("snare", "sum");
connect("hat", "sum");
connect("bass", "duck");
connect("chords", "duck");
connect("duck", "band");
connect("band", "fxverb");
connect("fxverb", "fxcomp");
connect("fxcomp", "fxeq");
connect("fxeq", "fxdel");
connect("fxdel", "sum");
{streams}
set_output("sum");
""")
    _toml(d, bl, sr)


def write_c5_project(d: Path, length_sec: float, sr: int, bl: int,
                     n_tracks: int = 64, hit_sr: int = 96000,
                     bd: int = 32) -> bytes:
    """Config 5: n_tracks streamed one-shot players over a hit sample
    recorded at hit_sr -> normalize. Returns the stream packets (32 hits
    per track) to feed after the refresh that declares the streams."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    drum(d / "hit.wav", hit_sr, 0.08, 400.0, 40.0, noise=0.4, seed=3)
    lines = [
        f"set_length({length_sec});",
        f"set_render_samplerate({sr});",
        f"set_render_bitdepth({bd});",
        f'set_output_file("{d}/mix.wav");',
        f'load_sample("hit", "{d}/hit.wav", "");',
        'add_normalize("sum", 1.0, 0.0);',
    ]
    for i in range(n_tracks):
        angle = (i / n_tracks) * 180.0 - 90.0
        lines += [
            f'declare_stream("s{i}");',
            f'add_sample_multi("t{i}", 1.0, {angle:.2f}, "hit", "s{i}", -1);',
            f'connect("t{i}", "sum");',
        ]
    lines.append('set_output("sum");')
    (d / "project.lua").write_text("\n".join(lines))
    _toml(d, bl, sr)
    rng = np.random.default_rng(11)
    blob = b""
    for i in range(n_tracks):
        times = np.sort(
            rng.uniform(0.0, length_sec * 0.95, size=32)
        ).astype(np.float32)
        ev = np.stack(
            [np.zeros(32, np.float32), times,
             np.full(32, 36.0, np.float32),
             rng.uniform(0.4, 1.0, 32).astype(np.float32)], axis=1,
        )
        blob += encode_events(f"s{i}", ev)
    return blob


def load_state(d: Path, device, packets: bytes = b"", mesh=None):
    """Refreshed port State of the project in d on `device` (sharding
    over `mesh`, parallel/mesh.py, when one is given), with the stream
    packets appended. Raises if the refresh did not load."""
    from ..engine.state import State

    st = State(Config.read(Path(d) / "project.toml"), str(d), device=device,
               mesh=mesh)
    st.refresh()
    if not st.loaded:
        raise RuntimeError(f"project in {d} did not load")
    if packets:
        st.fb.append_streams(PacketDecoder().feed(packets))
    return st


def read_wav_ints(path) -> tuple[np.ndarray, int]:
    """Interleaved int samples and the rate of a 16/24/32-bit PCM WAV, read
    with the standard library (independent of the writer)."""
    with wave.open(str(path), "rb") as w:
        width, rate = w.getsampwidth(), w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int64)
        v = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16
        return np.where(v >= 1 << 23, v - (1 << 24), v), rate
    if width not in (2, 4):
        raise ValueError(f"{path}: {8 * width}-bit WAV not supported here")
    return np.frombuffer(raw, f"<i{width}").astype(np.int64), rate
