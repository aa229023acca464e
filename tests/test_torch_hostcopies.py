"""The port's copies of the reference's host modules (Lua, file formats,
banks, config, sink, palette, terminal helpers) against their sources:
the same inputs through `termdaw_tpu.<module>` and
`termdaw_tpu_torch.<module>` give the same results, bytes and arrays."""

import dataclasses
import importlib

import numpy as np
import pytest

REF, PORT = "termdaw_tpu", "termdaw_tpu_torch"


def _both(module: str):
    return (importlib.import_module(f"{REF}.{module}"),
            importlib.import_module(f"{PORT}.{module}"))


LUA_SCRIPT = """
local function fib(n) if n < 2 then return n end return fib(n-1) + fib(n-2) end
local acc = {}
for i = 1, 10 do acc[#acc + 1] = fib(i) end
table.sort(acc, function(a, b) return a > b end)
emit(table.concat(acc, ","))
emit(string.format("%5.2f|%d|%s", math.pi, 7 // 2, tostring(nil)))
emit(("kick snare hat"):gsub("(%w+)", "<%1>"))
local s = 0
for k, v in pairs({ a = 1, b = 2, c = 3 }) do s = s + v end
emit(s, 2 ^ 10, 7 % 3, -7 // 2)
local co = coroutine.create(function(a)
  local b = coroutine.yield(a * 2)
  return a + b
end)
emit(coroutine.resume(co, 5))
emit(coroutine.resume(co, 4))
emit(string.find("the 120 bpm", "(%d+)"))
local t = setmetatable({}, { __index = function(_, k) return k .. "!" end })
emit(t.x, #"hello", select("#", 1, nil, 3))
local ok, err = pcall(function() error("boom") end)
emit(ok, err)
local pat = {}
for w in string.gmatch("a1 b22 c333", "%a(%d+)") do pat[#pat + 1] = w end
emit(table.unpack(pat))
"""


def _lua(mod, tmp_path):
    rt = mod.LuaRuntime()
    out = []
    rt.set_global("emit", lambda *a: out.append(tuple(
        x.array_items() if isinstance(x, mod.LuaTable) else x for x in a)))
    rt.execute(LUA_SCRIPT)
    try:
        rt.execute("local x = = 1")
    except mod.LuaError as e:
        out.append(("syntax", str(e)))
    return out


def _wav(bits):
    def run(mod, tmp_path):
        rng = np.random.default_rng(bits)
        data = rng.uniform(-1, 1, (257, 2)).astype(np.float32)
        data[0] = (1.0, -1.0)
        path = tmp_path / "a.wav"
        mod.write_wav(path, data, 44100, bits=bits)
        with mod.WavWriter(tmp_path / "ints.wav", 1, 8000, bits) as w:
            w.write_ints(np.arange(-50, 50, dtype=np.int32))
        got, spec = mod.read_wav(path)
        scaled, _ = mod.read_wav(path, scale=True)
        return (path.read_bytes(), (tmp_path / "ints.wav").read_bytes(), got,
                scaled, dataclasses.astuple(spec))
    return run


def _midi(mod, tmp_path):
    path = tmp_path / "notes.mid"
    mod.write_midi(path, [(0.0, 0.25, 36, 100), (0.5, 0.125, 38, 64),
                          (0.5, 1.0, 60, 127), (1.75, 0.25, 42, 1)],
                   tpq=96, bpm=133.0)
    try:
        mod.read_floww_from_midi(tmp_path / "missing.mid")
    except (mod.MidiError, OSError) as e:
        err = type(e).__name__
    return path.read_bytes(), mod.read_floww_from_midi(path), err


def _packets(mod, tmp_path):
    rng = np.random.default_rng(4)
    ev = rng.uniform(0, 4, (9, 4)).astype(np.float32)
    blob = (mod.encode_events("drums", ev) + mod.encode_text("hello")
            + mod.encode_events("bass", ev[:0]))
    dec = mod.PacketDecoder()
    pkts = [p for i in range(0, len(blob), 7) for p in dec.feed(blob[i:i + 7])]
    # the reference's native scanner words the error its own way
    with pytest.raises(mod.PacketError):
        mod.PacketDecoder().feed(b"\x07")
    return blob, [dataclasses.astuple(p) for p in pkts]


def _wavetable(mod, tmp_path):
    rng = np.random.default_rng(6)
    table = mod.WaveTable(np.asarray([0.0, 0.3, 1.2], np.float32),
                          rng.normal(size=(3, 64)).astype(np.float32))
    path = tmp_path / "t.wtable"
    mod.write_wavetable(path, table)
    buf = path.read_bytes()
    parsed = mod.parse_wavetable_from_buffer(buf)
    default = mod.WaveTable.default()
    return (buf, parsed.times, parsed.waves, default.times, default.waves,
            mod.parse_wavetable_from_buffer(buf[:40]),
            mod.parse_wavetable_from_buffer(b"XXXX" + buf[4:]))


def _config(mod, tmp_path):
    out = []
    for i, text in enumerate((
        '[project]\nname = "demo"\n[settings]\nmain = "song.lua"\n'
        'buffer_length = 512\nproject_samplerate = 48000\n'
        'workflow = "stream"\n',
        '[settings]\nmain = "project.lua"\nworkflow = "other"\n',
    )):
        path = tmp_path / f"p{i}.toml"
        path.write_text(text)
        cfg = mod.Config.read(path)
        out.append((cfg.project.name, cfg.settings.main,
                    cfg.settings.buffer_length,
                    cfg.settings.project_samplerate,
                    cfg.settings.workflow.value, str(cfg.settings.workflow)))
    try:
        mod.Config.from_dict({"settings": {}})
    except KeyError as e:
        out.append(str(e))
    return out


def _flowwbank(mod, tmp_path):
    rng = np.random.default_rng(8)
    ev = np.stack([np.zeros(40), np.sort(rng.uniform(0, 2, 40)),
                   rng.integers(30, 70, 40), rng.uniform(0, 1, 40)],
                  1).astype(np.float32)
    fb = mod.FlowwBank(8000, 256)
    fb.declare_floww("a", ev)
    fb.declare_stream("s")
    fb.append_streams([])
    out = []
    for t in (0, 1000, 256 * 7):
        fb.set_time(t)
        d, s = fb.bake_drum(0, 12), fb.bake_simple(0, 12)
        out.append((d.frames, d.notes, d.vels, s.frames, s.ons, s.notes,
                    s.vels, list(fb.start_indices)))
        fb.advance_blocks(3)
        out.append(list(fb.start_indices))
    return out


def _bufferbank(mod, tmp_path):
    for i in range(3):
        (tmp_path / f"b{i}").write_bytes(bytes([i]) * (i + 1))
    bb = mod.BufferBank()
    for i in range(3):
        bb.add(f"b{i}", str(tmp_path / f"b{i}"))
    bb.mark_dead("b1")
    bb.refresh()
    return dict(bb.names), [bb.get_buffer(i) for i in range(len(bb.buffers))]


def _sink(mod, tmp_path):
    path = tmp_path / "play.wav"
    sink = mod.make_sink(8000, f"file:{path}")
    sink.queue_audio(np.linspace(-1, 1, 64, dtype=np.float32))
    sink.close()
    null = mod.make_sink(8000, "null")
    null.queue_audio(np.zeros(10, np.float32))
    return type(sink).__name__, path.read_bytes(), null.frames_queued


def _palette(mod, tmp_path):
    cmds = ["render", "normalize", "play", "stop", "set", "get", "quit",
            "reload"]
    return [mod.filter_commands(cmds, q)
            for q in ("", "re", "p", "st", "rnd", "zz", "GET")]


def _term(mod, tmp_path):
    return (mod.DEFAULT, mod.BLUE, mod.YELLOW, mod.RED, mod.GREEN,
            mod.MAGENTA, mod.value(3.5))


def _prof(mod, tmp_path):
    with mod.span("x"):
        pass
    return mod.TIMING


CASES = {
    "lua": ("lua", _lua),
    "wav8": ("fileio.wav", _wav(8)),
    "wav16": ("fileio.wav", _wav(16)),
    "wav24": ("fileio.wav", _wav(24)),
    "wav32": ("fileio.wav", _wav(32)),
    "midi": ("fileio.midi", _midi),
    "packets": ("fileio.packets", _packets),
    "wavetable": ("fileio.wavetable", _wavetable),
    "config": ("config", _config),
    "flowwbank": ("banks.flowwbank", _flowwbank),
    "bufferbank": ("banks.bufferbank", _bufferbank),
    "sink": ("engine.sink", _sink),
    "palette": ("workflows.palette", _palette),
    "term": ("utils.term", _term),
    "prof": ("utils.prof", _prof),
}


def _assert_same(a, b, where="result"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert type(a) is type(b), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_its_source(case, tmp_path):
    module, run = CASES[case]
    ref, port = _both(module)
    assert ref is not port and port.__name__.startswith(PORT + ".")
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = run(ref, tmp_path / "ref")
    got = run(port, tmp_path / "port")
    _assert_same(got, want)
