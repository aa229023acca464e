"""The port's span recorder (termdaw_tpu_torch/utils/prof.py): the steps
of a refresh and a render recorded with their parents, nothing recorded
(no clock read, no profiler range) while nothing asks for it, the spans
as user annotations of a torch.profiler trace on its clock, and
TERMDAW_TIMING's prints kept to the stages. This file imports no JAX;
its card test runs with

    python -m pytest tests/test_torch_prof.py -m cuda -q
"""

import collections
import json
import threading
import time
import types

import pytest
import torch

from termdaw_tpu_torch.engine.state import render_chunk_blocks
from termdaw_tpu_torch.utils import prof
from termdaw_tpu_torch.utils.fixtures import (
    load_state, write_c1_project, write_c4_project,
)

RENDER_STEPS = {"render.device", "seed caps", "window", "window.bake",
                "resample", "quantize", "fetch", "wav write", "wav encode",
                "wav file"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def quiet(monkeypatch):
    """No TERMDAW_TIMING and no TERMDAW_PROFILE, whatever the caller's
    environment."""
    monkeypatch.setattr(prof, "TIMING", False)
    monkeypatch.setattr(prof, "PROFILE_DIR", "")


def _since(t0: float) -> list:
    return [r for r in prof.records() if r.t0 >= t0]


def _windows(cs: int) -> int:
    step = render_chunk_blocks(cs)
    return -(-cs // step)


def _contains(outer, inner) -> bool:
    return outer.t0 <= inner.t0 and inner.t1 <= outer.t1


def _c1(tmp_path):
    """c1 at 3 s, 48 kHz, 256-frame blocks: 563 blocks, two windows of a
    render (512 + 51), each baked live (sample loops carry nothing)."""
    d = tmp_path / "c1"
    write_c1_project(d, 3.0, 48000, 256)
    return d


def test_a_render_records_its_steps_nested(tmp_path, quiet):
    d = _c1(tmp_path)
    t0 = time.perf_counter()
    with prof.recording():
        st = load_state(d, torch.device("cpu"))
        t_render = time.perf_counter()
        st.render()
    recs = _since(t0)
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)

    (refresh,) = by["refresh"]
    assert refresh.parent is None
    for step in ("refresh.lua", "refresh.compile"):
        (r,) = by[step]
        assert r.parent is refresh and _contains(refresh, r)
    assert by["refresh.lua"][0].t1 <= by["refresh.compile"][0].t0

    (render,) = by["render"]
    assert render.parent is None and render.t0 >= t_render
    assert RENDER_STEPS <= set(by)
    (device,) = by["render.device"]
    assert device.parent is render and _contains(render, device)
    windows = by["window"]
    assert len(windows) == _windows(st.cs) == 2
    assert [w.attrs["nb"] for w in windows] == [512, 51]
    assert all(w.attrs["served"] is False for w in windows)
    assert sum(w.attrs["nb"] for w in windows) == st.cs
    for name in ("seed caps", "window", "resample", "quantize"):
        for r in by[name]:
            assert r.parent is device and _contains(device, r)
    for b in by["window.bake"]:
        assert b.parent in windows and _contains(b.parent, b)
    (fetch,) = by["fetch"]
    (write,) = by["wav write"]
    for r in (fetch, write):
        assert r.parent is render and _contains(render, r)
    assert device.t1 <= fetch.t0 and fetch.t1 <= write.t0
    (encode,) = by["wav encode"]
    (wfile,) = by["wav file"]
    for r in (encode, wfile):
        assert r.parent is write and _contains(write, r)
    assert encode.t1 <= wfile.t0
    # the device quantizes to the WAV's width: the fetch is its data
    assert fetch.attrs["bytes"] == (d / "outp.wav").stat().st_size - 44
    assert all(r.thread == threading.get_ident() for r in recs)


def test_a_served_window_says_so(tmp_path, quiet):
    """seed_caps stores c4's schedule as a chain: a fresh State's render
    serves its windows from it and bakes none."""
    d = tmp_path / "c4"
    write_c4_project(d, 2.0, 48000, 256)
    st = load_state(d, torch.device("cpu"))
    t0 = time.perf_counter()
    with prof.recording():
        st.render()
    recs = _since(t0)
    windows = [r for r in recs if r.name == "window"]
    assert len(windows) == _windows(st.cs)
    assert all(w.attrs["served"] is True for w in windows)
    assert not any(r.name == "window.bake" for r in recs)


def test_nothing_is_recorded_while_off(tmp_path, quiet, monkeypatch):
    """Outside recording(), TERMDAW_TIMING and a profiler, a span is the
    shared no-op or the always-on meter's tick: a render records nothing
    in `records()`, enters no record_function and reads no clock in the
    span recorder; it leaves one record in the meter's `renders()`."""
    st = load_state(_c1(tmp_path), torch.device("cpu"))
    calls = {"range": 0, "clock": 0}

    def counting_range(name):
        calls["range"] += 1
        return torch.autograd.profiler.record_function(name)

    def clock():
        calls["clock"] += 1
        return time.perf_counter()

    monkeypatch.setattr(prof, "record_function", counting_range)
    monkeypatch.setattr(prof, "time",
                        types.SimpleNamespace(perf_counter=clock))
    before = prof.records()
    metered = prof.renders()
    st.render()
    after = prof.records()
    assert len(after) == len(before) and (
        not after or after[-1] is before[-1])
    assert calls == {"range": 0, "clock": 0}
    assert prof.renders()[-1] not in metered
    assert prof.renders()[-1].steps[-1][0] == "render"
    assert prof.span("x") is prof.span("y")
    with prof.recording():
        with prof.span("x") as sp:
            sp.attr("k", 1)
    assert calls == {"range": 0, "clock": 2}
    assert prof.records()[-1].name == "x"
    assert prof.records()[-1].attrs == {"k": 1}


def test_timing_prints_the_stages_and_their_steps(tmp_path, quiet,
                                                  monkeypatch, capsys):
    """Under TERMDAW_TIMING=1 a refresh and a render print themselves and
    their direct steps, each as it ends; the steps below them (a window,
    the WAV encode) record but do not print."""
    d = _c1(tmp_path)
    monkeypatch.setattr(prof, "TIMING", True)
    st = load_state(d, torch.device("cpu"))
    capsys.readouterr()
    st.render()
    printed = [ln.split("timing: ")[1].split(" = ")[0]
               for ln in capsys.readouterr().out.splitlines()
               if "timing: " in ln]
    assert printed == ["render.device", "fetch", "wav write", "render"]
    names = {r.name for r in prof.records()}
    assert {"window", "wav encode", "wav file"} <= names


def test_timing_keeps_per_window_and_per_packet_spans_quiet(
        quiet, monkeypatch, capsys):
    """Playback renders windows with no parent and the stream workflow
    feeds a packet at a time: neither prints on its real-time path."""
    monkeypatch.setattr(prof, "TIMING", True)
    for name in ("window", "stream feed"):
        with prof.span(name):
            with prof.span("window.bake"):
                pass
    with prof.span("refresh"):
        with prof.span("refresh.lua"):
            with prof.span("deeper"):
                pass
    out = capsys.readouterr().out
    assert [ln.split("timing: ")[1].split(" = ")[0]
            for ln in out.splitlines()] == ["refresh.lua", "refresh"]
    bake, top = prof.records()[-5:-3]
    assert bake.parent is top and top.name == "stream feed"


def test_a_span_that_raises_closes_and_leaves_its_parent(quiet):
    with prof.recording():
        with prof.span("outer"):
            with pytest.raises(ValueError):
                with prof.span("fails"):
                    raise ValueError("x")
            with prof.span("next"):
                pass
    fails, nxt, outer = prof.records()[-3:]
    assert fails.name == "fails" and fails.t1 >= fails.t0
    assert fails.parent is outer and nxt.parent is outer
    assert outer.parent is None


def test_the_store_keeps_the_newest_records(quiet, monkeypatch):
    monkeypatch.setattr(prof, "_store", collections.deque(maxlen=4))
    with prof.recording():
        for i in range(10):
            with prof.span(f"s{i}"):
                pass
    assert [r.name for r in prof.records()] == ["s6", "s7", "s8", "s9"]


def test_spans_of_another_thread_have_their_own_parents(quiet):
    got = {}

    def work():
        with prof.span("worker"):
            pass
        got["rec"] = prof.records()[-1]

    with prof.recording():
        with prof.span("main"):
            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    rec = got["rec"]
    assert rec.name == "worker" and rec.parent is None
    assert rec.thread == th.ident != threading.get_ident()


def test_profiler_shows_the_spans_as_user_annotations(tmp_path, quiet):
    """Under torch.profiler every program span records (no recording()
    needed) and is a user_annotation of its name; render.device's
    annotated duration matches its record within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    st = load_state(_c1(tmp_path), torch.device("cpu"))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        st.render()
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ann.setdefault(e["name"], []).append(e)
    recs = _since(t0)
    assert {"render"} | RENDER_STEPS <= {r.name for r in recs}
    for name in {"render"} | RENDER_STEPS:
        assert len(ann.get(name, [])) == sum(r.name == name for r in recs)
    (dev,) = [r for r in recs if r.name == "render.device"]
    (ev,) = ann["render.device"]
    assert abs(float(ev["dur"]) * 1e-3 - dev.ms) < 1.0


@pytest.mark.cuda
def test_window_capture_is_recorded_under_its_window_on_card(
        cuda, tmp_path, quiet):
    """On the card a new program's warm-up and capture is a
    `window.capture` span under the window that made it."""
    d = tmp_path / "c4"
    write_c4_project(d, 2.0, 48000, 256)
    st = load_state(d, cuda)
    cg = st.compiled
    c0 = cg.captures
    t0 = time.perf_counter()
    with prof.recording():
        st.render()
    torch.cuda.synchronize()
    caps = [r for r in _since(t0) if r.name == "window.capture"]
    assert len(caps) == cg.captures - c0 > 0
    for r in caps:
        assert r.parent.name == "window" and _contains(r.parent, r)
