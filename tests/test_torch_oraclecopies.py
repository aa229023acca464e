"""The port's copies of the repo's oracle evidence held to their sources:

* the float64 per-frame loops of tests/test_torch_fx_oracle.py against
  tests/test_fx_oracle.py's: bit for bit on the fixture input, with the
  same cases, tolerances, splits and shapes (the reverb's line lengths,
  the delay's length and the eq3's biquad coefficients come from each
  package's own ops/fx.py and ops/filters.py);
* termdaw_tpu_torch/tools/parity_report.py against tools/parity_report.py:
  `drum`, `events`, `metrics` and `err_vs_oracle` give the same arrays and
  numbers, and each config writes the same project files (Lua text, TOML,
  sample WAV, wavetable) from the same draws of the seed 20260816, at the
  toy shape and at the --full shapes;
* tests/test_torch_oracle.py against tests/test_oracle_equivalence.py,
  read as source: the same shapes and helpers, the same tests and
  parameters, and in each test the same event draws, Lua text, oracle
  vertices and `compare` tolerances.

The first two sources import JAX, so those tests need it."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

from termdaw_tpu_torch.tools import parity_report as P

from . import test_torch_fx_oracle as PF
from .test_torch_fx_oracle import x64  # noqa: F401 (the fixture)


@pytest.fixture(scope="module")
def ref_fx():
    pytest.importorskip("jax")
    return importlib.import_module("tests.test_fx_oracle")


@pytest.fixture(scope="module")
def ref_tool():
    pytest.importorskip("jax")
    # the reference tool sets up JAX's persistent compilation cache at
    # import unless this says not to
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TERMDAW_COMPILE_CACHE", "0")
        return importlib.import_module("tools.parity_report")


def test_fx_shapes_and_cases_equal(ref_fx):
    assert (PF.SR, PF.T_TOTAL, PF.SPLITS) == (ref_fx.SR, ref_fx.T_TOTAL,
                                             ref_fx.SPLITS)
    assert [(k, p, tol) for k, p, _, tol in PF.CASES] == [
        (k, p, tol) for k, p, _, tol in ref_fx.CASES]


@pytest.mark.parametrize("i", range(len(PF.CASES)),
                         ids=[c[0] for c in PF.CASES])
def test_fx_float64_loop_equals_source(ref_fx, x64, i):  # noqa: F811
    kind, params, port_ref, _ = PF.CASES[i]
    want = ref_fx.CASES[i][2](x64, params)
    got = port_ref(x64, params)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want), kind


def test_tool_helpers_equal_source(ref_tool):
    for sr in (P.SR, 48000):
        assert np.array_equal(P.drum(sr), ref_tool.drum(sr))
    a, b = (np.random.default_rng(P.SEED) for _ in range(2))
    for n, kw in ((8, {"with_offs": False}), (6, {"notes": (48, 55)}),
                  (5, {"notes": (60, 64, 67)}), (10, {})):
        assert np.array_equal(P.events(a, n, **kw), ref_tool.events(b, n, **kw))
    rng = np.random.default_rng(3)
    got = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    expect = got + rng.normal(scale=1e-5, size=got.shape)
    expect[100] += 5e-4  # one isolated spike
    for fn in ("metrics", "err_vs_oracle"):
        port = getattr(P, fn)(got, expect)
        assert port.pop("max_err") > 1e-4
        assert port == getattr(ref_tool, fn)(got, expect)


class _Built(Exception):
    pass


def _project_files(mod, monkeypatch, d, shape):
    """Each config's project files as `mod`'s build writes them, in the
    order and with the draws of a report run: the State the build makes
    is replaced by one that stops the config there."""
    def stop(*a, **k):
        raise _Built

    monkeypatch.setattr(mod, "State", stop)
    rng = np.random.default_rng(P.SEED)
    files = {}
    with mod._shaped(*shape):
        for name in ("config1", "config2", "config3", "config4", "config5"):
            with pytest.raises(_Built):
                getattr(mod, name)(d / name, rng)
            files[name] = {str(f.relative_to(d / name)): f.read_bytes()
                           for f in sorted((d / name).rglob("*"))
                           if f.is_file()}
    return files, rng.bit_generator.state


@pytest.mark.parametrize("shape", [(4000, 128, 24), (48000, 1024, 1875),
                                   (48000, 1024, 564)],
                         ids=["toy", "full_40s", "full_12s"])
def test_tool_configs_write_the_source_projects(ref_tool, monkeypatch,
                                                tmp_path, shape):
    port, port_rng = _project_files(P, monkeypatch, tmp_path / "port", shape)
    ref, ref_rng = _project_files(ref_tool, monkeypatch, tmp_path / "ref",
                                  shape)
    assert port_rng == ref_rng
    assert port.keys() == ref.keys()
    for name in port:
        assert port[name] == ref[name], name
        (lua,) = [v for k, v in port[name].items()
                  if k.endswith("project.lua")]  # config4's is in a/
        assert b"set_output" in lua
    assert "t.wt" in port["config3"]


TESTS = Path(__file__).resolve().parent
# the helpers of the port's copy that take the device or count launches
PORT_ONLY_ARGS = {"device"}
EVIDENCE_CALLS = {"random_events", "build_state", "compare",
                  "write_wavetable", "WaveTable"}


def _tests(tree):
    """{Class.test_name: function} of a test module."""
    return {f"{c.name}.{f.name}": f for c in tree.body
            if isinstance(c, ast.ClassDef) for f in c.body
            if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")}


def _evidence(fn):
    """What a test holds the engine to, each item unparsed, in source
    order: its parametrize marks; every call that draws events, writes the
    Lua or the wavetable, builds an oracle vertex (O.*), makes an array
    (np.*) or compares (build_state without its device argument); every
    name bound to a value that is not the render or a saved module
    attribute."""
    items = [(0, 0, ast.unparse(d)) for d in fn.decorator_list
             if "parametrize" in ast.unparse(d)]
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            name = (f.id if isinstance(f, ast.Name) else
                    f.value.id + "." if isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name) else "")
            if name in EVIDENCE_CALLS or name in ("O.", "np.", "body."):
                node = ast.Call(node.func, [
                    a for a in node.args
                    if not (isinstance(a, ast.Name) and a.id in PORT_ONLY_ARGS)
                ], node.keywords)
                items.append((node.func.lineno, node.func.col_offset,
                              ast.unparse(node)))
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)
              and not isinstance(node.value, ast.Attribute)
              and not (isinstance(node.value, ast.Call)
                       and ast.unparse(node.value.func) in (
                           "engine_audio", "build_state"))):
            items.append((node.lineno, node.col_offset, ast.unparse(node)))
    return [text for *_, text in sorted(items)]


def _module(name):
    return ast.parse((TESTS / name).read_text())


def test_oracle_tests_equal_source():
    port = _module("test_torch_oracle.py")
    ref = _module("test_oracle_equivalence.py")
    top = {}
    for tree in (port, ref):
        top[tree is port] = {
            n.targets[0].id if isinstance(n, ast.Assign) else n.name:
            ast.unparse(ast.Module(n.body[1:] if isinstance(n, ast.FunctionDef)
                                   and ast.get_docstring(n) else [n], []))
            for n in tree.body
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
            and n.targets[0].id in ("SR", "BL", "N_BLOCKS", "LEN_SEC")
            or isinstance(n, ast.FunctionDef) and n.name in (
                "drum_sample", "random_events", "compare", "bank_sample",
                "sample")}
    assert top[True] == top[False]
    assert len(top[True]) == 9
    port_tests, ref_tests = _tests(port), _tests(ref)
    assert port_tests.keys() == ref_tests.keys()
    for name, fn in port_tests.items():
        got, want = _evidence(fn), _evidence(ref_tests[name])
        assert got == want, name
        assert any(t.startswith("compare(") for t in got), name
