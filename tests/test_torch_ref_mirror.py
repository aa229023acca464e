"""The guard over the mirrors of the reference's behaviour suites.

Every test function of the nine reference suites below (found with
`ast`, module level and in `Test*` classes) must be mirrored on the port:
some docstring in a tests/test_torch_*.py file names it as
`tests/test_<suite>.py::<Class>::<test>`. Or it sits in NOT_MIRRORED with
its reason, which is a JAX/XLA/Pallas-only mechanism or a numbered known
deviation of ROADMAP.md §3. A reference test added without a mirror then
fails here. The guard also runs the mirrors' imports in a child process
with JAX and the JAX package blocked. It imports neither package."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

SUITES = ("engine", "workflows", "events", "bake_caps", "banks", "graph",
          "stress", "property", "lua")

# reference test id -> why the port has no mirror of it. Every case of the
# nine suites has a mirror today; an entry names a JAX/XLA/Pallas-only
# mechanism or a numbered known deviation of ROADMAP.md §3.
NOT_MIRRORED: dict[str, str] = {}

_REASON = re.compile(r"\b(JAX|XLA|Pallas)\b|\bknown deviation (\d+)\b")


def reference_tests(paths) -> list[str]:
    """The ids `tests/<file>::[<Class>::]<test>` of every test function in
    the files `paths`."""
    ids = []
    for path in paths:
        tree = ast.parse(Path(path).read_text())
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and \
                    node.name.startswith("test"):
                ids.append(f"tests/{Path(path).name}::{node.name}")
            elif isinstance(node, ast.ClassDef) and \
                    node.name.startswith("Test"):
                ids += [f"tests/{Path(path).name}::{node.name}::{f.name}"
                        for f in node.body
                        if isinstance(f, ast.FunctionDef)
                        and f.name.startswith("test")]
    return ids


def mirror_docstrings(paths) -> list[str]:
    """Every docstring of the files `paths`, its whitespace collapsed and
    none left after a `::` (a wrapped id reads whole)."""
    docs = []
    for path in paths:
        for node in ast.walk(ast.parse(Path(path).read_text())):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
                doc = ast.get_docstring(node)
                if doc:
                    docs.append(re.sub(r"::\s+", "::", " ".join(doc.split())))
    return docs


def unmirrored(ref_paths, port_paths, not_mirrored) -> list[str]:
    """The reference tests neither named by a port docstring nor listed."""
    text = "\n".join(mirror_docstrings(port_paths))
    return [t for t in reference_tests(ref_paths)
            if t not in not_mirrored
            and re.search(re.escape(t) + r"(?![\w])", text) is None]


def _ref_paths():
    return [TESTS / f"test_{s}.py" for s in SUITES]


def _port_paths():
    return sorted(TESTS.glob("test_torch_*.py"))


def test_every_reference_case_is_mirrored_or_listed():
    ids = reference_tests(_ref_paths())
    assert len(ids) == len(set(ids)) >= 158
    missing = unmirrored(_ref_paths(), _port_paths(), NOT_MIRRORED)
    assert not missing, f"reference tests without a mirror: {missing}"


def test_not_mirrored_entries_are_live_and_give_a_valid_reason():
    ids = set(reference_tests(_ref_paths()))
    roadmap = (REPO / "ROADMAP.md").read_text()
    known = roadmap.split("**Known deviations.**", 1)[1]
    deviations = set(re.findall(r"^(\d+)\. \*\*", known, re.M))
    assert "9" in deviations
    for tid, reason in NOT_MIRRORED.items():
        assert tid in ids, f"{tid} is not a reference test"
        m = _REASON.search(reason)
        assert m, f"{tid}: the reason names no JAX-only mechanism or " \
                  "known deviation"
        assert m.group(2) is None or m.group(2) in deviations, \
            f"{tid}: ROADMAP.md §3 has no known deviation {m.group(2)}"


def test_every_mirror_names_a_reference_test():
    ids = set(reference_tests(_ref_paths()))
    named = re.findall(r"Mirror of (tests/test_\w+\.py::[\w:]+\w)",
                       "\n".join(mirror_docstrings(_port_paths())))
    assert len(named) >= 150
    assert set(named) <= ids, sorted(set(named) - ids)


def test_a_reference_test_without_a_mirror_fails_the_guard(tmp_path):
    ref = tmp_path / "test_graph.py"
    ref.write_text((TESTS / "test_graph.py").read_text()
                   + "\n\nclass TestNew:\n    def test_added(self):\n"
                   "        pass\n")
    missing = unmirrored([ref], _port_paths(), NOT_MIRRORED)
    assert missing == ["tests/test_graph.py::TestNew::test_added"]
    assert unmirrored([ref], _port_paths(), {missing[0]: "XLA only"}) == []


_BLOCKED_IMPORT = """
import importlib, sys
BLOCKED = ("jax", "jaxlib", "termdaw_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"import of {name} blocked")
sys.meta_path.insert(0, Block())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("loaded", loaded)
sys.exit(3 if loaded else 0)
"""


def test_mirrors_import_nothing_of_jax_or_the_jax_package():
    """The mirrors (all of tests/test_torch_ref_*.py but the parity file,
    which holds the two packages side by side) run where only the port
    is installed: a child imports them with jax, jaxlib and termdaw_tpu
    blocked."""
    mods = [f"tests.{p.stem}" for p in sorted(TESTS.glob("test_torch_ref_*.py"))
            if p.stem != "test_torch_ref_parity"]
    assert len(mods) == 10  # the nine mirrors and this guard
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, *mods],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loaded []" in proc.stdout


@pytest.mark.parametrize("suite", SUITES)
def test_each_suite_has_its_mirror_file(suite):
    mirror = TESTS / f"test_torch_ref_{suite}.py"
    assert mirror.exists()
    src = mirror.read_text()
    assert f"tests/test_{suite}.py" in src
    assert "import jax" not in src and "from termdaw_tpu." not in src \
        and "from termdaw_tpu import" not in src
