"""What the benchmark may import: nothing of the JAX package or JAX (the
top-level name compared whole, since ``repro_torch`` begins with
``repro``), and nothing of the program under ``reference/``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HOME = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """(top-level module name, level) of every import in a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0, a.name
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level, \
                node.module or ""


def _files(sub=""):
    return sorted((HOME / sub).rglob("*.py"))


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(
    p.relative_to(HOME)))
def test_no_file_imports_jax_or_the_jax_package(path):
    for top, level, _ in _imports(path):
        assert level or top not in FORBIDDEN, f"{path} imports {top}"


@pytest.mark.parametrize("path", _files("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for top, level, name in _imports(path):
        if level:               # relative: only the reference's own files
            assert not name or name in ("pins", "precision", "cnn",
                                        "transformer"), name
            continue
        assert top in ("torch", "math", "contextlib", "__future__"), \
            f"{path.name} imports {name}"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert harness.forbidden_modules() == ["repro"]


def test_a_run_loads_no_forbidden_module(tiny):
    """A whole CPU run in a fresh interpreter, then its sys.modules."""
    root, cells = tiny
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(HOME.parent)!r}, {str(HOME.parent / 'src')!r}]
from portbench import harness
from pathlib import Path
bench = harness.Bench.load(Path({str(root)!r}))
r = harness.run_cell(bench, {cells['lm']!r}, 7, 0.2, True,
                     torch.device('cpu'), time.perf_counter())
assert r.correct
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN
