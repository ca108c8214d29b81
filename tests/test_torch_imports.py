"""The port stands alone: src/repro_torch and chip_smoke.py import
neither jax nor the JAX package, importing the port loads neither, and
its entry points run on the card unless the caller asks for the CPU —
without a card they raise instead of falling back."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.serve_cnn, repro_torch.exec, "
            "repro_torch.cnn, repro_torch.kernels.sdk_conv\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._loaded, 'a kernel was built at import'\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})


def test_entry_points_need_a_card(monkeypatch):
    from repro_torch.cnn import kernels_from_numpy
    from repro_torch.core import ArrayConfig, map_net, networks
    from repro_torch.device import resolve_device
    from repro_torch.exec import compile_plan
    from repro_torch.launch import serve_cnn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = map_net("cnn8", networks.cnn8(), ArrayConfig(512, 512),
                  "TetrisG-SDK", groups=(1, 2, 4))
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: compile_plan(net),
                 lambda: serve_cnn.serve(net, 2, 1),
                 lambda: serve_cnn.main(["--steps", "1"]),
                 lambda: kernels_from_numpy([np.zeros((1, 1, 1, 1))])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert compile_plan(net, device="cpu").device == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers check their operands before loading anything:
    a CPU tensor is refused, never computed some other way."""
    from repro_torch.core import ArrayConfig, ConvLayerSpec, map_layer
    from repro_torch.kernels import sdk_conv as sk
    m = map_layer(ConvLayerSpec("t", 18, 18, 3, 3, 24, 32),
                  ArrayConfig(512, 512), "VW-SDK")
    x = torch.zeros(2, 24, 18, 18)
    k = torch.zeros(3, 3, 24, 32)
    for c in sk.tile_calls(m, x, k):
        for fn in (sk.sdk_whole, sk.sdk_window):
            with pytest.raises(ValueError, match="CUDA tensor"):
                fn(c.xt, c.kt, c.geom)
