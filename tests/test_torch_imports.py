"""The port stands alone: src/repro_torch, chip_smoke.py and the
port's scripts (scripts/torch_*.py) import neither jax nor the JAX
package, importing the port loads neither, and
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
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    assert {f.name for f in scripts} >= {
        "torch_perf_probe.py", "torch_perf_topops.py",
        "torch_roofline_report.py"}
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + scripts
    assert len(files) > 10
    names = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"tune/__init__.py", "tune/measure.py", "tune/space.py",
            "tune/search.py", "tune/report.py", "core/simulator.py",
            "configs/cnn8.py", "configs/inception.py",
            "configs/densenet40.py", "configs/mobilenet.py",
            "models/attention.py", "configs/qwen1_5_32b.py",
            "configs/deepseek_67b.py",
            "configs/mistral_large_123b.py", "checkpoint/store.py",
            "data/pipeline.py", "optim/compression.py",
            "launch/mesh.py", "launch/sharding.py", "launch/dryrun.py",
            "launch/op_analysis.py", "launch/roofline.py"} <= names
    bad = [(f.relative_to(ROOT), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.serve_cnn, repro_torch.exec, "
            "repro_torch.cnn, repro_torch.kernels.sdk_conv, "
            "repro_torch.kernels.matmul_exec, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.launch.transformer, repro_torch.configs, "
            "repro_torch.launch.serve, repro_torch.launch.steps, "
            "repro_torch.models.transformer, repro_torch.models.weights, "
            "repro_torch.models.attention, "
            "repro_torch.kernels.ops, repro_torch.kernels.ref, "
            "repro_torch.kernels.ssd_chunk, repro_torch.kernels.im2win_conv, "
            "repro_torch.optim, repro_torch.data, repro_torch.cnn.models, "
            "repro_torch.cnn.train, repro_torch.launch.train, "
            "repro_torch.launch.fleet, repro_torch.launch.replica, "
            "repro_torch.exec.constants, repro_torch.runtime, "
            "repro_torch.tune, repro_torch.core.simulator, "
            "repro_torch.checkpoint, repro_torch.data.pipeline, "
            "repro_torch.optim.compression, repro_torch.launch.mesh, "
            "repro_torch.launch.sharding, repro_torch.launch.shapes, "
            "repro_torch.launch.dryrun, repro_torch.launch.op_analysis, "
            "repro_torch.launch.roofline\n"
            "from repro_torch.configs import CNN_IDS, get_config\n"
            "get_config('stablelm_1_6b'); get_config('whisper_base')\n"
            "[get_config(c) for c in CNN_IDS]\n"
            "get_config('mamba2_130m').param_count()\n"
            "[get_config(c).param_count() for c in ('qwen1_5_32b', "
            "'deepseek_67b', 'mistral_large_123b', 'stablelm_1_6b')]\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._loaded, 'a kernel was built at import'\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})


def test_entry_points_need_a_card(monkeypatch):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.cnn import kernels_from_numpy, params_from_numpy
    from repro_torch.cnn.models import cnn8_config
    from repro_torch.cnn.train import train_cnn, train_plan
    from repro_torch.launch import train
    from repro_torch.core import ArrayConfig, map_net, networks
    from repro_torch.device import resolve_device
    from repro_torch.exec import compile_plan
    from repro_torch.launch import serve, serve_cnn
    from repro_torch.launch.transformer import transformer_mapping
    from repro_torch.tune import autotune, tuned_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = map_net("cnn8", networks.cnn8(), ArrayConfig(512, 512),
                  "TetrisG-SDK", groups=(1, 2, 4))
    tnet = transformer_mapping("whisper_smoke", blocks=1)
    for call in (lambda: resolve_device(None),
                 lambda: compile_plan(tnet),
                 lambda: serve_cnn.serve(tnet, 1, 1),
                 lambda: resolve_device("cuda"),
                 lambda: compile_plan(net),
                 lambda: serve_cnn.serve(net, 2, 1),
                 lambda: serve_cnn.main(["--steps", "1"]),
                 lambda: serve.main(["--smoke", "--gen", "1"]),
                 lambda: serve.main(["--arch", "stablelm_1_6b", "--smoke",
                                     "--gen", "1"]),
                 lambda: kernels_from_numpy([np.zeros((1, 1, 1, 1))]),
                 lambda: params_from_numpy({"w": np.zeros(2)}),
                 lambda: train_plan(net, steps=1, batch=2),
                 lambda: train_cnn(cnn8_config(), steps=1),
                 lambda: train.main(["--plan-net", "cnn8", "--steps", "1"]),
                 lambda: train.main(["--arch", "stablelm_1_6b", "--smoke",
                                     "--steps", "1"]),
                 lambda: restore_checkpoint("unused", {}),
                 lambda: serve_cnn.serve_dynamic(net, [(0.0, 1)],
                                                 max_batch=2,
                                                 max_delay_ms=1.0),
                 lambda: serve_cnn.main(["--max-delay-ms", "1"]),
                 lambda: serve_cnn.main(["--fleet", "cnn8"]),
                 lambda: serve_cnn.main(["--replicas", "1"]),
                 lambda: serve_cnn.main(["--steps", "1", "--autotune"]),
                 lambda: serve_cnn.main(["--steps", "1", "--policy",
                                         "tuned"]),
                 lambda: autotune(net, batch=2),
                 lambda: tuned_config(net, batch=2),
                 lambda: compile_plan(net, executor_policy="tuned")):
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
    from repro_torch.kernels import im2win_conv, ssd_chunk
    with pytest.raises(ValueError, match="CUDA tensor"):
        im2win_conv.im2win_conv_cuda(x.permute(0, 2, 3, 1), k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_chunk.ssd_chunk_cuda(torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2),
                                 torch.zeros(2), torch.zeros(1, 8, 1, 4),
                                 torch.zeros(1, 8, 1, 4), chunk=8)
    assert im2win_conv.im2win_conv_cuda.launches == 0
    assert ssd_chunk.ssd_chunk_cuda.launches == 0


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """A kernel library is keyed by its source and by every header of
    csrc/: changing a header (window_product.cuh, which two sources
    include) rebuilds every library, and changing one source only its
    own."""
    from repro_torch.kernels import _build
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "b.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {s: _build.library_path(s) for s in ("a.cu", "b.cu")}
    assert before["a.cu"].parent == _build.BUILD_DIR
    (tmp_path / "shared.cuh").write_text("// v2\n")
    after = {s: _build.library_path(s) for s in ("a.cu", "b.cu")}
    assert all(after[s] != before[s] for s in after)
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n// a2\n')
    assert _build.library_path("a.cu") != after["a.cu"]
    assert _build.library_path("b.cu") == after["b.cu"]


def test_ptxas_report_uses_the_build_command(tmp_path, monkeypatch):
    """The ptxas report builds with the committed flags plus -Xptxas -v
    (the same command line as a library build, flags unchanged) and keeps
    only ptxas's info and spill lines."""
    import subprocess
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    assert _build.command("a.cu", "a.so") == \
        ["nvcc", *_build.NVCC_FLAGS, "-o", "a.so", str(_build.CSRC / "a.cu")]
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", (
            "ptxas info    : Used 167 registers\n"
            "noise\n"
            "    0 bytes stack frame, 0 bytes spill stores\n"))
    monkeypatch.setattr(_build.subprocess, "run", run)
    text = _build.ptxas_report("im2win_conv.cu", tmp_path)
    assert seen == [_build.command("im2win_conv.cu",
                                   str(tmp_path / "im2win_conv.so"),
                                   ("-Xptxas", "-v"))]
    assert text.splitlines() == ["ptxas info    : Used 167 registers",
                                 "    0 bytes stack frame, 0 bytes spill "
                                 "stores"]
    assert _build.main([]) == 2
