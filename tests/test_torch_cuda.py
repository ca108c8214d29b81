"""The sdk CUDA kernels against their plain PyTorch version, on the
card.  Marked ``cuda``: without a CUDA device each test skips.  On the
card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports torch only, so it runs where jax is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

#: f32, the same products summed in another order, relative to max|y|
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(name):
    from repro_torch.core import ArrayConfig, ConvLayerSpec, map_layer, map_net
    from repro_torch.core import networks
    if name == "DN40-b3l12":
        net = map_net("densenet40", networks.densenet40(),
                      ArrayConfig(512, 512), "TetrisG-SDK", groups=(1, 2, 4))
        return next(m for m in net.layers if m.layer.name == name)
    spec, arr, alg = {
        "marginal": ((18, 18, 3, 3, 32, 32), 512, "Tetris-SDK"),
        "double_buffer": ((11, 11, 3, 3, 16, 16, 2), 128, "Tetris-SDK"),
        "multi_tile": ((7, 7, 3, 3, 64, 64), 512, "Tetris-SDK"),
        "grouped": ((18, 18, 3, 3, 24, 32), 512, "TetrisG-SDK"),
        "5x5": ((12, 12, 5, 5, 16, 32), 256, "Tetris-SDK"),
    }[name]
    return map_layer(ConvLayerSpec("t", *spec), ArrayConfig(arr, arr), alg)


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["whole", "window"])
@pytest.mark.parametrize("name,batch", [
    ("marginal", 2), ("double_buffer", 3), ("multi_tile", 2),
    ("grouped", 8), ("5x5", 2), ("DN40-b3l12", 100)])
def test_kernel_matches_plain(cuda, name, batch, block):
    from repro_torch.kernels import sdk_conv as sk
    m = _layer(name)
    rng = np.random.RandomState(0)
    lay = m.layer
    x = torch.as_tensor(rng.randn(batch, lay.ic, lay.i_h, lay.i_w)
                        .astype(np.float32), device=cuda)
    k = torch.as_tensor(rng.randn(lay.k_h, lay.k_w, lay.ic // m.group,
                                  lay.oc).astype(np.float32), device=cuda)
    want = sk.sdk_conv_plain(m, x, k)
    fn = sk.sdk_window if block == "window" else sk.sdk_whole
    sk.reset_counts()
    y = sk.sdk_conv(m, x, k, block=block)
    torch.cuda.synchronize()
    assert fn.launches == len(m.tiles) * m.group
    assert fn.steps == sk.sdk_conv_cycles(m)
    scale = float(want.abs().max())
    assert float((y - want).abs().max()) <= RTOL * scale
