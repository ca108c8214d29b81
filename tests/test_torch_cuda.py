"""The CUDA kernels against their plain PyTorch versions, on the card:
the sdk kernels, tetris_matmul, grouped_matmul and flash_attention, the
last also through the attention stage at a ragged length.  Marked
``cuda``: without a CUDA device each test skips.  On the card:

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


def _rand(cuda, *shape, seed=0):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=cuda)


def _close(y, want):
    scale = float(want.abs().max())
    assert y.shape == want.shape
    assert float((y - want).abs().max()) <= RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("mnk", [
    (4096, 1536, 512), (4096, 2048, 512), (1000, 1000, 96), (130, 520, 72),
    (100, 60, 48), (33, 129, 64), (64, 64, 50), (7, 5, 3)])
def test_tetris_matmul_matches_plain(cuda, mnk):
    from repro_torch.kernels import tetris_matmul as tm
    m, n, k = mnk
    x, w = _rand(cuda, m, k, seed=1), _rand(cuda, k, n, seed=2)
    tm.reset_counts()
    y = tm.tetris_matmul(x, w)
    torch.cuda.synchronize()
    assert tm.tetris_matmul_cuda.launches == 1
    _close(y, tm.matmul_ref(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("gmdf", [
    (4, 2048, 512, 1536), (4, 2048, 1408, 512), (3, 100, 40, 72),
    (3, 50, 24, 30), (2, 17, 40, 65), (5, 8, 12, 8)])
def test_grouped_matmul_matches_plain(cuda, gmdf):
    from repro_torch.kernels import grouped_matmul as gm
    g, m, d, f = gmdf
    x, w = _rand(cuda, g, m, d, seed=3), _rand(cuda, g, d, f, seed=4)
    gm.reset_counts()
    y = gm.grouped_matmul(x, w)
    # a strided group-major weight view, as the matmul executor passes it
    wv = w.transpose(0, 1).contiguous().transpose(0, 1)
    yv = gm.grouped_matmul(x, wv)
    torch.cuda.synchronize()
    assert gm.grouped_matmul_cuda.launches == 2
    want = gm.grouped_matmul_ref(x, w)
    _close(y, want)
    _close(yv, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d,causal,q_offset", [
    (8, 512, 512, 64, True, 0), (8, 1024, 1024, 64, False, 0),
    (4, 100, 100, 16, True, 0), (4, 128, 256, 32, True, 128),
    (2, 256, 256, 128, False, 0), (3, 64, 64, 40, True, 0)])
def test_flash_attention_matches_plain(cuda, bh, sq, sk, d, causal,
                                       q_offset):
    from repro_torch.kernels import flash_attention as fa
    q = _rand(cuda, bh, sq, d, seed=5)
    k, v = _rand(cuda, bh, sk, d, seed=6), _rand(cuda, bh, sk, d, seed=7)
    fa.reset_counts()
    y = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == 1
    _close(y, fa.flash_attention_ref(q, k, v, causal=causal,
                                     q_offset=q_offset))


@pytest.mark.cuda
def test_mha_flash_gqa_matches_plain(cuda):
    from repro_torch.kernels import flash_attention as fa
    q = _rand(cuda, 2, 256, 8, 64, seed=8)
    k, v = _rand(cuda, 2, 256, 2, 64, seed=9), _rand(cuda, 2, 256, 2, 64,
                                                      seed=10)
    y = fa.mha_flash(q, k, v, causal=True)
    want = fa.flash_attention_ref(*fa.fold_heads(q, k, v), causal=True)
    _close(y, want.reshape(2, 8, 256, 64).transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("m,heads,causal", [
    (136, (32, 32, 64), True), (1500, (8, 8, 64), False),
    (200, (8, 2, 64), True)])
def test_attention_stage_ragged_launches_kernel(cuda, m, heads, causal):
    """An M that does not tile by 128 (whisper's 1500-frame window among
    them) still runs on the kernel: one launch per attention stage."""
    from repro_torch.exec import glue
    from repro_torch.kernels import flash_attention as fa
    hq, hkv, hd = heads
    y = _rand(cuda, 2, (hq + 2 * hkv) * hd, m, 1, seed=11)
    fa.reset_counts()
    got = glue.attention_stage(y, heads, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == 1
    _close(got, glue.attention_stage(y, heads, causal, plain=True))
    assert fa.flash_attention_cuda.launches == 1
