"""The CUDA kernels against their plain PyTorch versions, on the card:
the sdk kernels (the whole kernel's blocks held to its launch rule, the
window kernel also with runs of windows and at stride 2), tetris_matmul
and grouped_matmul (both instances of their GEMM body, the blocks
launched held to the launch rule), flash_attention (both block heights,
both staging instances, f32 and bf16), the last also through the
attention stage at a ragged length, ssd_chunk (f32, and bf16 on the
tensor cores at every head-slice width and both staging instances, the
blocks held to the launch rule; also through the SSD mixer) and
im2win_conv (also through the ops surface, with each of its
kernels, in f32 and bf16); and training: the executors' gradients
against F.conv2d's, the kernel entry points refusing autograd, and the
plan trainer on the card against the CPU; a small autotune over the
sdk block modes; the decoder attention family, which has no kernel:
its prefill/decode consistency in f32 and the card against the CPU at
the smoke configs, and ``attention`` card against CPU; and the same for
MoE, MLA, RG-LRU, the vision prefix and the encoder-decoder, with
``moe.route``'s order on ties on the card; the LM train step on the card
against the CPU (no kernel launched) and a checkpoint restored onto the
card.  Marked
``cuda``: without a CUDA device each test skips.  On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports torch only, so it runs where jax is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

#: f32, the same products summed in another order, relative to max|y|
RTOL = 1e-5
#: a bf16 result against the plain version in f32 on the same values: one
#: bf16 rounding of y plus the f32 summation order, relative to max|y|
BF16_RTOL = 2.0 ** -8 + RTOL


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
    if block == "whole":            # the blocks the C entry launched
        assert sk.sdk_whole.blocks == m.group * sum(
            sk.whole_launch_dims(batch, sk.tile_geom(m, t)).blocks
            for t in m.tiles)
    scale = float(want.abs().max())
    assert float((y - want).abs().max()) <= RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,run,stride", [
    ("marginal", 32, 3, 1), ("double_buffer", 32, 3, 2),
    ("double_buffer", 3, 1, 2), ("5x5", 100, 10, 1)])
def test_sdk_window_runs_and_stride(cuda, name, batch, run, stride):
    """The window kernel with a run of windows per block (its cp.async
    double buffer in use) and at stride 2, against the plain version;
    the output is allocated without a zero fill (covers_output)."""
    from repro_torch.kernels import sdk_conv as sk
    m = _layer(name)
    g0 = sk.tile_geom(m, m.tiles[0])
    assert (sk.window_launch_dims(batch, g0).run, g0.s) == (run, stride)
    assert all(sk.tile_geom(m, t).covers_output for t in m.tiles)
    rng = np.random.RandomState(1)
    lay = m.layer
    x = torch.as_tensor(rng.randn(batch, lay.ic, lay.i_h, lay.i_w)
                        .astype(np.float32), device=cuda)
    k = torch.as_tensor(rng.randn(lay.k_h, lay.k_w, lay.ic // m.group,
                                  lay.oc).astype(np.float32), device=cuda)
    sk.reset_counts()
    y = sk.sdk_conv(m, x, k, block="window")
    torch.cuda.synchronize()
    assert sk.sdk_window.launches == len(m.tiles) * m.group
    assert sk.sdk_window.steps == sk.sdk_conv_cycles(m)
    want = sk.sdk_conv_plain(m, x, k)
    assert float((y - want).abs().max()) <= RTOL * float(want.abs().max())


def _rand(cuda, *shape, seed=0):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=cuda)


def _close(y, want, rtol=RTOL):
    scale = float(want.abs().max())
    assert y.shape == want.shape
    assert float((y - want).abs().max()) <= rtol * scale


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


#: (M, N, K, x's column offset in a wider buffer, 16-byte instance?):
#: tile multiples and +-1 in each of M, N and K at both block tiles; a K
#: or N that is not a multiple of 4 and an x offset by one float take
#: the 4-byte instance
GEMM_CASES = [
    (256, 256, 64, 0, True), (255, 256, 64, 0, True),
    (257, 256, 64, 0, True), (256, 255, 64, 0, False),
    (256, 257, 64, 0, False), (256, 260, 64, 0, True),
    (256, 256, 63, 0, False), (256, 256, 65, 0, False),
    (256, 256, 68, 0, True), (4096, 512, 2047, 0, False),
    (17000, 384, 32, 0, True), (129, 129, 33, 0, False),
    (256, 256, 64, 1, False), (300, 200, 100, 4, True),
    (300, 200, 100, 3, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,off,vector", GEMM_CASES)
def test_tetris_matmul_both_instances(cuda, m, n, k, off, vector):
    """Both instances of the GEMM body against the plain version, with
    the blocks the C entry reports held to gemm_launch_dims."""
    from repro_torch.kernels import tetris_matmul as tm
    x = _rand(cuda, m, k + off, seed=5)[:, off:]
    w = _rand(cuda, k, n, seed=6)
    out = torch.empty(m, n, device=cuda)
    assert tm.vector_staging(x, w, out) == vector
    tm.reset_counts()
    y = tm.tetris_matmul(x, w)
    torch.cuda.synchronize()
    assert tm.tetris_matmul_cuda.launches == 1
    assert tm.tetris_matmul_cuda.blocks == tm.gemm_launch_dims(
        1, m, n, tm.sm_count(cuda)).blocks
    _close(y, tm.matmul_ref(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("gmdf,vector", [
    ((4, 2048, 512, 1408), True), ((4, 2048, 1408, 512), True),
    ((4, 127, 64, 128), True), ((4, 129, 64, 128), True),
    ((3, 128, 63, 128), False), ((3, 128, 65, 128), False),
    ((3, 128, 68, 132), True),
    ((2, 128, 64, 127), False), ((2, 128, 64, 129), False),
    ((5, 100, 40, 30), False)])
def test_grouped_matmul_weight_view_in_place(cuda, gmdf, vector):
    """The matmul executor's group-major weight view, kernel (D, G*F)
    read in place as (G, D, F), through both instances, at tile
    multiples and +-1 in M, D and F."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import tetris_matmul as tm
    g, m, d, f = gmdf
    x = _rand(cuda, g, m, d, seed=7)
    w = _rand(cuda, d, g * f, seed=8).reshape(d, g, f).transpose(0, 1)
    assert tm.vector_staging(x, w, torch.empty(g, m, f, device=cuda)) \
        == vector
    gm.reset_counts()
    y = gm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert gm.grouped_matmul_cuda.launches == 1
    assert gm.grouped_matmul_cuda.blocks == tm.gemm_launch_dims(
        g, m, f, tm.sm_count(cuda)).blocks
    _close(y, gm.grouped_matmul_ref(x, w))


#: (BH, Sq, Sk, D, causal, q_offset): the served shapes, ragged lengths
#: (136, whisper's 1500), queries after their keys, and D 16 to 128 (D 100
#: and 63 run on the next instance up, 63 with 4-byte staging)
FLASH_CASES = [
    (8, 512, 512, 64, True, 0), (8, 1024, 1024, 64, False, 0),
    (4, 100, 100, 16, True, 0), (4, 128, 256, 32, True, 128),
    (2, 256, 256, 128, False, 0), (3, 64, 64, 40, True, 0),
    (4, 136, 136, 64, True, 0), (4, 1500, 1500, 64, False, 0),
    (2, 72, 1500, 64, True, 1428), (2, 300, 300, 100, True, 0),
    (2, 200, 330, 128, True, 130), (2, 257, 257, 32, False, 0),
    (2, 130, 130, 63, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d,causal,q_offset", FLASH_CASES)
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
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("bh,sq,sk,d,causal,q_offset", [
    (8, 512, 512, 64, True, 0), (4, 1500, 1500, 64, False, 0),
    (2, 200, 330, 32, True, 130), (2, 130, 130, 63, True, 0)])
def test_flash_attention_both_block_heights(cuda, bh, sq, sk, d, causal,
                                            q_offset, rows):
    """64- and 128-row blocks (the launch rule's two choices), on an
    aligned and on a misaligned base (the 4-byte instance at D 64)."""
    from repro_torch.kernels import flash_attention as fa
    q = _rand(cuda, bh * sq * d + 1, seed=8)[1:].view(bh, sq, d)
    k, v = _rand(cuda, bh, sk, d, seed=9), _rand(cuda, bh, sk, d, seed=10)
    assert q.is_contiguous() and not fa.vector_staging(q)
    for qq in (q, q.clone()):
        y = fa.flash_attention_cuda(qq, k, v, causal=causal,
                                    q_offset=q_offset, rows=rows)
        torch.cuda.synchronize()
        _close(y, fa.flash_attention_ref(q, k, v, causal=causal,
                                         q_offset=q_offset))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d,causal,q_offset", [
    (8, 512, 512, 64, True, 0), (4, 1500, 1500, 64, False, 0),
    (2, 72, 1500, 64, True, 1428), (2, 300, 300, 100, True, 0),
    (2, 256, 256, 128, False, 0), (2, 257, 257, 32, True, 0)])
def test_flash_attention_bf16(cuda, bh, sq, sk, d, causal, q_offset):
    """bf16 in and out, f32 inside: within one bf16 rounding of the plain
    version in f32 on the same bf16 values; D 100 takes the element-wise
    staging, the others 16-byte loads."""
    from repro_torch.kernels import flash_attention as fa
    q = _rand(cuda, bh, sq, d, seed=11).bfloat16()
    k = _rand(cuda, bh, sk, d, seed=12).bfloat16()
    v = _rand(cuda, bh, sk, d, seed=13).bfloat16()
    y = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    _close(y.float(), fa.flash_attention_ref(
        q.float(), k.float(), v.float(), causal=causal, q_offset=q_offset),
        BF16_RTOL)


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


def _ssd_inputs(cuda, b, s, h, p, g, n, dtype=torch.float32, seed=12):
    """The JAX kernel test's distributions (dt > 0 small, a_log ~ 0)."""
    rng = np.random.RandomState(seed)

    def dev(a):
        return torch.as_tensor(a.astype(np.float32), device=cuda).to(dtype)
    return (dev(rng.randn(b, s, h, p)),
            dev(np.abs(rng.randn(b, s, h)) * 0.1 + 0.05),
            torch.as_tensor((rng.randn(h) * 0.3).astype(np.float32),
                            device=cuda),
            dev(rng.randn(b, s, g, n) * 0.3), dev(rng.randn(b, s, g, n) * 0.3))


#: (B, S, H, P, G, N), L: the JAX test's shape (G == H) at two chunks,
#: L = 100 and 48 off the 64-row tile, P 40, N 8, 24 and 256, G < H
SSD_SHAPES = [
    ((2, 128, 4, 16, 4, 8), 128), ((2, 128, 4, 16, 4, 8), 32),
    ((1, 512, 4, 64, 1, 128), 256), ((2, 100, 3, 32, 1, 16), 100),
    ((1, 256, 4, 128, 2, 256), 128), ((2, 96, 6, 40, 3, 24), 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", SSD_SHAPES)
def test_ssd_chunk_matches_plain(cuda, shape, chunk):
    """f32: y and the states within RTOL of their max; G < H read in
    place; L = 100 is no multiple of the 64-row tile."""
    from repro_torch.kernels import ssd_chunk as sc
    args = _ssd_inputs(cuda, *shape)
    sc.reset_counts()
    y, st = sc.ssd_chunk(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert sc.ssd_chunk_cuda.launches == 1
    want_y, want_s = sc.ssd_chunk_plain(*args, chunk=chunk)
    _close(y, want_y)
    _close(st, want_s)


def _ssd_bf16_check(args, chunk, slice_heads=0):
    """The bf16 kernel on ``args`` against the plain version in f32 on the
    same values: y within one bf16 rounding of max|y|, the states (f32)
    within RTOL of max|S|; one launch of the rule's blocks."""
    from repro_torch.kernels import ssd_chunk as sc
    x, dt, a_log, b, c = args
    want_y, want_s = sc.ssd_chunk_plain(
        *(a.float() for a in (x, dt)), a_log, b.float(), c.float(),
        chunk=chunk)
    sc.reset_counts()
    y, st = sc.ssd_chunk_cuda(*args, chunk=chunk, slice_heads=slice_heads)
    torch.cuda.synchronize()
    lay = sc.ssd_launch_dims(x.shape[0], x.shape[1], x.shape[2], x.shape[3],
                             b.shape[2], b.shape[3], chunk,
                             torch.cuda.get_device_properties(
                                 x.device).multi_processor_count,
                             slice_heads=slice_heads)
    assert sc.ssd_chunk_cuda.launches == 1
    assert sc.ssd_chunk_cuda.blocks == lay.blocks
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    _close(y, want_y, BF16_RTOL)
    _close(st, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", SSD_SHAPES)
def test_ssd_chunk_bf16_matches_plain(cuda, shape, chunk):
    """The bf16 instance (tensor cores) at every shape of the f32 test,
    with the rule's head slice and with every slice width the kernel has
    there."""
    from repro_torch.kernels import ssd_chunk as sc
    args = _ssd_inputs(cuda, *shape, torch.bfloat16)
    b, s, h, p, g, n = shape
    _ssd_bf16_check(args, chunk)
    for w in sc.SLICE_HEADS:
        try:
            sc.ssd_launch_dims(b, s, h, p, g, n, chunk, 132, slice_heads=w)
        except ValueError:
            continue                 # no instance of that width here
        _ssd_bf16_check(args, chunk, w)


@pytest.mark.cuda
def test_ssd_chunk_bf16_element_staging(cuda):
    """Views whose rows are not 16-byte aligned (one bf16 into a buffer)
    take the element-wise staging, read in place."""
    from repro_torch.kernels import ssd_chunk as sc
    b, s, h, p, g, n = 2, 256, 4, 64, 2, 128
    x, dt, a_log, bm, cm = _ssd_inputs(cuda, b, s, h, p, g, n,
                                       torch.bfloat16)

    def shifted(t):
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)
    args = (shifted(x), dt, a_log, shifted(bm), shifted(cm))
    assert not sc.vector_staging(args[0], args[3], args[4])
    _ssd_bf16_check(args, 128)


@pytest.mark.cuda
def test_ssd_chunk_bf16_and_strided_views(cuda):
    """bf16 inputs as the model passes them (views of one projection,
    unit last stride): y within one bf16 rounding (2**-8) of max|y| of the
    plain version run in f32 on the same values; states (f32 both) within
    RTOL."""
    from repro_torch.kernels import ssd_chunk as sc
    b, s, h, p, g, n = 2, 512, 4, 64, 1, 128
    x, dt, a_log, bm, cm = _ssd_inputs(cuda, b, s, h, p, g, n, torch.bfloat16)
    proj = torch.cat([x.reshape(b, s, h * p), bm.reshape(b, s, n),
                      cm.reshape(b, s, n)], -1)
    xv = proj[..., :h * p].reshape(b, s, h, p)
    bv = proj[..., h * p:h * p + n].reshape(b, s, g, n)
    cv = proj[..., h * p + n:].reshape(b, s, g, n)
    assert not xv.is_contiguous()
    y, st = sc.ssd_chunk(xv, dt, a_log, bv, cv, chunk=256)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    want_y, want_s = sc.ssd_chunk_plain(
        *(a.float() for a in (x, dt)), a_log, bm.float(), cm.float(),
        chunk=256)
    scale = float(want_y.abs().max())
    assert float((y.float() - want_y).abs().max()) <= 2.0 ** -8 * scale
    _close(st, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2000, 100])
def test_ssd_chunked_kernel_matches_plain(cuda, s):
    """The mixer at a ragged prompt (padded to the chunk) and at S < chunk
    (L = S), kernel against plain=True."""
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import ssm
    cfg = ssm.SSMConfig(d_inner=256, n_heads=4, head_dim=64, d_state=128,
                        chunk=256)
    x, dt, a_log, b, c = _ssd_inputs(cuda, 2, s, 4, 64, 1, 128)
    d = torch.ones(4, device=cuda)
    sc.reset_counts()
    y, st = ssm.ssd_chunked(x, dt, a_log, b, c, d, cfg)
    want_y, want_s = ssm.ssd_chunked(x, dt, a_log, b, c, d, cfg, plain=True)
    torch.cuda.synchronize()
    assert sc.ssd_chunk_cuda.launches == 1
    _close(y, want_y)
    _close(st, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    (2, 18, 18, 24, 3, 32), (1, 12, 12, 8, 5, 16), (2, 9, 9, 32, 3, 64),
    (1, 7, 7, 3, 3, 5), (2, 28, 28, 32, 5, 96), (2, 5, 5, 64, 5, 256),
    (2, 14, 14, 32, 5, 128), (1, 40, 40, 8, 3, 70)])
def test_im2win_conv_matches_plain(cuda, cfg):
    """The JAX kernel test's shapes and the paper's heaviest and
    smallest windows (Incep-3b, CNN8-7 with one position, Incep-4e) and
    an oc that 4 x 16 does not divide; one launch runs n_cycles grid
    steps, each a cluster of cluster_split's size, so the blocks are
    steps x cluster, as the C entry reports them launched.  A (3, 5)
    window clamps its borders."""
    from repro_torch.kernels import im2win_conv as iw
    b, h, w, c, k, o = cfg
    x = _rand(cuda, b, h, w, c, seed=13)
    kk = _rand(cuda, k, k, c, o, seed=14) * 0.1
    want = iw.im2win_conv_plain(x, kk)
    for window in (None, (3, 5)):
        iw.reset_counts()
        y = iw.im2win_conv(x, kk, window=window)
        torch.cuda.synchronize()
        o_h, o_w, th, tw = iw.conv_window(x.shape, kk.shape, window)
        cluster, _ = iw.cluster_split(th, tw, o, c, k, k)
        assert iw.im2win_conv_cuda.launches == 1
        assert iw.im2win_conv_cuda.steps == iw.n_cycles(o_h, o_w, th, tw, b)
        assert iw.im2win_conv_cuda.blocks == \
            iw.im2win_conv_cuda.steps * cluster
        _close(y, want)


@pytest.mark.cuda
def test_ops_surface_launches_each_kernel(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import im2win_conv as iw
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tetris_matmul as tm
    for mod in (fa, gm, iw, tm):
        mod.reset_counts()
    x, w = _rand(cuda, 130, 72, seed=15), _rand(cuda, 72, 40, seed=16)
    _close(ops.matmul(x, w), ref.matmul_ref(x, w))
    g, gw = _rand(cuda, 3, 50, 24, seed=17), _rand(cuda, 3, 24, 30, seed=18)
    _close(ops.gmm(g, gw), ref.grouped_matmul_ref(g, gw))
    q = _rand(cuda, 4, 100, 32, seed=19)
    _close(ops.attention(q, q, q), ref.flash_attention_ref(q, q, q))
    xc, kc = _rand(cuda, 2, 9, 9, 16, seed=20), _rand(cuda, 3, 3, 16, 8,
                                                       seed=21)
    _close(ops.conv2d(xc, kc), ref.conv2d_ref(xc, kc))
    assert (tm.tetris_matmul_cuda.launches, gm.grouped_matmul_cuda.launches,
            fa.flash_attention_cuda.launches,
            iw.im2win_conv_cuda.launches) == (1, 1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["matmul", "gmm", "attention", "conv2d"])
def test_ops_bf16_matches_plain(cuda, op):
    """The four wrappers on bf16 operands: one launch of their kernel, a
    bf16 result within one bf16 rounding of the plain version in f32 on
    the same values."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import im2win_conv as iw
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tetris_matmul as tm
    args, plain, counter = {
        "matmul": (((130, 72), (72, 40)), ref.matmul_ref,
                   tm.tetris_matmul_cuda),
        "gmm": (((3, 50, 24), (3, 24, 30)), ref.grouped_matmul_ref,
                gm.grouped_matmul_cuda),
        "attention": (((4, 100, 32),) * 3, ref.flash_attention_ref,
                      fa.flash_attention_cuda),
        "conv2d": (((2, 9, 9, 16), (3, 3, 16, 8)), ref.conv2d_ref,
                   iw.im2win_conv_cuda)}[op]
    xs = [_rand(cuda, *shape, seed=22 + i).bfloat16()
          for i, shape in enumerate(args)]
    for mod in (fa, gm, iw, tm):
        mod.reset_counts()
    y = getattr(ops, op)(*xs)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and counter.launches == 1
    _close(y.float(), plain(*(x.float() for x in xs)), BF16_RTOL)


# ------------------------------------------------------------- training

def _grads(fn, x, k):
    x, k = x.clone().requires_grad_(True), k.clone().requires_grad_(True)
    return torch.autograd.grad((fn(x, k) ** 2).sum(), (x, k))


@pytest.mark.cuda
@pytest.mark.parametrize("array,groups", [(64, (1, 2, 4, 8)),
                                          (512, (1, 2, 4))])
def test_executor_gradients_match_conv2d(cuda, array, groups):
    """cim_conv2d's and mapped_conv2d's gradients on the card against
    F.conv2d autograd (TF32 off) on cnn8's layers: each output position
    has one writer, so no gradient is counted twice."""
    from repro_torch.cnn import cim_conv2d, mapped_conv2d
    from repro_torch.core import ArrayConfig, MacroGrid, map_net, networks
    net = map_net("cnn8", networks.cnn8(), ArrayConfig(array, array),
                  "TetrisG-SDK", MacroGrid(1, 1), groups=groups)
    rng = np.random.RandomState(0)
    for m in net.layers:
        lay = m.layer
        x = torch.as_tensor(rng.randn(4, lay.ic, lay.i_h, lay.i_w)
                            .astype(np.float32), device=cuda)
        k = torch.as_tensor(rng.randn(lay.k_h, lay.k_w, lay.ic // m.group,
                                      lay.oc).astype(np.float32), device=cuda)
        want = _grads(lambda x, k: torch.nn.functional.conv2d(
            x, k.permute(3, 2, 0, 1), groups=m.group), x, k)
        for fn in (cim_conv2d, mapped_conv2d):
            for got, ref in zip(_grads(lambda x, k: fn(m, x, k), x, k),
                                want):
                err = float((got - ref).abs().max())
                assert err <= 1e-4 * float(ref.abs().max()), lay.name


@pytest.mark.cuda
def test_kernel_entry_points_refuse_autograd(cuda):
    from repro_torch.kernels import ops
    a = torch.randn(64, 32, device=cuda, requires_grad=True)
    b = torch.randn(32, 16, device=cuda)
    with pytest.raises(RuntimeError, match="has no backward"):
        ops.matmul(a, b)
    with torch.no_grad():
        assert ops.matmul(a, b).shape == (64, 16)


@pytest.mark.cuda
def test_train_plan_card_matches_cpu(cuda):
    """cnn8's plan trainer on the card and on the CPU from the same
    draws: per-step losses within 1e-3 relative, no kernel launched."""
    from repro_torch.cnn.train import train_plan
    from repro_torch.kernels import sdk_conv as sk
    from repro_torch.launch.train import plan_net_mapping
    net = plan_net_mapping("cnn8")
    sk.reset_counts()
    losses = {}
    for dev in ("cpu", "cuda"):
        losses[dev] = []
        train_plan(net, steps=3, batch=8, accum=2, remat="auto",
                   losses=losses[dev], device=dev)
    assert sk.sdk_whole.launches == sk.sdk_window.launches == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


# ---------------------------------------------------------------------------
# arrival-driven serving on the card
# ---------------------------------------------------------------------------

def _cnn8_512():
    from repro_torch.core import ArrayConfig
    from repro_torch.launch.serve_cnn import map_for_serving
    return map_for_serving("cnn8", ArrayConfig(512, 512), "TetrisG-SDK")[0]


def _served_launches():
    """{kernel: launches} under the keys of
    `NetworkPlan.launches_per_forward`."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import sdk_conv as sk
    from repro_torch.kernels import tetris_matmul as tm
    return {"sdk_whole": sk.sdk_whole.launches,
            "sdk_window": sk.sdk_window.launches,
            "tetris_matmul": tm.tetris_matmul_cuda.launches,
            "grouped_matmul": gm.grouped_matmul_cuda.launches,
            "flash_attention": fa.flash_attention_cuda.launches}


def _reset_served():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import sdk_conv as sk
    from repro_torch.kernels import tetris_matmul as tm
    for mod in (sk, tm, gm, fa):
        mod.reset_counts()


@pytest.mark.cuda
def test_serve_dynamic_backlogged_cnn8(cuda):
    """serve_dynamic, cnn8 under auto, backlogged: every request served,
    the sdk launches those of the tier plans over the served batches,
    and at each tier served the request rows of a zero-padded forward
    equal the oracle on those rows within 1e-4 of max|y|."""
    from repro_torch.exec import compile_plan, execute_oracle, execute_plan
    from repro_torch.launch import serve_cnn
    net = _cnn8_512()
    reqs = serve_cnn.poisson_arrivals(32, 0.0, 4, seed=0)
    _reset_served()
    s = serve_cnn.serve_dynamic(net, reqs, max_batch=8, max_delay_ms=2.0,
                                policy="auto", warmup=1, device=cuda)
    got = _served_launches()
    assert s.request_images == sum(r for _, r in reqs)
    want = dict.fromkeys(got, 0)
    ks, xh = serve_cnn.serving_inputs(net, 8, 0, cuda)
    any_batch = compile_plan(net, executor_policy="auto", device=cuda)
    for tier, ts in s.tiers.items():
        plan = compile_plan(net, executor_policy="auto", batch=tier,
                            device=cuda)
        for k, n in plan.launches_per_forward().items():
            want[k] += (ts.batches + 1) * n
        rows = max(1, tier - 1)
        x = torch.zeros((tier,) + xh.shape[1:], device=cuda)
        x[:rows] = torch.as_tensor(xh[:rows], device=cuda)
        y = execute_plan(plan, ks, x)[:rows]
        ref = execute_oracle(any_batch, ks, x[:rows])
        assert float((y - ref).abs().max()) <= \
            1e-4 * float(ref.abs().max())
    assert want["sdk_whole"] + want["sdk_window"] > 0 and got == want


@pytest.mark.cuda
def test_serve_fleet_cnn8_whisper_smoke_launches(cuda):
    """serve_fleet of cnn8 and whisper_smoke under auto: every request
    served, and the sdk, tetris_matmul and flash_attention launches equal
    the tier plans' over the served batches (one warm-up a tier)."""
    from repro_torch.exec import compile_plan
    from repro_torch.launch import fleet
    from repro_torch.launch.transformer import transformer_mapping
    maps = {"cnn8": _cnn8_512(),
            "whisper_smoke": transformer_mapping("whisper_smoke")}
    cfg = fleet.FleetConfig(models=tuple(
        fleet.ModelSpec(n, max_batch=4, max_delay_s=0.002) for n in maps))
    trace = fleet.mixed_poisson_trace(list(maps), 24, 200.0, 4, seed=0)
    _reset_served()
    stats, _ = fleet.serve_fleet(maps, cfg, trace, policy="auto",
                                 device=cuda)
    got = _served_launches()
    assert stats.request_images == sum(r for _, _, r in trace)
    want = dict.fromkeys(got, 0)
    for name, net in maps.items():
        for tier in fleet.batching.batch_tiers(4):
            ts = stats.models[name].tiers.get(tier)
            plan = compile_plan(net, executor_policy="auto", batch=tier,
                                device=cuda)
            for k, n in plan.launches_per_forward().items():
                want[k] += (1 + (ts.batches if ts else 0)) * n
    assert got == want
    assert want["sdk_whole"] + want["sdk_window"] > 0
    assert want["tetris_matmul"] > 0 and want["flash_attention"] > 0


@pytest.mark.cuda
def test_execute_plan_constants_bitwise(cuda):
    """cnn8 under the mapped executor on the card: the constants-fed
    forward is bitwise the forward without them, at two tiers sharing
    one handle."""
    from repro_torch.exec import compile_plan, execute_plan, prepare_constants
    from repro_torch.launch import serve_cnn
    net = _cnn8_512()
    ks, xh = serve_cnn.serving_inputs(net, 4, 0, cuda)
    c = None
    for tier in (2, 4):
        plan = compile_plan(net, executor_policy="mapped", batch=tier,
                            device=cuda)
        c = c or prepare_constants(plan, ks)
        x = torch.as_tensor(xh[:tier], device=cuda)
        assert torch.equal(execute_plan(plan, ks, x, constants=c),
                           execute_plan(plan, ks, x))


def _tune_launches(net, res, budget, batch, device):
    """The sdk launches a search makes: every trial's rounds plus its
    warm-up steps, times its candidate plan's launches a forward."""
    from repro_torch.exec import compile_plan
    want = dict.fromkeys(_served_launches(), 0)
    for t in res.trials:
        c = t.candidate
        plan = compile_plan(net, executor_policy=c.policy, batch=batch,
                            lookahead=c.lookahead, block=c.block,
                            vmem_budget=c.vmem_budget, device=device)
        for k, n in plan.launches_per_forward().items():
            want[k] += (t.rounds + budget.warmup) * n
    return want


@pytest.mark.cuda
def test_autotune_on_the_card(cuda):
    """A small search on the card over the sdk block modes (cnn8 at
    512x512, batch 2, SMOKE_BUDGET): its launches are the candidate
    plans' over the measured and warm-up steps, the winner's fleet is the
    card's, and the winner's forward matches the oracle."""
    from repro_torch import tune
    from repro_torch.core import memo
    from repro_torch.exec import compile_plan, execute_oracle, execute_plan
    from repro_torch.launch import serve_cnn
    net = _cnn8_512()
    memo.clear()
    space = tune.enumerate_space(net, batch=2, device=cuda, lookaheads=(1,),
                                 blocks=("auto", "whole", "window"))
    _reset_served()
    res = tune.autotune(net, batch=2, device=cuda, space=space,
                        budget=tune.SMOKE_BUDGET, store=False)
    got = _served_launches()
    assert got == _tune_launches(net, res, tune.SMOKE_BUDGET, 2, cuda)
    assert got["sdk_whole"] > 0 and got["sdk_window"] > 0
    assert res.config.fleet == ("cuda", torch.cuda.device_count())
    assert res.config.median_s <= res.config.baseline_s
    c = res.config.candidate
    plan = compile_plan(net, executor_policy=c.policy, batch=2,
                        lookahead=c.lookahead, block=c.block,
                        vmem_budget=c.vmem_budget, device=cuda)
    ks, xh = serve_cnn.serving_inputs(net, 2, 0, cuda)
    x = torch.as_tensor(xh, device=cuda)
    y = execute_plan(plan, ks, x)
    r = execute_oracle(plan, ks, x)
    assert torch.isfinite(y).all()
    assert float((y - r).abs().max()) <= 1e-4 * float(r.abs().max())
    memo.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "qwen1_5_32b",
                                  "deepseek_67b"])
def test_gqa_decoder_on_the_card(cuda, arch, monkeypatch):
    """The attention family at its smoke config, in f32 compute (TF32
    off), the weights drawn once on the CPU: on the card, the decode
    logits at position S after a prefill of S tokens within 1e-3 of
    max|logit| of the train forward's at S, with the same argmax; the
    card's train logits within 1e-4 of the CPU's; and no kernel
    launched (the path has none)."""
    from repro_torch.configs import get_config
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    monkeypatch.setattr(common, "COMPUTE_DTYPE", torch.float32)
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    on_card = T.tree_map(lambda a: a.to(cuda), params)
    s = 40
    toks = torch.randint(0, cfg.vocab, (2, s + 1),
                         generator=torch.Generator().manual_seed(1))
    _reset_served()
    full = T.forward(on_card, cfg, tokens=toks.to(cuda), mode="train")
    _, cache = T.forward(on_card, cfg, tokens=toks[:, :s].to(cuda),
                         mode="prefill", cache_len=s + 8)
    dl, _ = T.forward(on_card, cfg, tokens=toks[:, s:].to(cuda),
                      mode="decode", cache=cache, pos=s)
    torch.cuda.synchronize()
    assert not any(_served_launches().values())
    a, b = full[:, s], dl[:, 0]
    assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max())
    assert torch.equal(a.argmax(-1), b.argmax(-1))
    cpu = T.forward(params, cfg, tokens=toks, mode="train")
    assert float((full.cpu() - cpu).abs().max()) <= \
        1e-4 * float(cpu.abs().max())


#: (sq, sk, hq, hkv, causal, window, q_offset, kv_len, q_block): cases of
#: tests/test_torch_attention.py (MHA, GQA, MQA decode, a window with
#: padded q blocks, a window streamed from an offset)
ATTENTION_CASES = [(20, 20, 8, 8, True, None, 0, None, 512),
                   (20, 20, 8, 2, False, None, 0, None, 512),
                   (1, 24, 8, 1, True, None, 13, 14, 512),
                   (20, 20, 8, 2, True, 6, 0, None, 8),
                   (40, 48, 8, 2, True, 6, 8, 48, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTENTION_CASES)
def test_attention_card_matches_cpu(cuda, dtype, case):
    """``models.attention.attention`` (plain PyTorch ops on either
    device): the card within 1e-5 of max|y| of the CPU in f32, one bf16
    rounding more in bf16."""
    from repro_torch.models import attention as A
    sq, sk, hq, hkv, causal, window, q_offset, kv_len, q_block = case
    rng = np.random.RandomState(sq + sk)
    q, k, v = (torch.as_tensor(rng.randn(2, n, h, 16).astype(np.float32))
               .to(dtype) for n, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len, q_block=q_block)
    want = A.attention(q, k, v, **kw).float()
    got = A.attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    assert got.dtype == dtype
    tol = RTOL if dtype == torch.float32 else BF16_RTOL
    assert float((got.float().cpu() - want).abs().max()) <= \
        tol * float(want.abs().max())


def _every_launch():
    """{kernel: launches} of all seven kernels."""
    from repro_torch.kernels import im2win_conv as iw
    from repro_torch.kernels import ssd_chunk as sc
    return {**_served_launches(), "ssd_chunk": sc.ssd_chunk_cuda.launches,
            "im2win_conv": iw.im2win_conv_cuda.launches}


def _reset_every():
    from repro_torch.kernels import im2win_conv as iw
    from repro_torch.kernels import ssd_chunk as sc
    _reset_served()
    sc.reset_counts()
    iw.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_v2_lite_16b",
                                  "recurrentgemma_9b", "internvl2_26b",
                                  "whisper_base"])
def test_zoo_on_the_card(cuda, arch, monkeypatch):
    """MoE, MLA, RG-LRU, the vision prefix and the encoder-decoder at
    their smoke configs, f32 compute (TF32 off), the weights drawn once
    on the CPU: on the card, the decode logits at position S after a
    prefill of S tokens (the conv tails kept in f32 too) within 1e-3 of
    max|logit| of the train forward's there, with the same argmax; the
    card's train logits within 1e-4 of the CPU's; and no kernel launched
    (the path has none)."""
    from repro_torch.configs import get_config
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    monkeypatch.setattr(common, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(T, "CONV_TAIL_DTYPE", torch.float32)
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    on_card = T.tree_map(lambda a: a.to(cuda), params)
    s = 40
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, s + 1), generator=g)
    kw = {}
    if cfg.n_prefix:
        kw["prefix_embeds"] = torch.randn((2, cfg.n_prefix, cfg.d_model),
                                          generator=g)
    if cfg.kind == "encdec":
        kw["enc_embeds"] = torch.randn((2, 24, cfg.d_model), generator=g)
    kw_card = {k: v.to(cuda) for k, v in kw.items()}
    p = cfg.n_prefix
    _reset_every()
    full = T.forward(on_card, cfg, tokens=toks.to(cuda), mode="train",
                     **kw_card)
    _, cache = T.forward(on_card, cfg, tokens=toks[:, :s].to(cuda),
                         mode="prefill", cache_len=p + s + 8, **kw_card)
    dl, _ = T.forward(on_card, cfg, tokens=toks[:, s:].to(cuda),
                      mode="decode", cache=cache, pos=p + s)
    torch.cuda.synchronize()
    assert not any(_every_launch().values())
    a, b = full[:, p + s], dl[:, 0]
    assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max())
    assert torch.equal(a.argmax(-1), b.argmax(-1))
    cpu = T.forward(params, cfg, tokens=toks, mode="train", **kw)
    assert float((full.cpu() - cpu).abs().max()) <= \
        1e-4 * float(cpu.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("e,k", [(8, 2), (64, 6)])
def test_route_tie_order_on_the_card(cuda, e, k):
    """``moe.route`` on router logits that tie (five values): the card
    sends every token to the experts the CPU does (CUDA's stable sort
    keeps the lower index first, as ``jax.lax.top_k``), drops the same
    assignments, and weighs them within a few f32 ulps."""
    from repro_torch.models import moe
    rng = np.random.RandomState(e)
    logits = torch.as_tensor(rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0],
                                        size=(2, 512, e)).astype(np.float32))
    cfg = moe.MoEConfig(n_experts=e, top_k=k, d_ff=8, capacity_factor=1.0)
    cap = moe.capacity(cfg, 512)
    _, idx = moe.top_k(torch.softmax(logits, -1), k)
    _, idx_card = moe.top_k(torch.softmax(logits.to(cuda), -1), k)
    assert torch.equal(idx_card.cpu(), idx)
    disp, comb = moe.route(logits, cfg, cap)
    disp_card, comb_card = moe.route(logits.to(cuda), cfg, cap)
    assert disp.sum() < 2 * 512 * k            # capacity drops some
    assert torch.equal(disp_card.cpu(), disp)
    assert torch.equal(comb_card.cpu() != 0, comb != 0)
    assert float((comb_card.cpu() - comb).abs().max()) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mixtral_8x7b",
                                  "mamba2_130m", "recurrentgemma_9b",
                                  "internvl2_26b", "whisper_base"])
def test_lm_train_step_on_the_card(cuda, arch, monkeypatch):
    """The LM train step at the smoke configs, f32 compute (TF32 off), the
    weights drawn once on the CPU: a step of two microbatches on the card
    against the same step on the CPU (loss and gradient norm within 1e-5
    relative, the Adam moments within 1e-4 of max|m|), ``loss_fn``'s
    gradients within 1e-4 of each leaf's max|g|, remat on vs off within
    1e-6, and no kernel launched (``loss_fn`` runs the plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import common
    from repro_torch.optim import tree_leaves, tree_map
    monkeypatch.setattr(common, "COMPUTE_DTYPE", torch.float32)
    cfg = get_config(arch, smoke=True)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 33), generator=g)}
    if cfg.n_prefix:
        batch["prefix_embeds"] = torch.randn((4, cfg.n_prefix, cfg.d_model),
                                             generator=g)
    if cfg.kind == "encdec":
        batch["enc_embeds"] = torch.randn((4, 24, cfg.d_model), generator=g)
    on_card = tree_map(lambda a: a.to(cuda), state)
    batch_card = {k: v.to(cuda) for k, v in batch.items()}
    step = steps.make_train_step(cfg, steps.TrainConfig(
        microbatches=2, warmup_steps=2, total_steps=10))
    _reset_every()
    new_card, m_card = step(on_card, batch_card)
    loss, grads = steps.loss_and_grads(on_card["params"], cfg, batch_card)
    loss_off, grads_off = steps.loss_and_grads(on_card["params"], cfg,
                                               batch_card, remat=False)
    torch.cuda.synchronize()
    assert not any(_every_launch().values())
    new_cpu, m_cpu = step(state, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= \
            1e-5 * abs(float(m_cpu[k]))
    for a, b in zip(tree_leaves(new_card["opt"]["m"]),
                    tree_leaves(new_cpu["opt"]["m"])):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())
    _, grads_cpu = steps.loss_and_grads(state["params"], cfg, batch)
    assert abs(float(loss) - float(loss_off)) <= 1e-6 * abs(float(loss))
    for a, b, c in zip(tree_leaves(grads), tree_leaves(grads_cpu),
                       tree_leaves(grads_off)):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
        assert float((a - c).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A train state on the card through ``CheckpointStore`` (async): the
    snapshot is taken before ``save`` returns, the restore lands on the
    card bit for bit, from ``meta`` shapes."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.optim import tree_leaves
    cfg = get_config("stablelm_1_6b", smoke=True)
    state = steps.init_train_state(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    want = [a.clone() for a in tree_leaves(state)]
    store = CheckpointStore(tmp_path, async_save=True, device=cuda)
    store.save(3, state, extra={"data_step": 3})
    for a in tree_leaves(state):
        a.add_(1)
    store.wait()
    got, step, extra = store.restore_latest(
        steps.init_train_state(cfg, None, "meta"))
    assert step == 3 and extra == {"data_step": 3}
    for a, b in zip(tree_leaves(got), want):
        assert a.device.type == "cuda" and torch.equal(a, b)
