"""The port's kernel API (``kernels/ops.py``, ``kernels/ref.py``) against
the JAX package's on the CPU: the im2win window rule and grid size, the
convolution (plain route) against ``ref.conv2d_ref`` on the JAX kernel
test's shapes and the paper's 14 layers, and matmul, gmm and attention
against the JAX ``ops`` (Pallas in interpret mode), in f32 and in bf16
(the dtype contract: bf16 in, f32 sums, bf16 out; other or mixed dtypes
raise).  The JAX im2win kernel itself does not trace on this JAX
(ROADMAP.md queue 3), so the convolution is held to the JAX oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import assert_close, t                       # noqa: E402
from repro.kernels import im2win_conv as j_im2win               # noqa: E402
from repro.kernels import ops as j_ops                          # noqa: E402
from repro.kernels import ref as j_ref                          # noqa: E402
from repro_torch.core import networks                           # noqa: E402
from repro_torch.kernels import im2win_conv, ops, ref           # noqa: E402

#: f32 both sides, the same products summed in another order
RTOL = 1e-5
#: test_kernels.py's im2win cases: (b, h, w, c, k, o)
KERNEL_CFGS = [(2, 18, 18, 24, 3, 32), (1, 12, 12, 8, 5, 16),
               (2, 9, 9, 32, 3, 64), (1, 7, 7, 3, 3, 5)]
#: the paper's layers ops.conv2d serves: cnn8 and the Inception 5x5s
LAYERS = networks.cnn8() + networks.inception()


def test_select_window_and_cycles_match_jax():
    for o_h in (1, 3, 5, 7, 10, 16, 24, 33, 64, 100):
        for k in (1, 3, 5):
            for c, oc in ((3, 5), (16, 32), (64, 256), (512, 512)):
                for budget in (64 * 1024, 4 * 1024 * 1024):
                    w = im2win_conv.select_window(o_h, o_h + 3, k, c, oc,
                                                  budget)
                    assert w == j_im2win.select_window(o_h, o_h + 3, k, c, oc,
                                                       budget)
                    th, tw = min(w[0], o_h), min(w[1], o_h + 3)
                    for b in (1, 8):
                        assert im2win_conv.n_cycles(o_h, o_h + 3, th, tw, b) \
                            == j_im2win.n_cycles(o_h, o_h + 3, th, tw, b)


def _conv_case(rng, b, h, w, c, k, o):
    return (rng.randn(b, h, w, c).astype(np.float32),
            (rng.randn(k, k, c, o) * 0.1).astype(np.float32))


@pytest.mark.parametrize("cfg", KERNEL_CFGS)
def test_conv2d_matches_jax_ref(cfg):
    x, w = _conv_case(np.random.RandomState(1), *cfg)
    want = np.asarray(j_ref.conv2d_ref(jnp.asarray(x), jnp.asarray(w)))
    assert_close(ops.conv2d(t(x), t(w)), want, RTOL)
    assert_close(ref.conv2d_ref(t(x), t(w)), want, RTOL)


@pytest.mark.parametrize("layer", LAYERS, ids=[lay.name for lay in LAYERS])
def test_conv2d_paper_layers_match_jax_ref(layer):
    """Batch 1 (the card checks batch 8): already padded, stride 1."""
    assert layer.stride == 1 and layer.groups == 1
    x, w = _conv_case(np.random.RandomState(2), 1, layer.i_h, layer.i_w,
                      layer.ic, layer.k_h, layer.oc)
    want = np.asarray(j_ref.conv2d_ref(jnp.asarray(x), jnp.asarray(w)))
    assert_close(ops.conv2d(t(x), t(w)), want, RTOL)


def test_conv2d_window_sets_the_grid_only():
    x, w = _conv_case(np.random.RandomState(3), *KERNEL_CFGS[0])
    want = ops.conv2d(t(x), t(w))
    assert torch.equal(ops.conv2d(t(x), t(w), window=(5, 7)), want)
    with pytest.raises(ValueError, match="channels"):
        ops.conv2d(t(x), t(w[:, :, :-1]))


@pytest.mark.parametrize("mnk", [(256, 256, 256), (100, 60, 48)])
def test_matmul_matches_jax_ops(mnk):
    m, n, k = mnk
    rng = np.random.RandomState(4)
    x, w = rng.randn(m, k).astype(np.float32), rng.randn(k, n).astype(
        np.float32)
    want = np.asarray(j_ops.matmul(jnp.asarray(x), jnp.asarray(w)))
    assert_close(ops.matmul(t(x), t(w)), want, RTOL)
    assert_close(ref.matmul_ref(t(x), t(w)), want, RTOL)


def test_gmm_matches_jax_ops():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 64, 32).astype(np.float32)
    w = rng.randn(4, 32, 48).astype(np.float32)
    want = np.asarray(j_ops.gmm(jnp.asarray(x), jnp.asarray(w)))
    assert_close(ops.gmm(t(x), t(w)), want, RTOL)
    assert_close(ref.grouped_matmul_ref(t(x), t(w)), want, RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_jax_ops(causal):
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(3, 128, 32).astype(np.float32) for _ in range(3))
    want = np.asarray(j_ops.attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      causal=causal))
    assert_close(ops.attention(t(q), t(k), t(v), causal=causal), want, RTOL)
    assert_close(ref.flash_attention_ref(t(q), t(k), t(v), causal=causal),
                 want, RTOL)


def test_tile_arguments_are_refused():
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="block"):
        ops.matmul(x, x, block=(8, 8, 8))
    g = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="bf"):
        ops.gmm(g, g, bf=8)


def _split_cases():
    """(b, h, w, c, k, o, window) of the 14 layers at batch 8 and the
    JAX kernel test's shapes, each also at a clamped (3, 5) window."""
    cases = [(8, lay.i_h, lay.i_w, lay.ic, lay.k_h, lay.oc, None)
             for lay in LAYERS]
    cases += [cfg + (None,) for cfg in KERNEL_CFGS]
    cases += [cfg + ((3, 5),) for cfg in KERNEL_CFGS]
    return cases


@pytest.mark.parametrize("case", _split_cases())
def test_cluster_split_covers_each_window_once(case):
    """cluster_split gives one grid step at most MAX_CLUSTER (8, the
    largest portable cluster) blocks, whose parts
    (rank -> (pi, oi) = divmod(rank, co)) cover every (position, channel)
    of the window exactly once, none of them empty, within a block's
    shared memory; the launch has n_cycles steps and n_cycles x cluster
    blocks."""
    b, h, w, c, k, o, window = case
    o_h, o_w, th, tw = im2win_conv.conv_window((b, h, w, c), (k, k, c, o),
                                               window)
    cluster, tile = im2win_conv.cluster_split(th, tw, o, c, k, k)
    assert 1 <= cluster <= im2win_conv.MAX_CLUSTER == 8
    assert cluster % tile.co == 0 and tile.oc % 4 == 0
    assert 1 <= tile.cs <= c and tile.smem <= im2win_conv.SMEM_LIMIT
    seen = np.zeros((th * tw, o), dtype=int)
    for rank in range(cluster):
        pi, oi = divmod(rank, tile.co)
        part = seen[pi * tile.pos:(pi + 1) * tile.pos,
                    oi * tile.oc:(oi + 1) * tile.oc]
        assert part.size > 0
        part += 1
    assert (seen == 1).all()
    args, steps, n = im2win_conv._plan((b, h, w, c), (k, k, c, o), window)
    assert steps == im2win_conv.n_cycles(o_h, o_w, th, tw, b)
    assert n == cluster and args[9:] == (cluster, tile.co, tile.pos,
                                         tile.oc, tile.cs, tile.ks)


@pytest.mark.parametrize("batch", [8, 16])
def test_cluster_split_fills_the_card_on_the_paper_layers(batch):
    """Each of the 14 layers has one grid step per image (the window
    covers the whole output); the split gives the layers with enough work
    MAX_CLUSTER blocks a step (at batch 8, 8 x 8 = 64 SMs in one wave),
    the same at every batch, and keeps every part at least 16 channels
    or positions wide."""
    clusters = {}
    for lay in LAYERS:
        x_shape = (batch, lay.i_h, lay.i_w, lay.ic)
        w_shape = (lay.k_h, lay.k_w, lay.ic, lay.oc)
        o_h, o_w, th, tw = im2win_conv.conv_window(x_shape, w_shape)
        assert im2win_conv.n_cycles(o_h, o_w, th, tw, batch) == batch
        cluster, tile = im2win_conv.cluster_split(th, tw, lay.oc, lay.ic,
                                                  lay.k_h, lay.k_w)
        clusters[lay.name] = cluster
        assert im2win_conv._plan(x_shape, w_shape, None)[1:] == \
            (batch, cluster)
        assert tile.oc >= min(16, lay.oc) and tile.pos >= min(16, th * tw)
        assert tile.smem <= im2win_conv.SMEM_LIMIT
    assert clusters["Incep-3b"] == clusters["CNN8-7"] == \
        im2win_conv.MAX_CLUSTER
    assert sum(v == im2win_conv.MAX_CLUSTER for v in clusters.values()) >= 9


def _bf16_case(op, rng):
    """(numpy f32 operands, extra kwargs, contraction depth K) of one op;
    the operands are rounded to bf16 on both sides."""
    if op == "matmul":
        return (rng.randn(100, 60), rng.randn(60, 48)), {}, 60
    if op == "gmm":
        return (rng.randn(3, 50, 40), rng.randn(3, 40, 30)), {}, 40
    if op == "attention":
        return tuple(rng.randn(2, 128, 64) for _ in range(3)), {
            "causal": True}, 64
    return (rng.randn(2, 9, 9, 16), rng.randn(3, 3, 16, 8) * 0.1), {}, \
        3 * 3 * 16


def _jax_bf16(op, args, kw):
    """The reference on bf16 operands: the JAX ``ops`` kernel in interpret
    mode, or ``ref.conv2d_ref`` for the convolution."""
    a = [jnp.asarray(x.astype(np.float32), jnp.bfloat16) for x in args]
    fn = j_ref.conv2d_ref if op == "conv2d" else getattr(j_ops, op)
    out = fn(*a, **kw)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("op", ["matmul", "gmm", "attention", "conv2d"])
def test_bf16_keeps_the_reference_dtype_contract(op):
    """bf16 operands return bf16 and agree with the reference within its
    own bf16 tolerances (tests/test_kernels.py): atol 0.2 sqrt(K), rtol
    1e-2 for the products (the convolution's K is kh*kw*C), 5e-2 / 5e-2
    for attention."""
    args, kw, k = _bf16_case(op, np.random.RandomState(7))
    want = _jax_bf16(op, args, kw)
    got = getattr(ops, op)(*(t(x.astype(np.float32)).to(torch.bfloat16)
                             for x in args), **kw)
    assert got.dtype == torch.bfloat16
    atol, rtol = (5e-2, 5e-2) if op == "attention" else (0.2 * np.sqrt(k),
                                                         1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("op", ["matmul", "gmm", "attention", "conv2d"])
@pytest.mark.parametrize("dtypes", ["float16", "mixed"])
def test_other_or_mixed_dtypes_are_refused(op, dtypes):
    """float16 operands, or f32 beside bf16, raise rather than return a
    result in some other dtype."""
    args, kw, _ = _bf16_case(op, np.random.RandomState(8))
    ts = [t(x.astype(np.float32)) for x in args]
    if dtypes == "float16":
        ts = [x.half() for x in ts]
    else:
        ts[-1] = ts[-1].to(torch.bfloat16)
    with pytest.raises(ValueError, match="dtype|float16"):
        getattr(ops, op)(*ts, **kw)
