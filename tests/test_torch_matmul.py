"""The port's matmul kernels' plain versions (repro_torch.kernels
tetris_matmul, grouped_matmul, matmul_exec) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs: the ragged
tail-block cases, the "matmul" executor's layout adapters for G = 1 and
G > 1, and the wrappers' device rule (CPU tensors take the plain
version; the CUDA launchers refuse them)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import RTOL_LAYER, assert_close, map_layer_both, t  # noqa: E402,E501
from repro.kernels import matmul_exec as j_exec                 # noqa: E402
from repro.kernels.grouped_matmul import grouped_matmul as j_gmm  # noqa: E402
from repro.kernels.tetris_matmul import tetris_matmul as j_mm   # noqa: E402
from repro_torch.kernels import _build                          # noqa: E402
from repro_torch.kernels import grouped_matmul as gm            # noqa: E402
from repro_torch.kernels import matmul_exec as me               # noqa: E402
from repro_torch.kernels import tetris_matmul as tm             # noqa: E402


@pytest.mark.parametrize("mnk,block", [
    ((100, 60, 48), (32, 32, 16)),    # M and N tails, K divides
    ((33, 129, 64), (32, 128, 32)),   # single-row M tail, 1-col N tail
    ((64, 64, 50), (32, 32, 32)),     # K does not divide -> bk shrinks
    ((7, 5, 3), (8, 8, 8)),           # blocks larger than the problem
])
def test_tetris_matmul_tail_blocks(mnk, block):
    m, n, k = mnk
    rng = np.random.RandomState(31)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    want = np.asarray(j_mm(jnp.asarray(x), jnp.asarray(w), block=block,
                           interpret=True))
    tm.reset_counts()
    assert_close(tm.tetris_matmul(t(x), t(w)), want, RTOL_LAYER)
    assert_close(tm.matmul_ref(t(x), t(w)), want, RTOL_LAYER)
    assert tm.tetris_matmul_cuda.launches == 0


@pytest.mark.parametrize("gmdf,bmbf", [
    ((3, 50, 24, 30), (16, 16)),      # M and F tails in every group
    ((2, 17, 40, 65), (16, 64)),      # 1-row M tail, 1-col F tail
    ((5, 8, 12, 8), (16, 16)),        # blocks larger than the problem
])
def test_grouped_matmul_tail_blocks(gmdf, bmbf):
    g, m, d, f = gmdf
    rng = np.random.RandomState(32)
    x = rng.randn(g, m, d).astype(np.float32)
    w = rng.randn(g, d, f).astype(np.float32)
    want = np.asarray(j_gmm(jnp.asarray(x), jnp.asarray(w), bm=bmbf[0],
                            bf=bmbf[1], interpret=True))
    gm.reset_counts()
    assert_close(gm.grouped_matmul(t(x), t(w)), want, RTOL_LAYER)
    assert_close(gm.grouped_matmul_ref(t(x), t(w)), want, RTOL_LAYER)
    assert gm.grouped_matmul_cuda.launches == 0


def _mapped(m, d, f, groups):
    return map_layer_both(lambda core: core.matmul_spec("mm", m, d, f),
                          (64, 64), "TetrisG-SDK", (2, 2), groups=groups)


@pytest.mark.parametrize("mdf,groups", [((16, 64, 96), (1,)),
                                        ((16, 128, 64), (1, 2, 4)),
                                        ((12, 60, 40), (1, 2))])
def test_matmul_executor_matches_jax(mdf, groups):
    """The executor's layout adapters (token flatten for G = 1, the
    group-major reshapes for G > 1) and its einsum oracle against the
    JAX package's executor, which runs the Pallas kernels in interpret
    mode."""
    m, d, f = mdf
    jm, lm = _mapped(m, d, f, groups)
    g = lm.group
    rng = np.random.RandomState(33)
    kernel = (rng.randn(1, 1, d // g, f) * 0.1).astype(np.float32)
    x = rng.randn(2, d, m, 1).astype(np.float32)
    want = np.asarray(j_exec.matmul_layer_traced(
        jm, jnp.asarray(x), jnp.asarray(kernel), interpret=True))
    y = me.matmul_layer(lm, t(x), t(kernel))
    assert tuple(y.shape) == (2, f, m, 1)
    assert_close(y, want, RTOL_LAYER)
    assert_close(me.matmul_layer_ref(lm, t(x), t(kernel)), want, RTOL_LAYER)


def test_matmul_executor_guards():
    jm, lm = _mapped(16, 64, 48, (1,))
    with pytest.raises(ValueError, match="grouped conv layout"):
        me.matmul_layer(lm, torch.zeros(2, 64, 16, 1),
                        torch.zeros(1, 1, 32, 48))
    from repro_torch.core import ArrayConfig, ConvLayerSpec, map_layer
    conv = map_layer(ConvLayerSpec("c", 8, 8, 3, 3, 4, 4),
                     ArrayConfig(64, 64), "VW-SDK")
    with pytest.raises(ValueError, match="op='matmul'"):
        me.matmul_layer(conv, torch.zeros(1, 4, 8, 8),
                        torch.zeros(1, 1, 4, 4))


def test_cuda_launchers_refuse_cpu_tensors():
    """The launchers check their operands before loading anything: a CPU
    tensor is refused, never computed some other way."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        tm.tetris_matmul_cuda(torch.zeros(4, 3), torch.zeros(3, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        gm.grouped_matmul_cuda(torch.zeros(2, 4, 3), torch.zeros(2, 3, 2))


#: (groups, m, n) of the output and the tile width gemm_launch_dims
#: picks: the whisper-base block's four launches (M 4096) and
#: stablelm-1.6b's (G 4, M 2048), the same at batch 1, then ragged ones,
#: on an H100's 132 SMs.  128 x 64 where it leaves the busiest SM less
#: work
LAUNCH_SHAPES = [
    ((1, 4096, 1536), 128), ((1, 4096, 512), 128), ((1, 4096, 2048), 128),
    ((4, 2048, 1536), 128), ((4, 2048, 512), 128), ((4, 2048, 1408), 64),
    ((1, 1024, 1536), 128), ((1, 1024, 512), 64), ((4, 512, 1536), 64),
    ((4, 512, 1408), 64),
    ((1, 7, 5), 64), ((1, 33, 129), 64), ((1, 128, 128), 64),
    ((1, 129, 127), 64), ((3, 100, 72), 64), ((3, 50, 30), 64),
    ((5, 8, 8), 64), ((5, 2049, 65), 128)]


@pytest.mark.parametrize("gmn,bn", LAUNCH_SHAPES)
def test_gemm_launch_dims_cover_output_once(gmn, bn):
    """The block tiles of gemm_launch_dims's grid cover every (g, m, n)
    of the output exactly once (the grid is a product of its axes, so
    each axis once: one group per z, rows by y, columns by x), and the
    block count is the grid's."""
    groups, m, n = gmn
    d = tm.gemm_launch_dims(groups, m, n, 132)
    gx, gy, gz = d.grid
    assert d.blocks == gx * gy * gz
    assert (d.bm, d.bn, gz) == (tm.BM, bn, groups)
    for size, tile, count in ((m, d.bm, gy), (n, d.bn, gx)):
        seen = np.zeros(size, dtype=np.int64)
        for i in range(count):
            seen[i * tile:(i + 1) * tile] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("bn", tm.BNS)
def test_gemm_tile_ring_fits_two_blocks_per_sm(bn):
    """Each tile the C entry takes has a shared-memory ring, as
    csrc/matmul.cu lays it out (STAGES slabs of x [BM][BK + 4] and of
    w [BK][bn]), that fits 227 KB twice, which the source also asserts
    at compile time; its BM is the launch rule's."""
    text = (_build.CSRC / tm.SOURCE).read_text()
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert c["BM"] == tm.BM
    assert {int(v) for v in re.findall(r"bn != (\d+)", text)} == set(tm.BNS)
    ring = c["STAGES"] * (c["BM"] * (c["BK"] + 4) + c["BK"] * bn) * 4
    assert 2 * ring <= c["kSmemLimit"] == 227 * 1024
    assert "static_assert(2 * Tile<BN>::SMEM <= kSmemLimit" in text


def _aligned(shape):
    """A CPU f32 tensor whose base is 16-byte aligned."""
    t = torch.zeros(shape)
    assert t.data_ptr() % 16 == 0
    return t


def _group_major(d, g, f):
    """The matmul executor's weight view of a (d, g*f) kernel."""
    return _aligned((d, g * f)).reshape(d, g, f).transpose(0, 1)


@pytest.mark.parametrize("make,vector", [
    (lambda: (_aligned((4096, 512)), _aligned((512, 1536))), True),
    (lambda: (_aligned((4, 2048, 512)), _group_major(512, 4, 1536)), True),
    (lambda: (_aligned((4, 2048, 1408)), _group_major(1408, 4, 512)), True),
    (lambda: (_aligned((256, 63)), _aligned((63, 256))), False),   # K % 4
    (lambda: (_aligned((256, 64)), _aligned((64, 130))), False),   # N % 4
    (lambda: (_aligned((256, 65))[:, 1:], _aligned((64, 256))), False),
    (lambda: (_aligned((256, 68))[:, 4:], _aligned((64, 256))), True),
    (lambda: (_aligned((3, 50, 24)), _group_major(24, 3, 30)), False),
])
def test_vector_staging_exactly_when_aligned(make, vector):
    """The 16-byte instance is chosen exactly when every base is 16-byte
    aligned and every row and group stride is a multiple of 4 floats:
    a view offset by one float, a K or N that is not a multiple of 4, or
    a group-major view of F % 4 != 0 takes the 4-byte instance."""
    x, w = make()
    out = _aligned(x.shape[:-1] + w.shape[-1:])
    assert tm.vector_staging(x, w, out) == vector
    assert tm.vector_staging(x, w) == vector
    assert not tm.vector_staging(x, w, _aligned((out.numel() + 1,))[1:])


def test_gemm_variants_edit_a_copy_of_the_source(tmp_path):
    """The variant tool edits copies of csrc/matmul.cu, never the source:
    edits that share a name add up, and a text that does not occur
    exactly once is refused."""
    from repro_torch.kernels import gemm_variants as gv
    shipped = (_build.CSRC / tm.SOURCE).read_text()
    paths = gv.sources([("v", "BK = 32;", "BK = 16;"),
                        ("v", "STAGES = 2;", "STAGES = 3;")], tmp_path)
    assert paths["shipped"] == _build.CSRC / tm.SOURCE
    assert (_build.CSRC / tm.SOURCE).read_text() == shipped
    assert paths["v"].read_text() == shipped.replace(
        "BK = 32;", "BK = 16;").replace("STAGES = 2;", "STAGES = 3;")
    for old in ("BK = 99;", "float"):
        with pytest.raises(ValueError, match="not once"):
            gv.sources([("w", old, "x")], tmp_path)


def test_gemm_variants_need_a_card(monkeypatch):
    from repro_torch.kernels import gemm_variants as gv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gv.main([]) == 1
