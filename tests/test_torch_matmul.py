"""The port's matmul kernels' plain versions (repro_torch.kernels
tetris_matmul, grouped_matmul, matmul_exec) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs: the ragged
tail-block cases, the "matmul" executor's layout adapters for G = 1 and
G > 1, and the wrappers' device rule (CPU tensors take the plain
version; the CUDA launchers refuse them)."""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import RTOL_LAYER, assert_close, map_layer_both, t  # noqa: E402,E501
from repro.kernels import matmul_exec as j_exec                 # noqa: E402
from repro.kernels.grouped_matmul import grouped_matmul as j_gmm  # noqa: E402
from repro.kernels.tetris_matmul import tetris_matmul as j_mm   # noqa: E402
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
