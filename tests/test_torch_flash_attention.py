"""The port's attention plain version (repro_torch.kernels.flash_attention)
against the JAX package's Pallas flash kernel in interpret mode, on the
same numpy inputs: causal and not, a query offset, ragged-but-allowed
sequence lengths, GQA head folding through ``mha_flash``, lengths the
TPU kernel refuses (held against the JAX plain version), and the device
rule of the wrapper."""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import RTOL_LAYER, assert_close, t           # noqa: E402
from repro.kernels import flash_attention as j_fa               # noqa: E402
from repro.kernels import ref as j_ref                          # noqa: E402
from repro_torch.kernels import flash_attention as fa           # noqa: E402


def _qkv(bh, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, sq, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32))


@pytest.mark.parametrize("bh,sq,sk,d,q_offset", [
    (4, 128, 128, 64, 0), (2, 256, 256, 32, 0), (3, 128, 384, 64, 0),
    (2, 100, 100, 16, 0),             # S <= 128 need not tile by 128
    (2, 128, 384, 32, 256),           # continuation: queries after keys
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(bh, sq, sk, d, q_offset, causal):
    q, k, v = _qkv(bh, sq, sk, d, seed=41)
    want = np.asarray(j_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, interpret=True))
    fa.reset_counts()
    y = fa.flash_attention(t(q), t(k), t(v), causal=causal,
                           q_offset=q_offset)
    assert_close(y, want, RTOL_LAYER)
    assert fa.flash_attention_cuda.launches == 0


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_mha_flash_gqa_matches_jax(hq, hkv):
    """kv heads repeat per group (``repeat_interleave``, as
    ``jnp.repeat(axis=1)``), not tile."""
    rng = np.random.RandomState(42)
    q = rng.randn(2, 128, hq, 32).astype(np.float32)
    k = rng.randn(2, 128, hkv, 32).astype(np.float32)
    v = rng.randn(2, 128, hkv, 32).astype(np.float32)
    want = np.asarray(j_fa.mha_flash(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), interpret=True))
    assert_close(fa.mha_flash(t(q), t(k), t(v)), want, RTOL_LAYER)
    _, kf, _ = fa.fold_heads(t(q), t(k), t(v))
    rep = hq // hkv
    np.testing.assert_array_equal(kf.reshape(2, hq, 128, 32)[:, rep - 1],
                                  k[:, :, 0])


@pytest.mark.parametrize("sq,sk,q_offset", [(200, 200, 0), (136, 136, 0),
                                             (72, 1500, 1428)])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_seq_matches_jax_plain(sq, sk, q_offset, causal):
    """Lengths that do not tile by min(128, S): the TPU kernel refuses
    them, the port takes them (its CUDA kernel masks ragged tiles) and
    agrees with the JAX package's plain version."""
    q, k, v = _qkv(2, sq, sk, 16, seed=43)
    with pytest.raises(ValueError, match="must tile"):
        j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), interpret=True)
    want = np.asarray(j_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset))
    assert_close(fa.flash_attention(t(q), t(k), t(v), causal=causal,
                                    q_offset=q_offset), want, RTOL_LAYER)


def test_cuda_launcher_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q, q, q)
