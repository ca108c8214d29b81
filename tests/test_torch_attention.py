"""The port's attention primitives against the JAX package's, on the CPU:
``attention`` (causal or not, GQA/MQA/MHA, a window, ``q_offset``,
``kv_len``, and q-block streaming with padded blocks and a clipped kv
slice), ``cache_insert`` at every position that fits, the ring decode
``decode_attention_ring`` across wraps, and the rotary and sinusoidal
positions.  Inputs are drawn with numpy from a seed and go through both
packages; f32 results are held at 1e-5 of max|y| (the same products
summed in another order), bf16 ones at one bf16 rounding more."""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import assert_close, t                       # noqa: E402
from repro.models import attention as JA                        # noqa: E402
from repro.models import common as JC                           # noqa: E402
from repro_torch.models import attention as A                   # noqa: E402
from repro_torch.models import common as C                      # noqa: E402

#: relative to max|y|: f32, another summation order; bf16, one bf16
#: rounding of y (2**-8) on top
RTOL = {"f32": 1e-5, "bf16": 2.0 ** -8 + 1e-5}
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
DH = 16

# (sq, sk, hq, hkv, causal, window, q_offset, kv_len, q_block)
CASES = {
    "mha_causal": (20, 20, 8, 8, True, None, 0, None, 512),
    "gqa_full": (20, 20, 8, 2, False, None, 0, None, 512),
    "mqa_causal": (20, 20, 8, 1, True, None, 0, None, 512),
    "decode_kv_len": (1, 24, 8, 2, True, None, 13, 14, 512),
    "continuation": (4, 24, 8, 2, True, None, 10, 14, 512),
    "window": (20, 20, 8, 2, True, 6, 0, None, 512),
    "padded_blocks": (20, 20, 8, 8, True, None, 0, None, 8),
    "padded_window": (20, 20, 8, 2, True, 6, 0, None, 8),
    "window_blocks": (40, 40, 8, 2, True, 6, 0, None, 8),
    "mqa_full_blocks": (40, 40, 8, 1, False, None, 0, None, 8),
    "window_offset": (40, 48, 8, 2, True, 6, 8, 48, 8),
}


def _draw(rng, shape, dtype):
    """numpy f32 draws rounded to ``dtype``: the same values in both."""
    return np.array(jnp.asarray(rng.randn(*shape).astype(np.float32),
                                DTYPES[dtype][0]).astype(jnp.float32))


def _both(a, dtype):
    """(jax array, torch tensor) of the f32 numpy ``a`` in ``dtype``."""
    return (jnp.asarray(a, DTYPES[dtype][0]),
            t(a).to(DTYPES[dtype][1]))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_matches_jax(case, dtype):
    sq, sk, hq, hkv, causal, window, q_offset, kv_len, q_block = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    q = _draw(rng, (2, sq, hq, DH), dtype)
    k = _draw(rng, (2, sk, hkv, DH), dtype)
    v = _draw(rng, (2, sk, hkv, DH), dtype)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
              q_block=q_block)
    want = JA.attention(qj, kj, vj, **kw)
    got = A.attention(qt, kt, vt, **kw)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got.float(), _f32(want), RTOL[dtype])


def test_attention_streams_bounded_kv_slices(monkeypatch):
    """With a window the streamed q blocks see a kv slice of window +
    block keys, its start clipped into the sequence; padded q rows are
    dropped."""
    seen = []
    inner = A._attend_block

    def spy(q, k, v, pos_q, pos_k, **kw):
        seen.append((int(pos_q[0]), q.shape[1], int(pos_k[0]), k.shape[1]))
        return inner(q, k, v, pos_q, pos_k, **kw)
    monkeypatch.setattr(A, "_attend_block", spy)
    q = torch.randn(1, 20, 4, DH)
    k = v = torch.randn(1, 20, 2, DH)
    out = A.attention(q, k, v, window=6, q_block=8)
    assert out.shape == q.shape
    # kv_slice = min(20, 6 + 8) = 14; starts clip(8i - 6, 0, 6)
    assert seen == [(0, 8, 0, 14), (8, 8, 2, 14), (16, 8, 6, 14)]


@pytest.mark.parametrize("n", [1, 3])
def test_cache_insert_every_position(n):
    """Every start that fits writes the same slots as the JAX package's
    ``dynamic_update_slice`` and leaves the given cache as it was; a
    start past the end raises, where the JAX package clamps it."""
    rng = np.random.RandomState(n)
    length = 8
    cache = {name: rng.randn(2, length, 2, DH).astype(np.float32)
             for name in ("k", "v")}
    k_new, v_new = (rng.randn(2, n, 2, DH).astype(np.float32)
                    for _ in range(2))
    ct = {name: t(a) for name, a in cache.items()}
    for pos in range(length - n + 1):
        want = JA.cache_insert({k: jnp.asarray(a) for k, a in cache.items()},
                               jnp.asarray(k_new), jnp.asarray(v_new), pos)
        got = A.cache_insert(ct, t(k_new), t(v_new), pos)
        for name in ("k", "v"):
            np.testing.assert_array_equal(got[name].numpy(), want[name])
            np.testing.assert_array_equal(ct[name].numpy(), cache[name])
    for pos in (length - n + 1, length, -1):
        with pytest.raises(IndexError, match="do not fit"):
            A.cache_insert(ct, t(k_new), t(v_new), pos)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_decode_attention_ring_across_wraps(hq, hkv, dtype):
    """A ring of the window's length filled step by step (slot step %
    window) and read at every step from the first through two wraps."""
    window, steps = 8, 20
    rng = np.random.RandomState(hq + hkv)
    cj, ct = (JA.init_kv_cache(2, window, hkv, DH, DTYPES[dtype][0]),
              A.init_kv_cache(2, window, hkv, DH, DTYPES[dtype][1]))
    for step in range(steps):
        q = _draw(rng, (2, 1, hq, DH), dtype)
        k, v = (_draw(rng, (2, 1, hkv, DH), dtype) for _ in range(2))
        (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
        cj = JA.cache_insert(cj, kj, vj, step % window)
        ct = A.cache_insert(ct, kt, vt, step % window)
        want = JA.decode_attention_ring(qj, cj, step, window)
        got = A.decode_attention_ring(qt, ct, step, window)
        assert got.dtype == DTYPES[dtype][1]
        assert_close(got.float(), _f32(want), RTOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rot_dim", [None, 4, 8])
def test_apply_rotary_matches_jax(rot_dim, dtype):
    """Full rotary (None) and partial (the first rot_dim of 16 features),
    rotate-half, cos/sin cast to x's dtype first."""
    rng = np.random.RandomState(7)
    x = _draw(rng, (2, 12, 4, DH), dtype)
    pos = np.arange(3, 15)
    dim = DH if rot_dim is None else rot_dim
    cj, sj = JC.rotary_cos_sin(jnp.asarray(pos), dim, 500.0)
    ct, st = C.rotary_cos_sin(t(pos), dim, 500.0)
    assert_close(ct, np.asarray(cj), 1e-6)
    assert_close(st, np.asarray(sj), 1e-6)
    xj, xt = _both(x, dtype)
    want = JC.apply_rotary(xj, cj, sj, rot_dim)
    got = C.apply_rotary(xt, ct, st, rot_dim)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got.float(), _f32(want), RTOL[dtype])
    if rot_dim is not None:       # the unrotated features pass through
        assert torch.equal(got[..., rot_dim:], xt[..., rot_dim:])


def test_sinusoidal_matches_jax():
    pos = np.array([0, 1, 7, 100, 2047])
    assert_close(C.sinusoidal_at(t(pos), 32),
                 np.asarray(JC.sinusoidal_at(jnp.asarray(pos), 32)), 1e-6)
    assert_close(C.sinusoidal_positions(50, 24),
                 np.asarray(JC.sinusoidal_positions(50, 24)), 1e-6)
