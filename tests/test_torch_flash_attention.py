"""The port's attention plain version (repro_torch.kernels.flash_attention)
against the JAX package's Pallas flash kernel in interpret mode, on the
same numpy inputs: causal and not, a query offset, ragged-but-allowed
sequence lengths, GQA head folding through ``mha_flash``, lengths the
TPU kernel refuses (held against the JAX plain version), the device
rule of the wrapper, and the CUDA kernel's launch rule
(``flash_launch_dims``), which is pure Python."""
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


#: the two served shapes and ragged ones, (BH, Sq, D, Sk, causal,
#: q_offset), with the rows per block and blocks flash_launch_dims gives
#: them on an H100's 132 SMs
LAUNCHES = [
    ((32, 1024, 64, 1024, False, 0), (128, 256)),   # whisper-base
    ((128, 512, 64, 512, True, 0), (64, 1024)),     # stablelm-1.6b
    ((32, 1500, 64, 1500, False, 0), (128, 384)),   # whisper's 30 s
    ((32, 1500, 64, 1500, True, 0), (64, 768)),
    ((128, 136, 64, 136, True, 0), (64, 384)),      # just past 128
    ((8, 136, 64, 136, False, 0), (64, 24)),        # under a wave
    ((8, 128, 64, 384, True, 256), (64, 16)),       # queries after keys
    ((4, 100, 100, 100, False, 0), (64, 8)),        # D 100: 128 instance
    ((132, 128, 64, 128, False, 0), (128, 132)),    # one full wave
    ((264, 128, 128, 128, False, 0), (64, 528)),    # 128 rows do not fit
]


@pytest.mark.parametrize("shape,want", LAUNCHES)
def test_flash_launch_dims(shape, want):
    """Rows per block and blocks at the served and ragged shapes: the
    blocks cover every query row once (bh x ceil(Sq / rows)), the block
    fits 227 KB, and the choice gives the busiest SM no more work than the
    other block height would (ties to 128 rows)."""
    bh, sq, d, sk, causal, q_offset = shape
    got = fa.flash_launch_dims(bh, sq, d, 132, sk=sk, causal=causal,
                               q_offset=q_offset)
    assert (got.rows, got.blocks) == want
    assert got.blocks == bh * -(-sq // got.rows)
    assert got.dp == min(h for h in fa.HEAD_DIMS if h >= d)
    assert got.smem == fa.flash_smem_bytes(got.rows, got.dp) \
        <= fa.SMEM_LIMIT
    work = {rows: fa.busiest_sm_work(bh, sq, sk, rows, causal, q_offset, 132)
            for rows in fa.BLOCK_ROWS
            if fa.flash_smem_bytes(rows, got.dp) <= fa.SMEM_LIMIT}
    assert work[got.rows] == min(work.values())
    if len(set(work.values())) == 1 and len(work) == 2:
        assert got.rows == 128


def test_busiest_sm_work():
    """Equal blocks: ceil(blocks / SMs) blocks on the busiest SM.  Under
    the causal mask a block visits the 64-key tiles up to its last row,
    and the longest blocks (the last q tiles, started first) spread over
    the SMs before the short ones fill in."""
    assert fa.busiest_sm_work(32, 1024, 1024, 128, False, 0, 132) == \
        2 * 128 * 1024
    assert fa.busiest_sm_work(1, 512, 512, 64, True, 0, 132) == 64 * 512
    # 8 blocks of 1..8 tiles on 4 SMs: 8+1, 7+2, 6+3, 5+4 tiles
    assert fa.busiest_sm_work(1, 512, 512, 64, True, 0, 4) == 64 * 9 * 64
    # queries at positions 256..319 visit the 5 key tiles up to 319
    assert fa.busiest_sm_work(1, 64, 384, 64, True, 256, 132) == \
        64 * 320


def test_flash_launch_dims_mirrors_the_source():
    """The kv tile and the shared-memory layout the rule sizes blocks
    with are the source's: 64 keys a tile, 128 rows at D 128 do not fit
    227 KB, every other instance does."""
    import re
    from repro_torch.kernels._build import CSRC
    src = (CSRC / fa.SOURCE).read_text()
    assert re.search(r"constexpr int BKV = (\d+);", src).group(1) == \
        str(fa.KV_TILE)
    assert "(rows + 4 * BKV) * (dp + 4) + rows * PLD" in src
    assert fa.flash_smem_bytes(128, 128) > fa.SMEM_LIMIT
    assert all(fa.flash_smem_bytes(r, dp) <= fa.SMEM_LIMIT
               for r in fa.BLOCK_ROWS for dp in (32, 64))
    assert fa.flash_smem_bytes(64, 128) <= fa.SMEM_LIMIT
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_launch_dims(1, 8, 129, 132)


@pytest.mark.parametrize("dtype,d,vector", [
    (torch.float32, 64, True), (torch.float32, 63, False),
    (torch.float32, 100, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 100, False), (torch.bfloat16, 40, True)])
def test_vector_staging(dtype, d, vector):
    """16-byte staging where rows of d values are 16-byte multiples and
    every base is 16-byte aligned; a base one element off takes the
    element-wise instance."""
    q = torch.zeros(2, 8, d, dtype=dtype)
    assert fa.vector_staging(q, q.clone()) == vector
    off = torch.zeros(2 * 8 * d + 1, dtype=dtype)[1:].view(2, 8, d)
    assert not fa.vector_staging(q, off)
