"""The port's SSD pieces against the JAX package's, on the CPU: the
``ssd_chunk`` kernel's plain version against the Pallas kernel in
interpret mode and the ``ref`` oracle, the chunked mixer (ragged S,
groups, an initial state), the chunked form against the decode
recurrence, and the depthwise causal conv.  Inputs are numpy draws from
a seed, fed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import assert_close, t                       # noqa: E402
from repro.kernels import ref as j_ref                          # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk as j_ssd_chunk    # noqa: E402
from repro.models import ssm as j_ssm                           # noqa: E402
from repro_torch.kernels import ref                             # noqa: E402
from repro_torch.kernels import ssd_chunk as sc                 # noqa: E402
from repro_torch.models import ssm                              # noqa: E402

#: f32 both sides, the same terms summed in another order: relative to
#: max|y| (and max|S| for the states)
RTOL = 1e-5


def _inputs(rng, b, s, h, p, g, n):
    """The JAX kernel test's distributions: dt > 0 small, a_log ~ 0."""
    return (rng.randn(b, s, h, p).astype(np.float32),
            (np.abs(rng.randn(b, s, h)) * 0.1 + 0.05).astype(np.float32),
            (rng.randn(h) * 0.3).astype(np.float32),
            (rng.randn(b, s, g, n) * 0.3).astype(np.float32),
            (rng.randn(b, s, g, n) * 0.3).astype(np.float32))


@pytest.mark.parametrize("chunk", [128, 32])
def test_ssd_chunk_plain_matches_pallas(chunk):
    """test_kernels.py's shape, B and C pre-repeated over heads (G == H,
    the TPU kernel's signature)."""
    x, dt, a_log, b, c = _inputs(np.random.RandomState(0), 2, 128, 4, 16,
                                 4, 8)
    y_j, s_j = j_ssd_chunk(*(jnp.asarray(a) for a in (x, dt, a_log, b, c)),
                           chunk=chunk, interpret=True)
    y, s = sc.ssd_chunk(*(t(a) for a in (x, dt, a_log, b, c)), chunk=chunk)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(s, np.asarray(s_j), RTOL)
    for i in range(128 // chunk):               # each chunk vs the oracle
        sl = slice(chunk * i, chunk * (i + 1))
        want = j_ref.ssd_intra_chunk_ref(
            *(jnp.asarray(a[:, sl]) for a in (x, dt)), jnp.asarray(a_log),
            *(jnp.asarray(a[:, sl]) for a in (b, c)))
        got = ref.ssd_intra_chunk_ref(*(t(a[:, sl]) for a in (x, dt)),
                                      t(a_log), *(t(a[:, sl]) for a in (b, c)))
        assert_close(got, np.asarray(want), RTOL)


def test_ssd_chunk_groups_read_in_place():
    """(B,S,G,N) with G < H computes the pre-repeated function."""
    x, dt, a_log, b, c = _inputs(np.random.RandomState(1), 2, 64, 4, 8, 2, 8)
    y, s = sc.ssd_chunk(*(t(a) for a in (x, dt, a_log, b, c)), chunk=32)
    rep = [np.repeat(a, 2, axis=2) for a in (b, c)]
    y_j, s_j = j_ssd_chunk(*(jnp.asarray(a) for a in (x, dt, a_log, *rep)),
                           chunk=32, interpret=True)
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(s, np.asarray(s_j), RTOL)


def test_ssd_chunk_refuses_ragged_seq():
    x, dt, a_log, b, c = _inputs(np.random.RandomState(2), 1, 40, 2, 8, 1, 4)
    with pytest.raises(ValueError, match="chunk"):
        sc.ssd_chunk(*(t(a) for a in (x, dt, a_log, b, c)), chunk=32)


def test_segsum_matches_jax():
    a = np.random.RandomState(3).randn(2, 3, 9).astype(np.float32)
    got, want = ssm.segsum(t(a)).numpy(), np.asarray(j_ssm.segsum(
        jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,g,chunk,with_state", [
    (96, 1, 32, False),            # three whole chunks
    (100, 1, 32, False),           # ragged: padded with dt = 0 tokens
    (20, 1, 32, False),            # shorter than a chunk: L = S
    (70, 2, 16, True),             # G = 2 of H = 4, an initial state
])
def test_ssd_chunked_matches_jax(s, g, chunk, with_state):
    rng = np.random.RandomState(4)
    h, p, n = 4, 8, 16
    x, dt, a_log, b, c = _inputs(rng, 2, s, h, p, g, n)
    d = rng.randn(h).astype(np.float32)
    h0 = (rng.randn(2, h, p, n) * 0.5).astype(np.float32) \
        if with_state else None
    cfg_j = j_ssm.SSMConfig(d_inner=h * p, n_heads=h, head_dim=p, d_state=n,
                            n_groups=g, chunk=chunk)
    cfg_t = ssm.SSMConfig(d_inner=h * p, n_heads=h, head_dim=p, d_state=n,
                          n_groups=g, chunk=chunk)
    y_j, st_j = j_ssm.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, a_log, b, c, d)), cfg_j,
        init_state=None if h0 is None else jnp.asarray(h0))
    y, st = ssm.ssd_chunked(*(t(a) for a in (x, dt, a_log, b, c, d)), cfg_t,
                            init_state=None if h0 is None else t(h0))
    assert y.shape == (2, s, h, p) and st.shape == (2, h, p, n)
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(st, np.asarray(st_j), RTOL)


def test_ssd_chunked_matches_decode_recurrence():
    """The chunked form equals the token-by-token recurrence of
    ``ssd_decode_step`` (both in the port), as the JAX test checks."""
    rng = np.random.RandomState(1)
    bsz, s, h, p, g, n = 2, 64, 4, 8, 1, 16
    cfg = ssm.SSMConfig(d_inner=h * p, n_heads=h, head_dim=p, d_state=n,
                        n_groups=g, chunk=16)
    x, dt, a_log, b, c = (t(a) for a in _inputs(rng, bsz, s, h, p, g, n))
    d = t(rng.randn(h).astype(np.float32))
    y_chunk, st_chunk = ssm.ssd_chunked(x, dt, a_log, b, c, d, cfg)
    st = torch.zeros(bsz, h, p, n)
    ys = []
    for i in range(s):
        y1, st = ssm.ssd_decode_step(x[:, i:i + 1], dt[:, i:i + 1], a_log,
                                     b[:, i:i + 1], c[:, i:i + 1], d, st)
        ys.append(y1)
    assert_close(y_chunk, torch.cat(ys, 1).numpy(), RTOL)
    assert_close(st_chunk, st.numpy(), RTOL)


def test_ssd_decode_step_matches_jax():
    rng = np.random.RandomState(5)
    x, dt, a_log, b, c = _inputs(rng, 2, 1, 4, 8, 2, 16)
    d = rng.randn(4).astype(np.float32)
    st = rng.randn(2, 4, 8, 16).astype(np.float32)
    y_j, s_j = j_ssm.ssd_decode_step(
        *(jnp.asarray(a) for a in (x, dt, a_log, b, c, d, st)))
    y, s = ssm.ssd_decode_step(*(t(a) for a in (x, dt, a_log, b, c, d, st)))
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(s, np.asarray(s_j), RTOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    """The weights are cast to bf16 in both packages, the input stays
    f32: the same products, summed in the same order."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 11, 24).astype(np.float32)
    w = rng.randn(4, 24).astype(np.float32)
    st = rng.randn(2, 3, 24).astype(np.float32) if with_state else None
    y_j, n_j = j_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st))
    y, n = ssm.causal_conv1d(t(x), t(w), None if st is None else t(st))
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(n, np.asarray(n_j), 0.0)
