"""The port's RG-LRU (``repro_torch.models.rglru``) against the JAX
package's ``repro.models.rglru``, on the CPU: ``rg_lru`` at S = 1, 7, 64
and 257, with and without a carried state, ``rg_lru_step`` chained S
times against ``rg_lru``, the log-depth scan against a sequential loop,
and the reference's softplus where ``F.softplus`` would switch to its
linear branch.

``rg_lru``'s Hillis-Steele scan forms the products in another order
than ``jax.lax.associative_scan``, so f32 results are held at 1e-6 of
max|y|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import assert_close, t                       # noqa: E402
from repro.models import rglru as JR                            # noqa: E402
from repro_torch.models import rglru as R                       # noqa: E402

#: f32, the scan's products in another order: relative to max|y|
RTOL = 1e-6
W = 24


def _inputs(s, seed=0, batch=2):
    rng = np.random.RandomState(seed + s)
    x, r, i = (rng.randn(batch, s, W).astype(np.float32) for _ in range(3))
    lam = np.linspace(0.5, 4.0, W).astype(np.float32)
    h0 = rng.randn(batch, W).astype(np.float32)
    return x, r, i, lam, h0


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("s", [1, 7, 64, 257])
def test_rg_lru_matches_jax(s, carry):
    x, r, i, lam, h0 = _inputs(s)
    yj, hj = JR.rg_lru(*map(jnp.asarray, (x, r, i, lam)),
                       h0=jnp.asarray(h0) if carry else None)
    yt, ht = R.rg_lru(*map(t, (x, r, i, lam)), h0=t(h0) if carry else None)
    assert yt.shape == (2, s, W) and ht.shape == (2, W)
    assert_close(yt, np.asarray(yj), RTOL)
    assert_close(ht, np.asarray(hj), RTOL)


def test_rg_lru_keeps_the_input_dtype():
    x, r, i, lam, _ = _inputs(7)
    y, h = R.rg_lru(*(t(a).to(torch.bfloat16) for a in (x, r, i)), t(lam))
    assert y.dtype == h.dtype == torch.bfloat16
    yj, _ = JR.rg_lru(*(jnp.asarray(a, jnp.bfloat16) for a in (x, r, i)),
                      jnp.asarray(lam))
    assert_close(y.float(), np.asarray(yj.astype(jnp.float32)), 2.0 ** -8)


@pytest.mark.parametrize("s", [7, 64])
def test_rg_lru_step_chained_equals_the_scan(s):
    """``rg_lru_step`` S times from ``h0`` against ``rg_lru(h0=...)``,
    and each step against the JAX package's step."""
    x, r, i, lam, h0 = _inputs(s, seed=1)
    want, h_last = R.rg_lru(*map(t, (x, r, i, lam)), h0=t(h0))
    h, hj = t(h0), jnp.asarray(h0)
    ys = []
    for k in range(s):
        sl = [a[:, k:k + 1] for a in (x, r, i)]
        y, h = R.rg_lru_step(*map(t, sl), t(lam), h)
        yj, hj = JR.rg_lru_step(*map(jnp.asarray, sl), jnp.asarray(lam), hj)
        assert_close(y, np.asarray(yj), RTOL)
        ys.append(y)
    assert_close(torch.cat(ys, 1), want.numpy(), RTOL)
    assert_close(h, h_last.numpy(), RTOL)


@pytest.mark.parametrize("s", [1, 2, 5, 64, 100])
def test_linear_scan_matches_a_loop(s):
    rng = np.random.RandomState(s)
    a = rng.uniform(0.5, 1.0, (2, s, 3))
    b = rng.randn(2, s, 3)
    h, want = np.zeros((2, 3)), []
    for k in range(s):
        h = a[:, k] * h + b[:, k]
        want.append(h)
    got = R.linear_scan(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_softplus_is_the_reference_form():
    """``jax.nn.softplus`` has no threshold: at x > 20 it is x +
    log1p(exp(-x)), where ``F.softplus`` returns x."""
    x = np.array([-30.0, -5.0, 0.0, 0.5, 4.0, 19.0, 21.0, 40.0],
                 np.float32)
    np.testing.assert_array_equal(R._softplus(t(x)).numpy(),
                                  np.asarray(jax.nn.softplus(x)))
