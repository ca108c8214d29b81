"""The port's Mixture-of-Experts (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe``, on the CPU: ``capacity`` over a grid,
``top_k``'s order on ties (``jax.lax.top_k``'s: the lower index first),
``route`` with forced ties and with dropped assignments, and ``moe_ffn``
over several chunks, with and without shared experts, in f32 and bf16.
Inputs are drawn with numpy from a seed and go through both packages.

``route``'s dispatch is compared exactly; its combine weights on the
same support, to 2e-6: both softmaxes are f32 but ``torch.exp`` and
XLA's ``exp`` differ in the last bit of about one value in ten
(measured up to 4.8e-7 on probabilities of 64 experts)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import assert_close, t                       # noqa: E402
from repro.models import common as j_common                     # noqa: E402
from repro.models import moe as JM                              # noqa: E402
from repro_torch.models import common as t_common               # noqa: E402
from repro_torch.models import moe as M                         # noqa: E402
from repro_torch.models.config import MoEConfig                 # noqa: E402

#: combine weights (probabilities <= 1): a few f32 ulps of the softmax
COMB_ATOL = 2e-6
#: moe_ffn relative to max|y|: f32, another summation order; bf16, one
#: bf16 rounding of y
RTOL = {"f32": 1e-5, "bf16": 2.0 ** -8}
#: the JAX package compiled to round where its program is written to
AS_WRITTEN = {"xla_allow_excess_precision": False}


def _cfgs(**kw):
    """The same MoEConfig in both packages."""
    return JM.MoEConfig(**kw), MoEConfig(**kw)


def _route_both(logits, kw, cap):
    cfg_j, cfg = _cfgs(**kw)
    dj, cj = JM.route(jnp.asarray(logits), cfg_j, cap)
    dt, ct = M.route(t(logits), cfg, cap)
    return np.asarray(dj), np.asarray(cj), dt.numpy(), ct.numpy()


def _check_route(dj, cj, dt, ct):
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ct != 0, cj != 0)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=COMB_ATOL)


def test_moe_config_is_one_class():
    """``MoEConfig`` lives in ``moe.py`` and ``config.py`` re-exports it,
    as in the JAX package."""
    from repro_torch.models import MoEConfig as exported
    assert MoEConfig is M.MoEConfig is exported


def test_capacity_matches_jax():
    for e, k, cf, n in itertools.product((4, 8, 64), (1, 2, 6),
                                         (1.0, 1.25, 2.0),
                                         (1, 16, 511, 512, 4096)):
        cfg_j, cfg = _cfgs(n_experts=e, top_k=k, d_ff=8, capacity_factor=cf)
        assert M.capacity(cfg, n) == JM.capacity(cfg_j, n)
    cfg_j, cfg = _cfgs(n_experts=64, top_k=6, d_ff=1408, n_shared=2)
    assert M.capacity(cfg, 511) == M.capacity(cfg, 512) == 60


@pytest.mark.parametrize("k", [1, 2, 6])
def test_top_k_takes_the_lower_index_on_ties(k):
    rng = np.random.RandomState(k)
    probs = rng.choice([0.1, 0.2, 0.3], size=(3, 50, 8)).astype(np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(probs), k)
    vt, it = M.top_k(t(probs), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("e,k", [(8, 2), (64, 6)])
def test_route_with_forced_ties_matches_jax(e, k):
    """bf16 router logits from five values, so most tokens tie at their
    k-th expert: both packages send them to the same experts."""
    rng = np.random.RandomState(e)
    logits = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0],
                        size=(2, 64, e)).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, d_ff=8)
    cap = M.capacity(MoEConfig(**kw), 64)
    _check_route(*_route_both(logits, kw, cap))


def test_route_drops_match_jax():
    """capacity_factor 1.0, a chunk of 16: assignments beyond an expert's
    capacity are dropped in both packages (all-zero slot rows)."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 16, 4) * 2).astype(np.float32)
    logits[:, :, 0] += 1.5                       # crowd expert 0
    kw = dict(n_experts=4, top_k=2, d_ff=8, capacity_factor=1.0, chunk=16)
    cap = M.capacity(MoEConfig(**kw), 16)
    dj, cj, dt, ct = _route_both(logits, kw, cap)
    assert dj.sum() < 2 * 16 * 2                # some were dropped
    _check_route(dj, cj, dt, ct)


def _moe_params(rng, d, e, f, n_shared):
    p = {"router": rng.randn(d, e) / np.sqrt(d),
         "wi": rng.randn(e, d, f) / np.sqrt(d),
         "wg": rng.randn(e, d, f) / np.sqrt(d),
         "wo": rng.randn(e, f, d) / np.sqrt(f)}
    if n_shared:
        fs = n_shared * f
        p.update(shared_wi=rng.randn(d, fs) / np.sqrt(d),
                 shared_wg=rng.randn(d, fs) / np.sqrt(d),
                 shared_wo=rng.randn(fs, d) / np.sqrt(fs))
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_moe_ffn_matches_jax(compute, n_shared, monkeypatch):
    """Four chunks of 16 at capacity factor 1.0 (8 slots an expert, so
    assignments are dropped), with and without a shared expert; the JAX
    package compiled as its program is written to round."""
    if compute == "f32":
        monkeypatch.setattr(j_common, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(t_common, "COMPUTE_DTYPE", torch.float32)
    rng = np.random.RandomState(n_shared)
    d, e, f = 32, 4, 48
    kw = dict(n_experts=e, top_k=2, d_ff=f, n_shared=n_shared, chunk=16,
              capacity_factor=1.0)
    cfg_j, cfg = _cfgs(**kw)
    p = _moe_params(rng, d, e, f, n_shared)
    x = rng.randn(2, 64, d).astype(np.float32)
    kept = M.route(t(x[:, :16]) @ t(p["router"]), cfg, 8)[0].sum()
    assert kept < 2 * 16 * 2
    xj = jnp.asarray(x).astype(j_common.COMPUTE_DTYPE)
    want = jax.jit(lambda x, p: JM.moe_ffn(x, p, cfg_j),
                   compiler_options=AS_WRITTEN)(
        xj, {k: jnp.asarray(v) for k, v in p.items()})
    got = M.moe_ffn(t(x).to(t_common.COMPUTE_DTYPE),
                    {k: t(v) for k, v in p.items()}, cfg)
    assert got.dtype == t_common.COMPUTE_DTYPE
    assert_close(got.float(), np.asarray(want.astype(jnp.float32)),
                 RTOL[compute])


def test_moe_ffn_rejects_a_ragged_chunk():
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff=8, chunk=16)
    p = {k: t(v) for k, v in _moe_params(np.random.RandomState(0), 8, 4, 8,
                                         0).items()}
    with pytest.raises(ValueError, match="not divisible by moe chunk 16"):
        M.moe_ffn(torch.zeros((1, 40, 8), dtype=torch.bfloat16), p, cfg)
    y = M.moe_ffn(torch.zeros((1, 12, 8), dtype=torch.bfloat16), p, cfg)
    assert y.shape == (1, 12, 8)
