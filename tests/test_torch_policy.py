"""The LM cells' policies in the port (``models.attention.attention_policy``,
``models.common.norm_policy``, ``launch.shapes.build_cell``) against the
JAX package's, in-process on one device.

* bf16 score storage with q-block streaming (``q_block=8``): the port's
  attention against the JAX package's under the same policy, both
  op by op (the JAX functions run un-jitted, so they round where they
  are written to), not against the port's f32 scores;
* inner remat: the port's forward and gradients with and without it,
  bitwise; its gradients against ``jax.grad`` of the JAX attention under
  the same policy;
* the fast (bf16) ``rms_norm`` against the JAX package's fast branch;
* ``build_cell``'s train, prefill and decode cells on a 1x1 mesh (the
  port's host mesh; ``jax.make_mesh((1, 1))``, jitted with the cells'
  shardings) for the stablelm, mixtral, mamba2 and recurrentgemma smoke
  configs, on the same weights and batches.

The cells run with both packages' compute type switched to f32, at
test_torch_lm_train.py's tolerances where the cell keeps f32 scores;
their policies store the scores in bf16 (train and prefill), and a bf16
score rounds elsewhere wherever the f32 products are summed in another
order, which sets ``CELL_*`` below."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

import repro.models.common as j_common                          # noqa: E402
import repro_torch.models.common as t_common                    # noqa: E402
from _torch_parity import assert_close                          # noqa: E402
from repro.configs import get_config as j_get_config            # noqa: E402
from repro.launch import shapes as j_shapes                     # noqa: E402
from repro.launch import steps as j_steps                       # noqa: E402
from repro.models import attention as j_attn                    # noqa: E402
from repro.models import transformer as JT                      # noqa: E402
from repro_torch.checkpoint.store import _flatten               # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import mesh as t_mesh                   # noqa: E402
from repro_torch.launch import shapes as t_shapes               # noqa: E402
from repro_torch.launch import steps as t_steps                 # noqa: E402
from repro_torch.models import attention as t_attn              # noqa: E402
from repro_torch.models import transformer as T                 # noqa: E402

#: (batch, q rows, kv rows, q heads, kv heads, head dim, causal, window,
#: q_offset, kv_len): GQA streamed in 3 blocks, a padded tail, MQA with a
#: window, non-causal, a continuation against a longer cache
ATTN = [(2, 24, 24, 4, 2, 16, True, None, 0, None),
        (1, 20, 20, 4, 4, 8, True, None, 0, None),
        (2, 19, 19, 4, 1, 16, True, 6, 0, None),
        (2, 12, 12, 2, 2, 16, False, None, 0, None),
        (1, 10, 32, 4, 2, 16, True, None, 20, 30)]
#: bf16 scores vs the JAX package's, relative to max|out|: one bf16 ulp
#: of the largest outputs (the out-product's f32 sum rounds once, at
#: another order; measured 7.0e-3)
BF16_SCORES_RTOL = 2.0 ** -7
#: inner remat's gradients vs jax.grad, f32 (the same function)
GRAD_RTOL = 1e-5
ARCHS = ("stablelm_1_6b", "mixtral_8x7b", "mamba2_130m",
         "recurrentgemma_9b")
#: the cells on one device vs the JAX package's, f32 compute.  Without
#: the policies (optimized=False: f32 scores) at test_torch_lm_train.py's
#: tolerances: loss and gradient norm 1e-5 relative, the moments 1e-4
#: (m) and 2e-4 (v, g**2) of each leaf's max.  With them the bf16 scores
#: round apart wherever the products' f32 sums do (measured: loss up to
#: 1.08e-4 relative, gradient norm 6.3e-4, a moment 1.07e-2 of its
#: leaf's max): 2e-3 and 3e-2.  The new
#: params within 2 lr plus PARAM_RTOL of max|p| (Adam's sign-sensitive
#: first step)
CELL_RTOL = {False: (1e-5, 1e-4), True: (2e-3, 3e-2)}
PARAM_LR_BOUND = 2.0
PARAM_RTOL = 1e-6
#: the prefill's and decode's caches relative to each leaf's max: the
#: k/v of later layers carry the bf16 scores' roundings (measured up to
#: 6.8e-3, stablelm), the conv tails one bf16 rounding (mamba2 1.3e-4)
CELL_CACHE_RTOL = 1e-2
#: the prefill's last logits under its policy, relative to max|logit|
#: (the same roundings through the head; measured up to 3.8e-3, mixtral)
CELL_LOGITS_RTOL = 1e-2
#: the JAX meshes' axes are Auto, so the cells' sharding constraints
#: apply (jax.make_mesh's default Explicit axes refuse them)
AUTO = (jax.sharding.AxisType.Auto,) * 2


def _qkv(case, dtype):
    b, sq, sk, hq, hkv, dh = case[:6]
    rng = np.random.RandomState(sum(case[:6]))
    return [rng.randn(*s).astype(np.float32) for s in
            ((b, sq, hq, dh), (b, sk, hkv, dh), (b, sk, hkv, dh))]


def _kw(case):
    _, _, _, _, _, _, causal, window, q_offset, kv_len = case
    return dict(causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len, q_block=8)


@pytest.mark.parametrize("case", ATTN)
def test_bf16_scores_match_jax(case):
    """bf16 q, k, v under ``scores_dtype=bf16``: the port's output equals
    the JAX package's within BF16_SCORES_RTOL, and differs from the
    port's own f32-score output (the policy is in force)."""
    q, k, v = _qkv(case, np.float32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in (q, k, v))
    with j_attn.attention_policy(scores_dtype=jnp.bfloat16):
        want = np.asarray(j_attn.attention(jq, jk, jv, **_kw(case)),
                          np.float32)
    with t_attn.attention_policy(scores_dtype=torch.bfloat16):
        got = t_attn.attention(tq, tk, tv, **_kw(case))
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), want, BF16_SCORES_RTOL)
    f32_scores = t_attn.attention(tq, tk, tv, **_kw(case))
    assert not torch.equal(f32_scores, got)


def _port_grads(case, remat: bool, sdt=None):
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _qkv(case, None))
    w = torch.tensor(np.random.RandomState(7).randn(
        case[0], case[1], case[3], case[5]).astype(np.float32))
    with t_attn.attention_policy(inner_remat=remat, scores_dtype=sdt):
        out = t_attn.attention(q, k, v, **_kw(case))
        (out * w).sum().backward()
    return out.detach(), [a.grad for a in (q, k, v)]


@pytest.mark.parametrize("case", ATTN[:3])
def test_inner_remat_bitwise_and_matches_jax_grad(case):
    """q-block streaming under ``inner_remat``: the forward and the
    gradients of q, k and v bitwise the run without it, and within
    GRAD_RTOL of ``jax.grad`` of the JAX attention with inner remat."""
    out_on, g_on = _port_grads(case, True)
    out_off, g_off = _port_grads(case, False)
    assert torch.equal(out_on, out_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    q, k, v = (jnp.asarray(a) for a in _qkv(case, None))
    w = jnp.asarray(np.random.RandomState(7).randn(
        case[0], case[1], case[3], case[5]).astype(np.float32))

    def loss(q, k, v):
        with j_attn.attention_policy(inner_remat=True):
            return jnp.sum(j_attn.attention(q, k, v, **_kw(case)) * w)
    gj = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g_on, gj):
        assert_close(a, np.asarray(b), GRAD_RTOL)


def test_inner_remat_recomputes_under_the_forward_policy():
    """A recompute in the backward sees the forward's policy (bf16
    scores), wherever autograd runs it: bitwise the run without remat."""
    case = ATTN[0]
    out_on, g_on = _port_grads(case, True, torch.bfloat16)
    out_off, g_off = _port_grads(case, False, torch.bfloat16)
    assert torch.equal(out_on, out_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def test_fast_rms_norm_matches_jax():
    """bf16 activations under ``norm_policy(fast=True)``: the port's
    rms_norm equals the JAX package's fast branch bit for bit; it differs
    from the default f32 chain, and f32 input is untouched by it."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 64).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.tensor(x).bfloat16()
    with j_common.norm_policy(True):
        want = np.asarray(j_common.rms_norm(jx, jnp.asarray(scale)),
                          np.float32)
    with t_common.norm_policy(True):
        got = t_common.rms_norm(tx, torch.tensor(scale))
        f32 = t_common.rms_norm(torch.tensor(x), torch.tensor(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not torch.equal(got, t_common.rms_norm(tx, torch.tensor(scale)))
    assert torch.equal(f32, t_common.rms_norm(torch.tensor(x),
                                              torch.tensor(scale)))


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(j_common, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_common, "COMPUTE_DTYPE", torch.float32)


def _np(x):
    return x.detach().float().numpy()


def _cell(arch, mode, seq, batch, optimized=True, jax_weights=False):
    """The port's cell on the host mesh with its placed args, and the JAX
    package's, jitted on a 1x1 mesh with its shardings.  The params are
    the port's draw, or with ``jax_weights`` the JAX package's, carried
    as numpy (``materialize(weights=)``)."""
    cfg, cfg_j = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    spec = t_shapes.ShapeSpec(f"smoke_{mode}", seq, batch, mode)
    jspec = j_shapes.ShapeSpec(f"smoke_{mode}", seq, batch, mode)
    mb = 2 if mode == "train" else None
    fn, args, ins, _ = t_shapes.build_cell(
        cfg, spec, t_mesh.make_host_mesh("cpu"), microbatches=mb,
        optimized=optimized)
    weights = None
    if jax_weights:
        weights = jax.tree.map(np.asarray,
                               JT.init_params(cfg_j, jax.random.PRNGKey(0)))
    placed = t_shapes.materialize(cfg, spec, args, ins, seed=0,
                                  weights=weights)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=AUTO)
    jfn, _, jins, jouts = j_shapes.build_cell(cfg_j, jspec, jmesh,
                                              microbatches=mb,
                                              optimized=optimized)
    return cfg, cfg_j, fn, placed, jax.jit(jfn, in_shardings=jins,
                                           out_shardings=jouts)


def _tree_j(cfg_j, tree):
    """A port tree (dicts and tuples of tensors) as the JAX pytree."""
    if isinstance(tree, dict):
        return {k: _tree_j(cfg_j, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_j(cfg_j, v) for v in tree)
    return jnp.asarray(_np(tree)) if tree.dtype != torch.int32 else \
        jnp.asarray(tree.numpy())


@pytest.mark.parametrize("optimized", [False, True],
                         ids=["baseline", "optimized"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_matches_jax(arch, optimized, f32_compute):
    """train (seq 16, batch 4, 2 microbatches; optimized: bf16 scores,
    inner remat, the norm and MoE policies, no CP on one device): loss,
    gradient norm, lr, Adam's moments and the new params."""
    cfg, cfg_j, fn, (state, batch), jfn = _cell(arch, "train", 16, 4,
                                                optimized)
    loss_rtol, moment_rtol = CELL_RTOL[optimized]
    js, jb = _tree_j(cfg_j, state), _tree_j(cfg_j, batch)
    new_j, m_j = jfn(js, jb)
    new_t, m_t = fn(state, batch)
    for k in ("loss", "grad_norm"):
        a, b = float(m_t[k]), float(m_j[k])
        assert abs(a - b) <= loss_rtol * abs(b), (k, a, b)
    assert np.float32(m_t["lr"]) == np.float32(m_j["lr"])
    lr = float(m_j["lr"])
    leaves_j = dict(zip((k for k, _ in _flatten(state)),
                        jax.tree.leaves(new_j)))
    for key, leaf in _flatten(new_t):
        have, want = _np(leaf), np.asarray(leaves_j[key], np.float32)
        if key.startswith("opt/m/") or key.startswith("opt/v/"):
            tol = moment_rtol * (2 if key.startswith("opt/v/") else 1)
            assert_close(have, want, tol)
        elif key.startswith("params/"):
            bound = PARAM_LR_BOUND * lr + PARAM_RTOL * np.abs(want).max()
            assert np.abs(have - want).max() <= bound, key
        else:
            np.testing.assert_array_equal(have, want, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_cells_match_jax(arch, f32_compute):
    """On the JAX package's params, placed from numpy: prefill (seq 16,
    batch 2; bf16 scores): next tokens equal, the cache leaf by leaf, and
    the last position's logits under the cell's policy; decode (no
    policy): a prefill of the first 15 tokens into a 16-slot cache, then
    the decode cell at its last slot: tokens equal, the new cache leaf by
    leaf."""
    cfg, cfg_j, fn, (params, batch), jfn = _cell(arch, "prefill", 16, 2,
                                                 jax_weights=True)
    np.testing.assert_array_equal(
        params["embed"].numpy(), np.asarray(
            JT.init_params(cfg_j, jax.random.PRNGKey(0))["embed"]))
    pj = _tree_j(cfg_j, params)
    tok_j, cache_j = jfn(pj, _tree_j(cfg_j, batch))
    tok_t, cache_t = fn(params, batch)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    for (key, leaf), lj in zip(_flatten(cache_t), jax.tree.leaves(cache_j)):
        assert_close(_np(leaf), np.asarray(lj, np.float32), CELL_CACHE_RTOL)
    with j_attn.attention_policy(scores_dtype=jnp.bfloat16):
        lj, _ = jax.jit(lambda p, t: JT.forward(
            p, cfg_j, mode="prefill", cache_len=16, tokens=t))(
                pj, jnp.asarray(batch["tokens"].numpy()))
    with t_attn.attention_policy(scores_dtype=torch.bfloat16):
        lt, _ = T.forward(params, cfg, mode="prefill", cache_len=16,
                          tokens=batch["tokens"])
    assert_close(_np(lt), np.asarray(lj, np.float32), CELL_LOGITS_RTOL)
    # decode at the last slot of a cache filled by a prefill of 15 tokens
    first = batch["tokens"][:, :15]
    _, filled_t = t_steps.make_prefill_step(cfg, cache_len=16)(
        params, {"tokens": first})
    _, filled_j = jax.jit(j_steps.make_prefill_step(cfg_j, cache_len=16))(
        pj, {"tokens": jnp.asarray(first.numpy())})
    dfn, dargs, dins, _ = t_shapes.build_cell(
        cfg, t_shapes.ShapeSpec("smoke_decode", 16, 2, "decode"),
        t_mesh.make_host_mesh("cpu"))
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=AUTO)
    jd, _, jins, jouts = j_shapes.build_cell(
        cfg_j, j_shapes.ShapeSpec("smoke_decode", 16, 2, "decode"), jmesh)
    token = batch["tokens"][:, 15:16]
    nxt_t, new_t = dfn(params, filled_t, token, 15)
    nxt_j, new_j = jax.jit(jd, in_shardings=jins, out_shardings=jouts)(
        pj, filled_j, jnp.asarray(token.numpy()), jnp.int32(15))
    np.testing.assert_array_equal(nxt_t.numpy(), np.asarray(nxt_j))
    for (key, leaf), lj in zip(_flatten(new_t), jax.tree.leaves(new_j)):
        assert_close(_np(leaf), np.asarray(lj, np.float32), CELL_CACHE_RTOL)
