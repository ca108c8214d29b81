"""The port's mamba2-130m serving path against the JAX package's, on the
CPU at the smoke config: the same weights (the JAX ``init_params`` draws
carried across by ``params_from_numpy``) and tokens through the train,
prefill and decode forwards, greedy ``generate`` held by teacher forcing,
the full config's parameter count, and the port's own init.

The forwards run twice: with both packages' compute type switched to f32
(the same function, summed in another order: a tight tolerance that
holds the algorithm) and in bf16, the serving type."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

import repro.models.common as j_common                          # noqa: E402
import repro_torch.models.common as t_common                    # noqa: E402
from _torch_parity import assert_close, t                       # noqa: E402
from repro import configs as j_configs                          # noqa: E402
from repro.launch import serve as j_serve                       # noqa: E402
from repro.models import transformer as JT                      # noqa: E402
from repro_torch import configs                                 # noqa: E402
from repro_torch.launch import serve                            # noqa: E402
from repro_torch.launch.steps import make_serve_step            # noqa: E402
from repro_torch.models import params_from_numpy                # noqa: E402
from repro_torch.models import transformer as T                 # noqa: E402

#: relative to max|logit|, per compute type.  f32: the same function in
#: another summation order (the decode caches are bf16 in both packages
#: either way).  bf16: the packages round at different places, and this
#: smoke model amplifies it: the JAX package's own scanned and op-by-op
#: evaluations of these train logits differ by 4.1e-2 of max|logit|, and
#: each package lies about 8e-2 from its f32 result.
RTOL = {"f32": 1e-4, "bf16": 1e-1}
#: one bf16 rounding of a value up to max|y|: the decode caches
CACHE_RTOL = 2.0 ** -8
B, S, GEN = 2, 40, 6          # S is not a multiple of the smoke chunk (32)


@pytest.fixture(params=["f32", "bf16"])
def compute(request, monkeypatch):
    """Both packages' compute type; returns its tolerance."""
    if request.param == "f32":
        monkeypatch.setattr(j_common, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(t_common, "COMPUTE_DTYPE", torch.float32)
    return RTOL[request.param]


@pytest.fixture(scope="module")
def model():
    cfg_j = j_configs.get_config("mamba2_130m", smoke=True)
    cfg = configs.get_config("mamba2_130m", smoke=True)
    pj = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg, jax.tree.map(np.asarray, pj))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S + 1),
                                         0, cfg.vocab))
    return cfg_j, cfg, pj, pt, toks


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _leaves(tree):
    """A port pytree's leaves in ``jax.tree.leaves`` order (dict keys
    sorted)."""
    return jax.tree.leaves(T.tree_map(lambda a: a, tree))


def test_config_matches_jax():
    for smoke in (False, True):
        assert configs.get_config("mamba2_130m", smoke=smoke) == \
            configs.get_config("mamba2-130m", smoke=smoke)
        j, p = (mod.get_config("mamba2_130m", smoke=smoke)
                for mod in (j_configs, configs))
        assert repr(j).replace("repro.", "") == repr(p).replace(
            "repro_torch.", "")


def test_param_count_matches_jax():
    cfg_j = j_configs.get_config("mamba2_130m")
    cfg = configs.get_config("mamba2_130m")
    assert cfg.param_count() == JT.count_params(cfg_j) == 129_057_216
    assert cfg.active_param_count() == cfg_j.active_param_count()


def test_params_from_numpy_checks_shapes(model):
    cfg_j, cfg, pj, _, _ = model
    tree = jax.tree.map(np.asarray, pj)
    tree["embed"] = tree["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(cfg, tree)


def test_init_params_draws_the_jax_layout():
    """The port's own init has the JAX pytree's keys and shapes, the
    fixed a_log / dt_bias / d_skip, and N(0, 1/fan_in) weights."""
    cfg_j = j_configs.get_config("mamba2_130m", smoke=True)
    cfg = configs.get_config("mamba2_130m", smoke=True)
    pj = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.structure(pj) == jax.tree.structure(
        T.tree_map(lambda a: a.numpy(), pt))
    for a, b in zip(jax.tree.leaves(pj), _leaves(pt)):
        assert a.shape == tuple(b.shape)
    blk_j, blk = pj["stages"][0][0]["ssd"], pt["stages"][0][0]["ssd"]
    for k in ("a_log", "dt_bias", "d_skip"):
        assert_close(blk[k], np.asarray(blk_j[k]), 1e-6)
    d = cfg.d_model
    assert abs(float(blk["wx"].std()) * np.sqrt(d) - 1.0) < 0.05
    assert abs(float(pt["embed"].std()) / 0.02 - 1.0) < 0.05


def test_init_block_cache_matches_jax(model):
    """The decode cache of one block: the JAX package's shapes and types
    (and those of the cache a prefill returns), zero-filled."""
    cfg_j, cfg, _, pt, toks = model
    cj = JT.init_block_cache(cfg_j, cfg_j.stages[0].unit[0], B, S)
    ct = T.init_block_cache(cfg, cfg.stages[0].unit[0], B, S)
    _, pre = T.forward(pt, cfg, tokens=t(toks[:, :S]), mode="prefill")
    for a, b, c in zip(jax.tree.leaves(cj), _leaves(ct),
                       _leaves(T.tree_map(lambda x: x[0], pre[0][0]))):
        assert a.shape == tuple(b.shape) == tuple(c.shape)
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
        assert not b.any()


def test_train_logits_match_jax(model, compute):
    cfg_j, cfg, pj, pt, toks = model
    want = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, :S]),
                      mode="train")
    got = T.forward(pt, cfg, tokens=t(toks[:, :S]), mode="train")
    assert got.shape == (B, S, cfg.padded_vocab)
    assert_close(got.float(), _f32(want), compute)


def test_prefill_and_decode_match_jax(model, compute):
    cfg_j, cfg, pj, pt, toks = model
    lj, cj = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, :S]),
                        mode="prefill", cache_len=S + 8)
    lt, ct = T.forward(pt, cfg, tokens=t(toks[:, :S]), mode="prefill",
                       cache_len=S + 8)
    assert_close(lt.float(), _f32(lj), compute)
    for a, b in zip(jax.tree.leaves(cj), _leaves(ct)):
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
        assert_close(b.float(), _f32(a), max(compute, CACHE_RTOL))
    dj, _ = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, S:S + 1]),
                       mode="decode", cache=cj, pos=jnp.array(S, jnp.int32))
    dt, _ = T.forward(pt, cfg, tokens=t(toks[:, S:S + 1]), mode="decode",
                      cache=ct, pos=S)
    assert_close(dt.float(), _f32(dj), compute)


def test_generate_teacher_forced(model, compute):
    """The JAX ``generate``'s tokens fed to the port's decode steps: each
    port argmax equals the JAX token, except where the JAX logits' top-2
    margin is under the tolerance (a bf16 near-tie either side may
    break)."""
    cfg_j, cfg, pj, pt, toks = model
    out_j = np.array(j_serve.generate(cfg_j, pj, jnp.asarray(toks[:, :S]),
                                        GEN))
    out = serve.generate(cfg, pt, t(toks[:, :S]), 1)
    assert out.shape == (B, S + 1)
    _, cache = T.forward(pt, cfg, tokens=t(toks[:, :S]), mode="prefill")
    _, cj = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, :S]),
                       mode="prefill")
    step = make_serve_step(cfg)
    checked = 0
    for i in range(GEN):
        if i:
            tok_t, cache = step(pt, cache, t(out_j[:, S + i - 1:S + i]),
                                S + i - 1)
            lj, cj = JT.forward(pj, cfg_j,
                                tokens=jnp.asarray(out_j[:, S + i - 1:S + i]),
                                mode="decode", cache=cj,
                                pos=jnp.array(S + i - 1, jnp.int32))
            got = tok_t[:, 0].numpy()
        else:
            lj = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, :S]),
                            mode="prefill")[0]
            got = out[:, S].numpy()
        lj = _f32(lj)[:, -1, :cfg.vocab]
        top2 = np.sort(lj, -1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]) / np.abs(lj).max()
        for r in range(B):
            if margin[r] >= compute:
                assert got[r] == out_j[r, S + i], (i, r)
                checked += 1
    assert checked >= (B * GEN if compute == RTOL["f32"] else 1)


def test_serve_main_on_cpu(capsys):
    out = serve.main(["--arch", "mamba2_130m", "--smoke", "--batch", "2",
                      "--prompt-len", "20", "--gen", "3", "--device", "cpu"])
    assert out.shape == (2, 23)
    cfg = configs.get_config("mamba2_130m", smoke=True)
    assert int(out.max()) < cfg.vocab
    assert "mamba2-130m-smoke: generated 3 tokens x 2 seqs" in \
        capsys.readouterr().out


def test_other_families_are_not_ported():
    """Every block and kind of the reference initialises (MLA, MoE,
    RG-LRU, cross-attention, the encoder-decoder; on ``meta``, with the
    JAX package's leaf count); a mixer, ffn or kind outside the
    reference's raises ``NotImplementedError`` naming the reference's."""
    from repro.models import BlockSpec as JBlockSpec, Stage as JStage
    from repro_torch.models import BlockSpec, Stage
    base = configs.get_config("deepseek_v2_lite_16b", smoke=True)
    base = dataclasses.replace(base, rnn_width=32, n_enc_layers=1)
    base_j = dataclasses.replace(
        j_configs.get_config("deepseek_v2_lite_16b", smoke=True),
        rnn_width=32, n_enc_layers=1)
    for args, kw, kind in ((("mla", "dense"), {}, "decoder"),
                           (("gqa", "moe"), {}, "decoder"),
                           (("rec", "dense"), {}, "decoder"),
                           (("gqa", "dense"), {"cross": True}, "decoder"),
                           (("gqa", "dense"), {}, "encdec")):
        cfg = dataclasses.replace(base, kind=kind, stages=(
            Stage((BlockSpec(*args, **kw),), 1),))
        cfg_j = dataclasses.replace(base_j, kind=kind, stages=(
            JStage((JBlockSpec(*args, **kw),), 1),))
        shapes = jax.eval_shape(lambda k: JT.init_params(cfg_j, k),
                                jax.random.PRNGKey(0))
        assert len(T.tree_leaves(T.init_params(cfg, device="meta"))) == \
            len(jax.tree.leaves(shapes))
    for spec, kind, what in ((BlockSpec("xyz", "dense"), "decoder", "mixer"),
                             (BlockSpec("gqa", "xyz"), "decoder", "ffn"),
                             (BlockSpec("gqa", "dense"), "xyz", "kind")):
        cfg = dataclasses.replace(base, kind=kind,
                                  stages=(Stage((spec,), 1),))
        with pytest.raises(NotImplementedError,
                           match=f"{what} 'xyz' is not one of the "
                                 f"reference's"):
            T.init_params(cfg)
