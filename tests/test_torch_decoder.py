"""The port's decoder attention family (``mixer="gqa"``) against the JAX
package's, on the CPU at the smoke configs of stablelm-1.6b (MHA,
LayerNorm, partial rotary), qwen1.5-32b (QKV bias), deepseek-67b and
mistral-large-123b (GQA), and a sliding-window spec (a ring cache):
the same weights (the JAX ``init_params`` draws carried across by
``params_from_numpy``) and tokens through the train, prefill and decode
forwards, the prefill caches, greedy ``generate`` held by teacher
forcing, the port's own prefill/decode consistency, the full configs'
parameter counts, and the CLI.

The forwards run twice: with both packages' compute type switched to
f32 (the same function, summed in another order: a tight tolerance that
holds the algorithm) and in bf16, the serving type."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

import repro.models as j_models                                 # noqa: E402
import repro.models.common as j_common                          # noqa: E402
import repro_torch.models as t_models                           # noqa: E402
import repro_torch.models.common as t_common                    # noqa: E402
from _torch_gqa_bf16 import (ARCHS, B, GEN, MODELS, S, UNSOUND,  # noqa: E402
                             block_got, block_want, differ, draw,
                             model_configs, unsound)
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
#: another summation order (measured 0.9e-6 to 1.3e-6).  bf16: the port
#: rounds where the JAX program is written to round (see
#: ``test_bf16_block_rounds_as_the_reference``), but the jitted
#: reference skips some roundings, so the ulps a block flips grow over
#: the blocks: the JAX package's own scanned and op-by-op logits differ
#: by 1.17e-2 to 1.29e-2, and the port's readings reach 1.61e-2
#: (``_torch_gqa_bf16.py`` prints them).  bf16 attention scores read
#: 1.95e-2 and fail; the weights cast before the divide (1.66e-2) and
#: ``F.silu`` (1.67e-2) pass, and the block test catches them.
RTOL = {"f32": 1e-4, "bf16": 1.8e-2}
#: one bf16 rounding of a value up to max|y|: the first unit's prefill
#: cache (later units carry the drift of the units before them)
CACHE_RTOL = 2.0 ** -8
#: one bf16 block against the JAX package's as written: the share of
#: elements that may differ.  Rounding where the reference rounds, only
#: a matmul's f32 sums taken in another order flip an element (measured
#: at most 0.07 %); rounding elsewhere changes half of them or more
#: (``F.silu``'s one rounding 49-57 %; bf16 attention scores, or the
#: weights cast before the divide, 69-83 %).
BLOCK_DIFFER = 0.01


@pytest.fixture(params=["f32", "bf16"])
def compute(request, monkeypatch):
    """Both packages' compute type; returns its name."""
    if request.param == "f32":
        monkeypatch.setattr(j_common, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(t_common, "COMPUTE_DTYPE", torch.float32)
    return request.param


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    return draw(request.param) + ({},)


def _jax_prefill(model, compute):
    """The JAX package's prefill of the prompt (logits, cache), computed
    once per model and compute type."""
    cfg_j, _, pj, _, toks, memo = model
    if compute not in memo:
        memo[compute] = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, :S]),
                                   mode="prefill", cache_len=S + GEN)
    return memo[compute]


def _block_want(model, mode):
    """The JAX first block run op by op (input, output, cache), once per
    model and mode."""
    cfg_j, _, pj, _, toks, memo = model
    if ("block", mode) not in memo:
        memo["block", mode] = block_want(cfg_j, pj, toks, mode)
    return memo["block", mode]


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _leaves(tree):
    """A port pytree's leaves in ``jax.tree.leaves`` order (dict keys
    sorted)."""
    return jax.tree.leaves(T.tree_map(lambda a: a, tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    for smoke in (False, True):
        j, p = (mod.get_config(arch, smoke=smoke)
                for mod in (j_configs, configs))
        assert repr(j).replace("repro.", "") == repr(p).replace(
            "repro_torch.", "")


@pytest.mark.parametrize("arch,count", [
    ("stablelm_1_6b", 1_644_367_872), ("qwen1_5_32b", 35_197_096_960),
    ("deepseek_67b", 67_425_001_472),
    ("mistral_large_123b", 122_610_069_504)])
def test_param_count_matches_jax(arch, count):
    cfg = configs.get_config(arch)
    assert cfg.param_count() == JT.count_params(
        j_configs.get_config(arch)) == count
    assert cfg.active_param_count() == count


def test_init_params_draws_the_jax_layout():
    """The port's own init has the JAX pytree's keys and shapes (QKV
    biases, SwiGLU's wg/wi/wo, LayerNorm's bias), zero biases and
    N(0, 1/fan_in) weights."""
    cfg_j, cfg = model_configs("qwen1_5_32b")
    pj = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.structure(pj) == jax.tree.structure(
        T.tree_map(lambda a: a.numpy(), pt))
    for a, b in zip(jax.tree.leaves(pj), _leaves(pt)):
        assert a.shape == tuple(b.shape)
    attn = pt["stages"][0][0]["attn"]
    assert not any(attn[k].any() for k in ("bq", "bk", "bv"))
    d = cfg.d_model
    assert abs(float(attn["wq"].std()) * np.sqrt(d) - 1.0) < 0.05
    h_dh = cfg.n_heads * cfg.head_dim
    assert abs(float(attn["wo"].std()) * np.sqrt(h_dh) - 1.0) < 0.05


def test_params_from_numpy_checks_keys(model):
    cfg_j, cfg, pj, _, _, _ = model
    tree = jax.tree.map(np.asarray, pj)
    del tree["stages"][0][0]["mlp"]["wg"]
    with pytest.raises(ValueError, match="mlp"):
        params_from_numpy(cfg, tree)


def test_init_cache_matches_jax(model):
    """The zero decode caches: the JAX package's shapes and types (a ring
    of the window's length where the spec has one), and those of the
    cache a prefill returns."""
    cfg_j, cfg, _, pt, toks, _ = model
    cj = JT.init_cache(cfg_j, B, S + GEN)
    ct = T.init_cache(cfg, B, S + GEN)
    _, pre = T.forward(pt, cfg, tokens=t(toks[:, :S]), mode="prefill",
                       cache_len=S + GEN)
    for a, b, c in zip(jax.tree.leaves(cj), _leaves(ct), _leaves(pre)):
        assert a.shape == tuple(b.shape) == tuple(c.shape)
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
        assert not b.any()


def test_train_logits_match_jax(model, compute):
    cfg_j, cfg, pj, pt, toks, _ = model
    want = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, :S]),
                      mode="train")
    got = T.forward(pt, cfg, tokens=t(toks[:, :S]), mode="train")
    assert got.shape == (B, S, cfg.padded_vocab)
    assert_close(got.float(), _f32(want), RTOL[compute])


def test_prefill_and_decode_match_jax(model, compute):
    """Prefill logits and caches, then one decode step from them."""
    cfg_j, cfg, pj, pt, toks, _ = model
    lj, cj = _jax_prefill(model, compute)
    lt, ct = T.forward(pt, cfg, tokens=t(toks[:, :S]), mode="prefill",
                       cache_len=S + GEN)
    assert_close(lt.float(), _f32(lj), RTOL[compute])
    for a, b in zip(jax.tree.leaves(cj), _leaves(ct)):
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
        assert_close(b[0].float(), _f32(a[0]), CACHE_RTOL)
        assert_close(b.float(), _f32(a), max(RTOL[compute], CACHE_RTOL))
    dj, _ = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, S:S + 1]),
                       mode="decode", cache=cj, pos=jnp.array(S, jnp.int32))
    dt, _ = T.forward(pt, cfg, tokens=t(toks[:, S:S + 1]), mode="decode",
                      cache=ct, pos=S)
    assert_close(dt.float(), _f32(dj), RTOL[compute])


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_bf16_block_rounds_as_the_reference(model, mode):
    """The first block in bf16 against the JAX package's rounded as its
    program is written (``block_want``), train and one decode step from
    its prefill cache.  Whole jitted programs round in fewer places: XLA
    keeps the f32 sum of a residual add for the norm that reads it,
    which is most of the whole-model bf16 spread that ``RTOL`` allows."""
    x, want, cache = _block_want(model, mode)
    share, rel = differ(block_got(model[1], model[3], x, cache, mode), want)
    assert share <= BLOCK_DIFFER, f"{share:.2%} of the elements differ"
    assert rel <= CACHE_RTOL, rel


@pytest.mark.parametrize("kind", UNSOUND)
def test_bf16_block_catches_unsound_roundings(model, kind):
    """Each rounding the port must not make, in place of the reference's
    (f32 scores from upcast q and k, the weights divided in f32, the
    sigmoid rounded before the product), fails the block test."""
    x, want, cache = _block_want(model, "train")
    with unsound(kind):
        share, _ = differ(block_got(model[1], model[3], x, cache, "train"),
                          want)
    assert share > BLOCK_DIFFER, f"only {share:.2%} of the elements differ"


@pytest.mark.parametrize("model", ["stablelm_1_6b"], indirect=True)
def test_bf16_rtol_catches_bf16_scores(model):
    """Attention scores formed in bf16 read above ``RTOL`` at the model
    level: stablelm-1.6b's decode logits after a prefill."""
    cfg_j, cfg, pj, pt, toks, _ = model
    lj, cj = _jax_prefill(model, "bf16")
    dj, _ = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, S:S + 1]),
                       mode="decode", cache=cj, pos=jnp.array(S, jnp.int32))
    with unsound("bf16 scores"):
        _, ct = T.forward(pt, cfg, tokens=t(toks[:, :S]), mode="prefill",
                          cache_len=S + GEN)
        dt, _ = T.forward(pt, cfg, tokens=t(toks[:, S:S + 1]),
                          mode="decode", cache=ct, pos=S)
    _, rel = differ(dt.float().numpy(), _f32(dj))
    assert rel > RTOL["bf16"], rel


@pytest.mark.parametrize("s", [32, 40])
def test_prefill_decode_consistency(model, s):
    """The JAX package's ``test_prefill_decode_consistency`` on the port
    (bf16, as served): the decode logits at position s after a prefill
    of s tokens against the train forward's at s."""
    _, cfg, _, pt, toks, _ = model
    full = T.forward(pt, cfg, tokens=t(toks[:, :s + 1]), mode="train")
    _, cache = T.forward(pt, cfg, tokens=t(toks[:, :s]), mode="prefill",
                         cache_len=s + 8)
    dl, _ = T.forward(pt, cfg, tokens=t(toks[:, s:s + 1]), mode="decode",
                      cache=cache, pos=s)
    a, b = full[:, s].float(), dl[:, 0].float()
    rel = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-9)
    assert rel < 0.05
    assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_generate_teacher_forced(model, compute):
    """The JAX ``generate``'s tokens fed to the port's decode steps: each
    step's logits within the tolerance of the JAX decode's on the same
    tokens, and each port argmax equal to the JAX token, except where the
    JAX logits' top-2 margin is under the tolerance (a bf16 near-tie
    either side may break).  The port's own ``generate`` keeps the prompt
    and, in f32, gives the JAX tokens."""
    cfg_j, cfg, pj, pt, toks, _ = model
    prompts = toks[:, :S]
    out_j = np.array(j_serve.generate(cfg_j, pj, jnp.asarray(prompts), GEN))
    out = serve.generate(cfg, pt, t(prompts), GEN)
    assert out.shape == (B, S + GEN) and torch.equal(out[:, :S], t(prompts))
    lj, cj = _jax_prefill(model, compute)
    lt, cache = T.forward(pt, cfg, tokens=t(prompts), mode="prefill",
                          cache_len=S + GEN)
    decode_j = jax.jit(lambda p, tok, c, pos: JT.forward(
        p, cfg_j, tokens=tok, mode="decode", cache=c, pos=pos))
    step = make_serve_step(cfg)
    checked = 0
    for i in range(GEN):
        if i:
            fed = out_j[:, S + i - 1:S + i]
            lj, cj = decode_j(pj, jnp.asarray(fed), cj,
                              jnp.array(S + i - 1, jnp.int32))
            lt, _ = T.forward(pt, cfg, tokens=t(fed), mode="decode",
                              cache=cache, pos=S + i - 1)
            tok_t, cache = step(pt, cache, t(fed), S + i - 1)
            got = tok_t[:, 0].numpy()
        else:
            got = out[:, S].numpy()
        assert_close(lt.float(), _f32(lj), RTOL[compute])
        lj = _f32(lj)[:, -1, :cfg.vocab]
        top2 = np.sort(lj, -1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]) / np.abs(lj).max()
        for r in range(B):
            if margin[r] >= RTOL[compute]:
                assert got[r] == out_j[r, S + i], (i, r)
                checked += 1
    if compute == "f32":
        assert checked == B * GEN
        np.testing.assert_array_equal(out.numpy(), out_j)
    else:
        assert checked >= 1


def test_gelu_ffn_matches_jax(compute):
    """``ffn="gelu"`` (jax.nn.gelu's tanh form) on one block's params,
    whose keys and shapes the port's init shares."""
    cfg_j, cfg = model_configs("stablelm_1_6b")
    pj = JT.init_block(jax.random.PRNGKey(2), cfg_j,
                       j_models.BlockSpec("gqa", "gelu"))["mlp"]
    mlp = T.tree_map(lambda a: t(np.array(a)), pj)
    meta = T.init_block(None, cfg, t_models.BlockSpec("gqa", "gelu"),
                        device="meta")["mlp"]
    assert T.tree_map(lambda a: tuple(a.shape), meta) == \
        T.tree_map(lambda a: tuple(a.shape), mlp)
    x = np.random.RandomState(3).randn(B, 8, cfg.d_model).astype(np.float32)
    want = JT._ffn(j_common.cast(jnp.asarray(x)), pj, "gelu", cfg_j)
    got = T._ffn(t_common.cast(t(x)), mlp, "gelu", cfg)
    assert_close(got.float(), _f32(want), RTOL[compute])


def test_serve_main_on_cpu(capsys):
    out = serve.main(["--arch", "stablelm_1_6b", "--smoke", "--batch", "2",
                      "--prompt-len", "20", "--gen", "3", "--device", "cpu"])
    assert out.shape == (2, 23)
    cfg = configs.get_config("stablelm_1_6b", smoke=True)
    assert int(out.max()) < cfg.vocab
    assert "stablelm-1.6b-smoke: generated 3 tokens x 2 seqs" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "recurrentgemma_9b",
                                  "internvl2_26b", "deepseek_v2_lite_16b"])
def test_other_configs_are_not_ported(arch):
    """The configs outside the attention family, which the registry
    refused until their families were ported, now load: full and smoke,
    equal to the JAX package's, each in ``all_configs``."""
    for smoke in (False, True):
        want = j_configs.get_config(arch, smoke=smoke)
        got = configs.get_config(arch, smoke=smoke)
        assert repr(got).replace("repro_torch.", "") == \
            repr(want).replace("repro.", "")
        assert configs.all_configs(smoke)[arch] == got
