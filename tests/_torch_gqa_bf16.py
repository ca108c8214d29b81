"""bf16 readings of the port's decoder attention family against the JAX
package, and the unsound roundings that the bf16 checks of
``test_torch_decoder.py`` must catch.

    PYTHONPATH=src:tests python tests/_torch_gqa_bf16.py

prints, for each smoke model, for the port as it is and for each
unsound variant: the share of the first block's bf16 elements (train,
and one decode step) that differ from the JAX block run op by op, with
max|d|/max|y|; the whole model's bf16 train, prefill and decode logits
against the jitted JAX package (as the tests hold them) and against its
op-by-op run (``jax.disable_jit``); and the largest over the decode
steps of a teacher-forced ``generate``; each as max|d|/max|logit|."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import repro.models as j_models
import repro_torch.models as t_models
from repro import configs as j_configs
from repro.models import common as j_common
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.models import attention as attn_lib
from repro_torch.models import params_from_numpy
from repro_torch.models import transformer as T

ARCHS = ("stablelm_1_6b", "qwen1_5_32b", "deepseek_67b",
         "mistral_large_123b")
#: the four smoke configs and a sliding-window spec (mistral's GQA 8/2
#: with a 16-wide window): at S = 40 its prefill keeps the last 16 keys
#: rolled by 40 % 16 and decode writes the ring at pos % 16
MODELS = ARCHS + ("window",)
B, S, GEN = 2, 40, 6
#: roundings the port must not make, each in place of the reference's
UNSOUND = ("bf16 scores", "weights cast before the divide", "F.silu")


def model_configs(name):
    """(JAX config, port config) of a smoke model."""
    if name != "window":
        return (j_configs.get_config(name, smoke=True),
                configs.get_config(name, smoke=True))
    out = []
    for mod, cfg_mod in ((j_models, j_configs), (t_models, configs)):
        base = cfg_mod.get_config("mistral_large_123b", smoke=True)
        spec = mod.BlockSpec("gqa", "dense", window=16)
        out.append(dataclasses.replace(base, name="window-smoke",
                                       stages=(mod.Stage((spec,), 3),)))
    return tuple(out)


def draw(name):
    """(JAX config, port config, JAX params, the same params in the
    port, tokens (B, S + 1)) of a smoke model."""
    cfg_j, cfg = model_configs(name)
    pj = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg, jax.tree.map(np.asarray, pj))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S + 1),
                                       0, cfg.vocab))
    return cfg_j, cfg, pj, pt, toks


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def bf16(a) -> torch.Tensor:
    """A JAX bf16 array as a CPU torch bf16 tensor (exactly)."""
    return torch.from_numpy(f32(a).copy()).to(torch.bfloat16)


def _attend_block(kind):
    """``attention._attend_block`` with one unsound rounding."""
    def attend(q, k, v, pos_q, pos_k, *, causal, window, kv_len, scale):
        if kind == "bf16 scores":
            scores = torch.einsum("bqhgd,bshd->bhgqs", q, k).float()
        else:
            scores = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float())
        scores = scores * scale
        mask = torch.ones(scores.shape[-2:], dtype=torch.bool)
        if causal:
            mask &= pos_k[None, :] <= pos_q[:, None]
        if window is not None:
            mask &= pos_k[None, :] > pos_q[:, None] - window
        if kv_len is not None:
            mask &= (pos_k < kv_len)[None, :]
        scores = scores.masked_fill(~mask, attn_lib.NEG_INF)
        e = torch.exp(scores - scores.amax(-1, keepdim=True))
        if kind == "bf16 scores":
            w = (e / e.sum(-1, keepdim=True)).to(v.dtype)
        else:
            w = e.to(v.dtype) / e.sum(-1, keepdim=True).to(v.dtype)
        return torch.einsum("bhgqs,bshd->bqhgd", w, v)
    return attend


@contextlib.contextmanager
def unsound(kind):
    """The port with the rounding ``kind`` (one of ``UNSOUND``) in place
    of the reference's, for the block."""
    if kind == "F.silu":
        old, T.silu = T.silu, F.silu
        try:
            yield
        finally:
            T.silu = old
        return
    old, attn_lib._attend_block = attn_lib._attend_block, _attend_block(kind)
    try:
        yield
    finally:
        attn_lib._attend_block = old


def block_want(cfg_j, pj, toks, mode, op_by_op=False):
    """The JAX package's first block in bf16 as its program is written
    to round: the output of a train forward over the prompt, or of one
    decode step from the block's prefill cache; and that cache (None in
    train).  The attention half and the ffn half are jitted one at a
    time (``op_by_op``: run op by op, ``jax.disable_jit``): jitted
    whole, XLA keeps the f32 residual sum for the norm that reads it and
    skips its bf16 rounding."""
    spec = cfg_j.stages[0].unit[0]
    bj = jax.tree.map(lambda a: a[0], pj["stages"][0][0])
    x = j_common.cast(pj["embed"][jnp.asarray(toks)])
    jit = (lambda f: f) if op_by_op else jax.jit
    ffn = jit(lambda h: JT._ffn(h, bj["mlp"], spec.ffn, cfg_j))
    with jax.disable_jit(op_by_op):
        if mode == "train":
            h, _ = jit(lambda x: JT._gqa_block(
                x, bj["attn"], spec, cfg_j, "train", None, None))(x[:, :S])
            return x, f32(ffn(h)), None
        _, cache = jit(lambda x: JT._gqa_block(
            x, bj["attn"], spec, cfg_j, "prefill", None, None,
            S + GEN))(x[:, :S])
        h, _ = jit(lambda x, c: JT._gqa_block(
            x, bj["attn"], spec, cfg_j, "decode", c,
            jnp.array(S, jnp.int32)))(x[:, S:], cache)
    return x, f32(ffn(h)), cache


def block_got(cfg, pt, x, cache, mode) -> np.ndarray:
    """The port's first block on the same input (and cache)."""
    spec = cfg.stages[0].unit[0]
    bt = T.tree_map(lambda a: a[0], pt["stages"][0][0])
    if mode == "train":
        y, _ = T.apply_block(bf16(x[:, :S]), bt, spec, cfg, mode="train")
    else:
        y, _ = T.apply_block(bf16(x[:, S:]), bt, spec, cfg, mode="decode",
                             cache=T.tree_map(bf16, cache), pos=S)
    return y.float().numpy()


def differ(got, want) -> tuple:
    """(share of the elements that differ, max|d| / max|want|)."""
    d = np.abs(got - want)
    return float((d > 0).mean()), float(d.max() / np.abs(want).max())


def model_logits_jax(cfg_j, pj, toks):
    """The JAX package's bf16 train, prefill and decode logits."""
    tr = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, :S]),
                    mode="train")
    pl, cache = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, :S]),
                           mode="prefill", cache_len=S + GEN)
    dl, _ = JT.forward(pj, cfg_j, tokens=jnp.asarray(toks[:, S:S + 1]),
                       mode="decode", cache=cache,
                       pos=jnp.array(S, jnp.int32))
    return tuple(f32(a) for a in (tr, pl, dl))


def model_logits_port(cfg, pt, toks):
    """The port's bf16 train, prefill and decode logits."""
    tr = T.forward(pt, cfg, tokens=torch.as_tensor(toks[:, :S]),
                   mode="train")
    pl, cache = T.forward(pt, cfg, tokens=torch.as_tensor(toks[:, :S]),
                          mode="prefill", cache_len=S + GEN)
    dl, _ = T.forward(pt, cfg, tokens=torch.as_tensor(toks[:, S:S + 1]),
                      mode="decode", cache=cache, pos=S)
    return tuple(a.float().numpy() for a in (tr, pl, dl))


def teacher_forced(cfg_j, cfg, pj, pt, toks) -> float:
    """The largest reading over the ``GEN - 1`` bf16 decode steps fed the
    JAX ``generate``'s tokens, port against the jitted JAX package."""
    from repro.launch import serve as j_serve
    prompts = toks[:, :S]
    out = np.array(j_serve.generate(cfg_j, pj, jnp.asarray(prompts), GEN))
    _, cj = JT.forward(pj, cfg_j, tokens=jnp.asarray(prompts),
                       mode="prefill", cache_len=S + GEN)
    _, ct = T.forward(pt, cfg, tokens=torch.as_tensor(prompts),
                      mode="prefill", cache_len=S + GEN)
    decode = jax.jit(lambda p, tok, c, pos: JT.forward(
        p, cfg_j, tokens=tok, mode="decode", cache=c, pos=pos))
    worst = 0.0
    for i in range(S, S + GEN - 1):
        fed = out[:, i:i + 1]
        lj, cj = decode(pj, jnp.asarray(fed), cj, jnp.array(i, jnp.int32))
        lt, ct = T.forward(pt, cfg, tokens=torch.as_tensor(fed),
                           mode="decode", cache=ct, pos=i)
        worst = max(worst, differ(lt.float().numpy(), f32(lj))[1])
    return worst


def main() -> None:
    for name in MODELS:
        cfg_j, cfg, pj, pt, toks = draw(name)
        wants = {m: block_want(cfg_j, pj, toks, m)
                 for m in ("train", "decode")}
        same = all(np.array_equal(w[1], block_want(cfg_j, pj, toks, m,
                                                    op_by_op=True)[1])
                   for m, w in wants.items())
        ref = {"jit": model_logits_jax(cfg_j, pj, toks)}
        with jax.disable_jit():
            ref["op by op"] = model_logits_jax(cfg_j, pj, toks)
        print(f"{name}: the JAX block's halves jitted one at a time equal "
              f"its op-by-op run: {same}")
        for kind in ("the port",) + UNSOUND:
            ctx = (contextlib.nullcontext() if kind == "the port"
                   else unsound(kind))
            with ctx:
                line = f"  {kind:31s} block"
                for m, (x, want, cache) in wants.items():
                    share, rel = differ(block_got(cfg, pt, x, cache, m),
                                        want)
                    line += f" {m} {share:.2%} differ, rel {rel:.3e};"
                got = model_logits_port(cfg, pt, toks)
                for r, logits in ref.items():
                    line += f" vs {r} train/prefill/decode " + " ".join(
                        f"{differ(g, w)[1]:.4e}" for g, w in zip(got, logits))
                    line += ";"
                line += (f" teacher-forced decode steps vs jit "
                         f"{teacher_forced(cfg_j, cfg, pj, pt, toks):.4e}")
            print(line, flush=True)


if __name__ == "__main__":
    main()
