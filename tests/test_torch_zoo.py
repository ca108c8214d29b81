"""The last model families of the port against the JAX package's, on the
CPU at the smoke configs: mixtral-8x7b (MoE with a sliding window),
deepseek-v2-lite-16b (MLA, MoE with shared experts, a dense first
layer), recurrentgemma-9b (RG-LRU blocks beside windowed MQA),
internvl2-26b (a vision prefix before the tokens) and whisper-base (the
encoder-decoder with cross-attention).  The same weights (the port's
``init_params`` draws as numpy, carried into the port by
``params_from_numpy`` and into the JAX package as its pytree), tokens and
embeddings go through the train, prefill and decode forwards and a
teacher-forced ``generate``; then the configs, parameter counts, caches,
the port's own prefill/decode consistency, one bf16 block of each new
kind, and the CLI.

The forwards run with both packages' compute type switched to f32 (the
same function, summed in another order: 1e-4 of max|logit|) and in bf16,
the serving type, at PR 21's 1.8e-2.  In bf16 the reference is the JAX
program compiled without excess precision
(``xla_allow_excess_precision=False``), which rounds where the program is
written to round and so equals its op-by-op run bit for bit: jitted with
XLA's defaults it keeps f32 values across some bf16 roundings, and its
own logits then differ from its op-by-op ones by 3.6e-2
(recurrentgemma-9b) and, where that moves a router near-tie, 0.27
(mixtral-8x7b).  Top-k routing is discontinuous: where a token's k-th
and (k+1)-th router logits lie within the bf16 tolerance, rounding may
send it to another expert, and the logits from there on differ by far
more than a rounding (with the JAX package's own draws, deepseek-v2-lite
smoke routes one token apart and its logits there move 0.13).  So every
comparison of a MoE model records both packages' router logits: in f32
no token may route apart; in bf16 every token they route apart must be
such a near-tie in the reference, and only the positions before the
first one of its row are compared.  With these tests' draws none is
routed apart."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

import repro.models.common as j_common                          # noqa: E402
import repro.models.moe as j_moe                                # noqa: E402
import repro_torch.models.common as t_common                    # noqa: E402
import repro_torch.models.moe as t_moe                          # noqa: E402
from _torch_parity import assert_close, t                       # noqa: E402
from repro import configs as j_configs                          # noqa: E402
from repro.launch import serve as j_serve                       # noqa: E402
from repro.launch import steps as j_steps                       # noqa: E402
from repro.models import transformer as JT                      # noqa: E402
from repro_torch import configs                                 # noqa: E402
from repro_torch.launch import serve                            # noqa: E402
from repro_torch.launch import steps                            # noqa: E402
from repro_torch.models import params_from_numpy                # noqa: E402
from repro_torch.models import transformer as T                 # noqa: E402

ARCHS = ("mixtral_8x7b", "deepseek_v2_lite_16b", "recurrentgemma_9b",
         "internvl2_26b", "whisper_base")
B, S, GEN = 2, 40, 6
#: whisper-base's encoder frames in these tests
ENC_LEN = 24
#: relative to max|logit|, per compute type: f32, the same function
#: summed in another order (measured 3.2e-7 to 2.6e-6); bf16, PR 21's
#: tolerance, against the JAX program as written (measured: train
#: 3.7e-3 to 1.47e-2, prefill up to 9.7e-3, decode from one cache 0)
RTOL = {"f32": 1e-4, "bf16": 1.8e-2}
#: a cache leaf stored in bf16 from f32 values that differ in their last
#: bits: one bf16 rounding, relative to max|leaf|
CACHE_RTOL = 2.0 ** -8
#: one bf16 block against the JAX one as written: the share of its
#: elements that may differ (a matmul's f32 sums in another order flip an
#: element's last bit; a rounding in another place flips half of them)
BLOCK_DIFFER = 0.01
#: the JAX package compiled to round where its program is written to
AS_WRITTEN = {"xla_allow_excess_precision": False}


@pytest.fixture(params=["f32", "bf16"])
def compute(request, monkeypatch):
    """Both packages' compute type; returns its name."""
    if request.param == "f32":
        monkeypatch.setattr(j_common, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(t_common, "COMPUTE_DTYPE", torch.float32)
    return request.param


def _inputs(cfg, rng):
    """The embeddings a config's forward takes beside its tokens: a
    vision prefix or encoder frames (numpy f32, cast by the forward)."""
    if cfg.n_prefix:
        return {"prefix_embeds": rng.randn(B, cfg.n_prefix, cfg.d_model)
                .astype(np.float32)}
    if cfg.kind == "encdec":
        return {"enc_embeds": rng.randn(B, ENC_LEN, cfg.d_model)
                .astype(np.float32)}
    return {}


@dataclasses.dataclass
class Model:
    cfg_j: object
    cfg: object
    pj: dict
    pt: dict
    toks: np.ndarray
    extra: dict              # prefix or encoder embeddings (numpy)
    memo: dict

    def kw_j(self):
        return {k: jnp.asarray(v) for k, v in self.extra.items()}

    def kw_t(self):
        return {k: t(v) for k, v in self.extra.items()}

    def jax_fn(self, compute, mode):
        """The JAX forward in ``mode`` compiled as written (one program
        per model, compute type and mode; a prefill's cache has room for
        ``GEN`` decode steps after the prefix and the prompt)."""
        key = (compute, mode)
        if key not in self.memo:
            cfg_j = self.cfg_j
            if mode == "decode":
                def fn(p, tok, c, pos):
                    return JT.forward(p, cfg_j, tokens=tok, mode="decode",
                                      cache=c, pos=pos)
            else:
                def fn(p, tok, kw):
                    return JT.forward(p, cfg_j, tokens=tok, mode=mode,
                                      cache_len=S + GEN + self.cfg.n_prefix,
                                      **kw)
            self.memo[key] = jax.jit(fn, compiler_options=AS_WRITTEN)
        return self.memo[key]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg_j = j_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    tree = T.tree_map(lambda a: a.numpy(), T.init_params(
        cfg, torch.Generator().manual_seed(0)))
    pj = jax.tree.map(jnp.asarray, tree)
    pt = params_from_numpy(cfg, tree)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, (B, S + 1))
    return Model(cfg_j, cfg, pj, pt, toks, _inputs(cfg, rng), {})


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _leaves(tree):
    """A port pytree's leaves in ``jax.tree.leaves`` order."""
    return jax.tree.leaves(T.tree_map(lambda a: a, tree))


@contextlib.contextmanager
def routes():
    """Record both packages' router logits, f32 (B, T, E), call by call
    (the JAX ones through ordered callbacks, so in program order)."""
    log = {"jax": [], "port": []}
    j_route, t_route = j_moe.route, t_moe.route

    def jax_route(logits, cfg, cap):
        jax.debug.callback(lambda a: log["jax"].append(np.array(a)),
                           logits.astype(jnp.float32), ordered=True)
        return j_route(logits, cfg, cap)

    def port_route(logits, cfg, cap):
        log["port"].append(logits.float().numpy())
        return t_route(logits, cfg, cap)

    j_moe.route, t_moe.route = jax_route, port_route
    try:
        yield log
    finally:
        j_moe.route, t_moe.route = j_route, t_route
        jax.effects_barrier()


def routed_apart(log, cfg, compute, n: int) -> np.ndarray:
    """(B, n) bool: the tokens of a forward over ``n`` positions that the
    two packages sent to different top-k experts in any MoE layer.  Each
    must be a near-tie in the reference (its k-th and (k+1)-th logits
    within the bf16 tolerance of max|logit|); in f32 there must be
    none."""
    jax.effects_barrier()
    assert len(log["jax"]) == len(log["port"])
    apart = np.zeros((B, n), bool)
    if not log["jax"]:
        return apart
    k = cfg.moe.top_k
    for lj, lt in zip(log["jax"], log["port"]):
        assert lj.shape == lt.shape == (B, n, cfg.moe.n_experts)
        sj, st = (np.sort(np.argsort(-a, -1, kind="stable")[..., :k], -1)
                  for a in (lj, lt))
        here = (sj != st).any(-1)
        top = -np.sort(-lj, -1)
        gap = top[..., k - 1] - top[..., k]
        assert (gap[here] <= RTOL["bf16"] * np.abs(lj).max()).all(), \
            "tokens routed apart where the reference has no near-tie"
        apart |= here
    if compute == "f32":
        assert not apart.any(), "f32 tokens routed apart"
    return apart


def before_first(apart: np.ndarray, n: int) -> np.ndarray:
    """Per row, the positions (of ``n``) before its first token routed
    apart."""
    first = np.where(apart.any(1), apart.argmax(1), n)
    return np.arange(n)[None, :] < first[:, None]


def assert_rows_close(got, want, keep, rtol):
    """``got`` vs ``want`` ((B, T, V)) at the positions ``keep`` marks;
    most of them must be kept."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert keep.mean() >= 0.5, f"only {keep.mean():.0%} compared"
    assert_close(got[keep], want[keep], rtol)


def _prefill_j(m, compute):
    """The JAX prefill of the prompt: (logits, cache, tokens routed
    apart from the port's prefill), once per model and compute type."""
    key = (compute, "prefill result")
    if key not in m.memo:
        with routes() as log:
            lj, cj = m.jax_fn(compute, "prefill")(
                m.pj, jnp.asarray(m.toks[:, :S]), m.kw_j())
            lt, ct = T.forward(m.pt, m.cfg, tokens=t(m.toks[:, :S]),
                               mode="prefill",
                               cache_len=S + GEN + m.cfg.n_prefix,
                               **m.kw_t())
        m.memo[key] = (lj, cj, lt, ct,
                       routed_apart(log, m.cfg, compute, S + m.cfg.n_prefix))
    return m.memo[key]


# --- configs --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    for smoke in (False, True):
        j, p = (mod.get_config(arch, smoke=smoke)
                for mod in (j_configs, configs))
        assert repr(j).replace("repro.", "") == repr(p).replace(
            "repro_torch.", "")


@pytest.mark.parametrize("arch,count", [
    ("mixtral_8x7b", 46_702_792_704),
    ("deepseek_v2_lite_16b", 15_706_484_224),
    ("recurrentgemma_9b", 9_396_088_832),
    ("internvl2_26b", 19_862_722_560),
    ("whisper_base", 70_680_576)])
def test_param_count_matches_jax(arch, count):
    cfg, cfg_j = configs.get_config(arch), j_configs.get_config(arch)
    assert cfg.param_count() == JT.count_params(cfg_j) == count
    assert cfg.active_param_count() == JT.count_params(
        cfg_j, active_only=True)
    if cfg.moe is None:
        assert cfg.active_param_count() == count
    else:
        assert cfg.active_param_count() < count


def test_init_params_has_the_jax_layout(model):
    """The port's own init: the JAX pytree's keys and shapes (MLA's
    ``w_dkv``/``kv_ln``, the experts' (E, D, F), RG-LRU's ``lam``, the
    cross-attention and ``enc_stages``/``enc_norm``), ``lam`` as
    ``linspace(0.5, 4, w)``, N(0, 1/fan_in) expert weights."""
    shapes = jax.eval_shape(lambda k: JT.init_params(model.cfg_j, k),
                            jax.random.PRNGKey(0))
    pt = T.init_params(model.cfg, torch.Generator().manual_seed(0))
    assert jax.tree.structure(shapes) == jax.tree.structure(
        T.tree_map(lambda a: a.numpy(), pt))
    for a, b in zip(jax.tree.leaves(shapes), _leaves(pt)):
        assert a.shape == tuple(b.shape)
    blocks = [b for st in pt["stages"] for b in st]
    for b in blocks:
        if "rec" in b:
            np.testing.assert_allclose(
                b["rec"]["lam"][0].numpy(),
                np.linspace(0.5, 4.0, model.cfg.rnn_width), rtol=1e-6)
        if "moe" in b:
            d = model.cfg.d_model
            assert abs(float(b["moe"]["wi"].std()) * np.sqrt(d) - 1) < 0.05


def test_params_from_numpy_checks_keys(model):
    tree = jax.tree.map(np.asarray, model.pj)
    name = "enc_norm" if "enc_norm" in tree else "stages"
    if name == "enc_norm":
        del tree["enc_norm"]["bias"]
    else:
        del tree["stages"][-1][-1][next(k for k in ("moe", "rec", "mlp")
                                        if k in tree["stages"][-1][-1])]
    with pytest.raises(ValueError, match=name):
        params_from_numpy(model.cfg, tree)


def test_init_cache_matches_jax(model):
    """The zero decode caches (MLA's compressed kv and rope key, RG-LRU's
    state and conv tail, the ring of a window, cross-attention's k/v over
    the encoder's frames): the JAX package's shapes and types, and those
    of the cache a prefill returns."""
    n = S + GEN + model.cfg.n_prefix
    cj = JT.init_cache(model.cfg_j, B, n, ENC_LEN)
    ct = T.init_cache(model.cfg, B, n, ENC_LEN)
    _, pre = T.forward(model.pt, model.cfg, tokens=t(model.toks[:, :S]),
                       mode="prefill", cache_len=S + GEN + model.cfg.n_prefix,
                       **model.kw_t())
    for a, b, c in zip(jax.tree.leaves(cj), _leaves(ct), _leaves(pre)):
        assert a.shape == tuple(b.shape) == tuple(c.shape)
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
        assert not b.any()


# --- forwards -------------------------------------------------------------

def test_train_logits_match_jax(model, compute):
    m = model
    with routes() as log:
        want = _f32(m.jax_fn(compute, "train")(
            m.pj, jnp.asarray(m.toks[:, :S]), m.kw_j()))
        got = T.forward(m.pt, m.cfg, tokens=t(m.toks[:, :S]), mode="train",
                        **m.kw_t())
    n = S + m.cfg.n_prefix
    assert got.shape == (B, n, m.cfg.padded_vocab)
    keep = before_first(routed_apart(log, m.cfg, compute, n), n)
    assert_rows_close(got, want, keep, RTOL[compute])


def _shared_cache(cj):
    """The JAX prefill's cache with every leaf in the compute type (the
    conv tails, stored in bf16, taken to f32 exactly in f32 compute), for
    both packages: decode steps from it compute one function."""
    cj = jax.tree.map(lambda a: a.astype(j_common.COMPUTE_DTYPE), cj)
    return cj, T.tree_map(lambda a: t(_f32(a)).to(t_common.COMPUTE_DTYPE),
                          T.tree_map(lambda a: a, cj))


def test_prefill_and_decode_match_jax(model, compute):
    """Prefill logits and caches (in bf16 a row whose prompt was routed
    apart is left out; the conv tails, stored in bf16 in both packages,
    agree in f32 to one bf16 rounding), then one decode step in each
    package from the JAX prefill's cache."""
    m = model
    lj, cj, lt, ct, apart = _prefill_j(m, compute)
    rows = ~apart.any(1)
    assert_rows_close(lt, _f32(lj), np.broadcast_to(rows[:, None], (B, 1)),
                      RTOL[compute])
    for a, b in zip(jax.tree.leaves(cj), _leaves(ct)):
        assert a.shape == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
        if compute == "f32":
            assert_close(b.float(), _f32(a), RTOL["f32"]
                         if b.dtype == torch.float32 else CACHE_RTOL)
    cj, ct = _shared_cache(cj)
    pos = S + m.cfg.n_prefix
    with routes() as log:
        dj, _ = m.jax_fn(compute, "decode")(
            m.pj, jnp.asarray(m.toks[:, S:S + 1]), cj,
            jnp.array(pos, jnp.int32))
        dt, _ = T.forward(m.pt, m.cfg, tokens=t(m.toks[:, S:S + 1]),
                          mode="decode", cache=ct, pos=pos)
    rows = ~routed_apart(log, m.cfg, compute, 1).any(1)
    assert_rows_close(dt, _f32(dj), np.broadcast_to(rows[:, None], (B, 1)),
                      RTOL[compute])


@pytest.mark.parametrize("model", ["internvl2_26b", "whisper_base"],
                         indirect=True)
def test_prefill_step_takes_the_batch_keys(model):
    """``make_prefill_step`` passes ``prefix_embeds`` and ``enc_embeds``
    on, as the JAX package's does (f32 compute: the argmax over the real
    vocabulary of the JAX prefill's logits)."""
    m = model
    with _f32_compute():
        lj = _f32(_prefill_j(m, "f32")[0])[:, -1, :m.cfg.vocab]
        nt, _ = steps.make_prefill_step(m.cfg, cache_len=S + 9)(
            m.pt, {"tokens": t(m.toks[:, :S]), **m.kw_t()})
    np.testing.assert_array_equal(nt.numpy(), lj.argmax(-1))


@contextlib.contextmanager
def _f32_compute():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(t_common, "COMPUTE_DTYPE", torch.float32)
        yield


def test_generate_teacher_forced(model):
    """f32 compute: the JAX ``generate``'s tokens (an encoder-decoder's
    with its frames; no prefix, as neither ``generate`` takes one) fed
    to both packages' decode steps from the JAX prefill's cache, each
    step's logits within 1e-4 and each next token the JAX one; the port's
    own ``generate`` keeps the prompt and gives the JAX tokens."""
    m = model
    prompts = m.toks[:, :S]
    enc = m.extra.get("enc_embeds")
    kw_j = {} if enc is None else {"enc_embeds": jnp.asarray(enc)}
    kw_t = {} if enc is None else {"enc_embeds": t(enc)}
    with _f32_compute():
        out_j = np.array(j_serve.generate(m.cfg_j, m.pj, jnp.asarray(prompts),
                                          GEN, **kw_j))
        out = serve.generate(m.cfg, m.pt, t(prompts), GEN, **kw_t)
        np.testing.assert_array_equal(out.numpy(), out_j)
        _, cj = m.jax_fn("f32", "prefill")(m.pj, jnp.asarray(prompts), kw_j)
        cj, ct = _shared_cache(cj)
        step = steps.make_serve_step(m.cfg)
        for i in range(S, S + GEN - 1):
            fed = out_j[:, i:i + 1]
            lj, cj = m.jax_fn("f32", "decode")(
                m.pj, jnp.asarray(fed), cj, jnp.array(i, jnp.int32))
            lt, _ = T.forward(m.pt, m.cfg, tokens=t(fed), mode="decode",
                              cache=ct, pos=i)
            assert_close(lt.float(), _f32(lj), RTOL["f32"])
            tok, ct = step(m.pt, ct, t(fed), i)
            np.testing.assert_array_equal(tok[:, 0].numpy(),
                                          out_j[:, i + 1])


@pytest.mark.parametrize("s", [32, 40])
def test_prefill_decode_consistency(model, compute, s, monkeypatch):
    """The JAX package's ``test_prefill_decode_consistency`` on the port:
    the decode logits at position s after a prefill of s tokens against
    the train forward's at s (the smoke MoE configs' capacity factor 2.0
    drops no token, so the two compute one function).  In f32, with the
    prefill's conv tails kept in f32 as well, within 1e-4 of max|logit|
    with the same argmax; in bf16, as served, within
    the JAX test's 0.05, the argmax equal where the train logits' top-2
    margin exceeds the bf16 tolerance."""
    m = model
    if compute == "f32":      # the conv tails too (the reference's bf16)
        monkeypatch.setattr(T, "CONV_TAIL_DTYPE", torch.float32)
    kw = m.kw_t()
    full = T.forward(m.pt, m.cfg, tokens=t(m.toks[:, :s + 1]), mode="train",
                     **kw)
    _, cache = T.forward(m.pt, m.cfg, tokens=t(m.toks[:, :s]),
                         mode="prefill", cache_len=s + 8 + m.cfg.n_prefix,
                         **kw)
    p = m.cfg.n_prefix
    dl, _ = T.forward(m.pt, m.cfg, tokens=t(m.toks[:, s:s + 1]),
                      mode="decode", cache=cache, pos=s + p)
    a, b = full[:, s + p].float(), dl[:, 0].float()
    scale = float(a.abs().max())
    assert float((a - b).abs().max()) < \
        (RTOL["f32"] if compute == "f32" else 0.05) * scale
    top2 = a.topk(2, -1).values
    sure = (top2[:, 0] - top2[:, 1]) >= RTOL[compute] * scale
    if compute == "f32":
        assert sure.all()
    assert torch.equal(a.argmax(-1)[sure], b.argmax(-1)[sure])


def test_encoder_decoder_needs_its_frames():
    cfg = configs.get_config("whisper_base", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="enc_embeds"):
        T.forward(params, cfg, tokens=torch.zeros((1, 4), dtype=torch.long))


# --- one bf16 block of each new kind --------------------------------------

#: (config, stage, position in unit) of a block of each new kind
BLOCKS = {"mla": ("deepseek_v2_lite_16b", 0, 0),
          "moe": ("deepseek_v2_lite_16b", 1, 0),
          "rec": ("recurrentgemma_9b", 0, 0),
          "cross": ("whisper_base", 0, 0)}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_bf16_block_rounds_as_the_reference(kind):
    """One bf16 block (its mixer, its cross-attention or its MoE ffn)
    against the JAX one compiled as written, on the same input: at most
    1 % of the elements differ (by a matmul's summation order)."""
    arch, si, ui = BLOCKS[kind]
    cfg_j = j_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    bt = T.init_block(torch.Generator().manual_seed(0), cfg,
                      cfg.stages[si].unit[ui])
    bj = jax.tree.map(jnp.asarray, T.tree_map(lambda a: a.numpy(), bt))
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(B, S, cfg.d_model), jnp.bfloat16)
    xt = t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    spec_j = cfg_j.stages[si].unit[ui]
    if kind == "mla":
        want = jax.jit(lambda x: JT._mla_block(
            x, bj["attn"], spec_j, cfg_j, "train", None, None)[0],
            compiler_options=AS_WRITTEN)(x)
        got = T._mla_block(xt, bt["attn"], cfg, "train", None, None)[0]
    elif kind == "rec":
        want = jax.jit(lambda x: JT._rec_block(
            x, bj["rec"], cfg_j, "train", None, None)[0],
            compiler_options=AS_WRITTEN)(x)
        got = T._rec_block(xt, bt["rec"], cfg, "train", None)[0]
    elif kind == "cross":
        enc = jnp.asarray(rng.randn(B, ENC_LEN, cfg.d_model), jnp.bfloat16)
        enc_t = t(np.asarray(enc.astype(jnp.float32))).to(torch.bfloat16)
        want = jax.jit(lambda x, e: JT._cross_block(
            x, bj["cross"], cfg_j, "train", None, e)[0],
            compiler_options=AS_WRITTEN)(x, enc)
        got = T._cross_block(xt, bt["cross"], cfg, "train", None, enc_t)[0]
    else:
        want = jax.jit(lambda x: j_moe.moe_ffn(x, bj["moe"], cfg_j.moe),
                       compiler_options=AS_WRITTEN)(x)
        got = t_moe.moe_ffn(xt, bt["moe"], cfg.moe)
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - _f32(want))
    assert (d > 0).mean() <= BLOCK_DIFFER, f"{(d > 0).mean():.2%} differ"
    assert d.max() <= 2.0 ** -7 * np.abs(_f32(want)).max()


# --- the CLI --------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "whisper_base"])
def test_serve_main_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "16", "--gen", "3", "--device", "cpu"])
    assert out.shape == (2, 19)
    cfg = configs.get_config(arch, smoke=True)
    assert int(out.max()) < cfg.vocab
    assert f"{cfg.name}: generated 3 tokens x 2 seqs" in \
        capsys.readouterr().out
