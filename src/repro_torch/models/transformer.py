"""Model assembly: param init, train/prefill/decode forward passes (port
of ``repro/models/transformer.py``).

Params keep the JAX package's pytree: ``embed``, ``final_norm`` and
``stages``, a tuple of stages, each a tuple (one entry per block of the
repeating unit) of dicts whose leaves are stacked over ``n_units``; an
encoder-decoder adds ``enc_stages`` and ``enc_norm``.  The JAX package
scans the units with ``lax.scan``; here :func:`run_stage` is a Python loop
over the stacked axis.  Caches mirror the same structure: sliding-window
attention keeps a ring buffer of the window's length, MLA the compressed
kv and the shared rope key, SSD and RG-LRU their O(1) states and conv
tails, cross-attention the encoder's k/v.

Every block of the reference runs: mixers ``gqa`` (GQA, MQA, MHA,
sliding windows), ``mla``, ``rec`` (RG-LRU) and ``ssd`` (Mamba-2), ffns
``dense`` (SwiGLU), ``gelu``, ``moe`` and ``none``, cross-attention, and
the kinds ``decoder`` and ``encdec``; anything else raises
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..launch.sharding import constrain, gather_fsdp
from . import attention as attn_lib
from .common import (apply_rotary, cast, dense_init, embed_init, gelu,
                     in_context, layer_norm, rms_norm, rotary_cos_sin, silu,
                     sinusoidal_at, sinusoidal_positions)
from .config import ArchConfig, BlockSpec, Stage
from .moe import moe_ffn
from .rglru import rg_lru, rg_lru_step
from .ssm import causal_conv1d, ssd_chunked, ssd_decode_step

#: the type a prefill stores the SSD and RG-LRU conv tails in, whatever
#: the compute type (the reference writes bf16); f32 checks of decode
#: against the train forward switch it with the compute type
CONV_TAIL_DTYPE = torch.bfloat16

MIXERS = ("gqa", "mla", "rec", "ssd")
FFNS = ("dense", "gelu", "moe", "none")
KINDS = ("decoder", "encdec")


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not one of the reference's: mixers {MIXERS}, ffns "
        f"{FFNS}, kinds {KINDS}")


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer not in MIXERS:
        raise _unsupported(f"mixer {spec.mixer!r}")
    if spec.ffn not in FFNS:
        raise _unsupported(f"ffn {spec.ffn!r}")


def _enc_stage(cfg: ArchConfig) -> Stage:
    """The encoder of an encoder-decoder: non-causal gqa/gelu blocks."""
    return Stage((BlockSpec(mixer="gqa", ffn="gelu", causal=False),),
                 cfg.n_enc_layers)


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensor leaves of same-structured dicts/tuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return tuple(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _norm(x, p, cfg: ArchConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def _norm_params(cfg: ArchConfig, d: int, device=None) -> Dict:
    p = {"scale": torch.ones((d,), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), device=device)
    return p


# ---------------------------------------------------------------------------
# Block param init
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ArchConfig, spec: BlockSpec, device=None) -> Dict:
    """One block's params, f32, drawn from ``gen`` in the JAX package's
    order and distributions, under its keys (the draws themselves
    differ)."""
    _check_spec(spec)
    d, dh = cfg.d_model, cfg.head_dim
    p: Dict[str, Any] = {}

    def dense(shape, fan_in):
        return dense_init(gen, shape, fan_in, device=device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    if spec.mixer == "gqa":
        h, hk = cfg.n_heads, cfg.n_kv_heads
        p["attn"] = {
            "ln": _norm_params(cfg, d, device),
            "wq": dense((d, h, dh), d),
            "wk": dense((d, hk, dh), d),
            "wv": dense((d, hk, dh), d),
            "wo": dense((h, dh, d), h * dh),
        }
        if cfg.qkv_bias:
            p["attn"].update(bq=zeros(h, dh), bk=zeros(hk, dh),
                             bv=zeros(hk, dh))
    elif spec.mixer == "mla":
        h = cfg.n_heads
        dr, dl = cfg.rope_dim, cfg.kv_lora
        p["attn"] = {
            "ln": _norm_params(cfg, d, device),
            "wq": dense((d, h, dh + dr), d),
            "w_dkv": dense((d, dl), d),
            "w_kr": dense((d, dr), d),
            "kv_ln": {"scale": torch.ones((dl,), device=device)},
            "w_uk": dense((dl, h, dh), dl),
            "w_uv": dense((dl, h, dh), dl),
            "wo": dense((h, dh, d), h * dh),
        }
    elif spec.mixer == "rec":
        w = cfg.rnn_width
        p["rec"] = {
            "ln": _norm_params(cfg, d, device),
            "wx": dense((d, w), d),
            "wgate": dense((d, w), d),
            "conv_w": dense((cfg.conv_width, w), cfg.conv_width),
            "wr": dense((w, w), w),
            "wi": dense((w, w), w),
            "lam": torch.linspace(0.5, 4.0, w, device=device),
            "wout": dense((w, d), w),
        }
    else:
        s = cfg.ssm
        di, hh = s.d_inner, s.n_heads
        gn = 2 * s.n_groups * s.d_state
        p["ssd"] = {
            "ln": _norm_params(cfg, d, device),
            "wx": dense((d, di), d),
            "wz": dense((d, di), d),
            "wbc": dense((d, gn), d),
            "wdt": dense((d, hh), d),
            "dt_bias": zeros(hh),
            "a_log": torch.log(torch.linspace(1.0, 16.0, hh, device=device)),
            "d_skip": torch.ones((hh,), device=device),
            "conv_w": dense((s.conv_width, di + gn), s.conv_width),
            "gate_ln": {"scale": torch.ones((di,), device=device)},
            "wout": dense((di, d), di),
        }

    if spec.cross:
        h = cfg.n_heads
        p["cross"] = {
            "ln": _norm_params(cfg, d, device),
            "wq": dense((d, h, dh), d),
            "wk": dense((d, h, dh), d),
            "wv": dense((d, h, dh), d),
            "wo": dense((h, dh, d), h * dh),
        }

    if spec.ffn in ("dense", "gelu"):
        f = cfg.d_ff
        p["mlp"] = {
            "ln": _norm_params(cfg, d, device),
            "wi": dense((d, f), d),
            "wo": dense((f, d), f),
        }
        if spec.ffn == "dense":
            p["mlp"]["wg"] = dense((d, f), d)
    elif spec.ffn == "moe":
        m = cfg.moe
        e, f = m.n_experts, m.d_ff
        p["moe"] = {
            "ln": _norm_params(cfg, d, device),
            "router": dense((d, e), d),
            "wi": dense((e, d, f), d),
            "wg": dense((e, d, f), d),
            "wo": dense((e, f, d), f),
        }
        if m.n_shared:
            fs = m.n_shared * f
            p["moe"]["shared_wi"] = dense((d, fs), d)
            p["moe"]["shared_wg"] = dense((d, fs), d)
            p["moe"]["shared_wo"] = dense((fs, d), fs)
    return p


def init_params(cfg: ArchConfig, gen=None, device=None, place=None
                ) -> Dict:
    """The model's params on ``device`` (f32), drawn from the generator
    ``gen`` (None on the ``meta`` device, which only has shapes); an
    encoder-decoder's encoder is drawn after the decoder, as the JAX
    package draws it.

    ``place``, where given, takes each part as soon as it is drawn:
    ``place(path, tree)`` for a top-level leaf or norm, and ``place(path,
    block, u, n)`` for unit ``u`` of a block stacked over ``n`` units,
    which returns the stacked block at ``u == n - 1``.  ``path`` names
    the part as ``launch.sharding`` does (tuple entries ``"[i]"``).  A
    caller that shards the params (``launch.sharding.Placer``) so never
    holds more than one block in full; the values are the same."""
    if cfg.kind not in KINDS:
        raise _unsupported(f"kind {cfg.kind!r}")
    d, v = cfg.d_model, cfg.padded_vocab
    put = place or (lambda path, x: x)
    params: Dict[str, Any] = {
        "embed": put(("embed",), embed_init(gen, (v, d), device=device)),
        "final_norm": put(("final_norm",), _norm_params(cfg, d, device)),
    }
    if not cfg.tied_embeddings:
        params["head"] = put(("head",), dense_init(gen, (d, v), d,
                                                   device=device))

    def stacked(path, spec, n):
        """``n`` blocks drawn one after another into leaves stacked over
        the units (one block besides the stack is ever alive)."""
        if place is not None:
            for u in range(n):
                out = place(path, init_block(gen, cfg, spec, device), u, n)
            return out
        first = init_block(gen, cfg, spec, device)
        out = tree_map(lambda a: a.new_empty((n,) + a.shape), first)
        for u in range(n):
            block = first if u == 0 else init_block(gen, cfg, spec, device)
            tree_map(lambda o, a: o[u].copy_(a), out, block)
        return out

    def stage_params(name, stages):
        return tuple(tuple(stacked((name, f"[{i}]", f"[{j}]"), spec,
                                   st.n_units)
                           for j, spec in enumerate(st.unit))
                     for i, st in enumerate(stages))

    params["stages"] = stage_params("stages", cfg.stages)
    if cfg.kind == "encdec":
        params["enc_stages"] = stage_params("enc_stages", (_enc_stage(cfg),))
        params["enc_norm"] = put(("enc_norm",), _norm_params(cfg, d, device))
    return params


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameter count from the init shapes, computed on ``meta``;
    ``active_only`` leaves out the experts a token is not routed to."""
    shapes = init_params(cfg, device="meta")
    total = sum(math.prod(t.shape) for t in tree_leaves(shapes))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        n_moe = sum(st.n_units * sum(1 for sp in st.unit if sp.ffn == "moe")
                    for st in cfg.stages)
        total -= n_moe * 3 * cfg.d_model * m.d_ff * (m.n_experts - m.top_k)
    return total


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ArchConfig, spec: BlockSpec, batch: int,
                     length: int, enc_len: int = 0, dtype=torch.bfloat16,
                     device=None) -> Dict:
    """A block's decode cache, zero-filled: attention's k/v (a ring of
    the window's length where ``spec.window`` is set), MLA's compressed
    kv and rope key, the SSD or RG-LRU state and its conv tail (O(1) in
    ``length``), and cross-attention's k/v over ``enc_len`` frames."""
    _check_spec(spec)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    p: Dict[str, Any] = {}
    if spec.mixer == "gqa":
        lc = min(length, spec.window) if spec.window else length
        p["attn"] = attn_lib.init_kv_cache(
            batch, lc, cfg.n_kv_heads, cfg.head_dim, dtype, device)
    elif spec.mixer == "mla":
        p["attn"] = {"ckv": zeros(batch, length, cfg.kv_lora),
                     "kr": zeros(batch, length, cfg.rope_dim)}
    elif spec.mixer == "rec":
        w = cfg.rnn_width
        p["rec"] = {"h": zeros(batch, w),
                    "conv": zeros(batch, cfg.conv_width - 1, w)}
    else:
        s = cfg.ssm
        p["ssd"] = {
            "state": zeros(batch, s.n_heads, s.head_dim, s.d_state),
            "conv": zeros(batch, s.conv_width - 1,
                          s.d_inner + 2 * s.n_groups * s.d_state)}
    if spec.cross:
        p["cross"] = attn_lib.init_kv_cache(batch, enc_len, cfg.n_heads,
                                            cfg.head_dim, dtype, device)
    return p


def init_cache(cfg: ArchConfig, batch: int, length: int, enc_len: int = 0,
               dtype=torch.bfloat16, device=None):
    """Every block's zero cache, stacked over ``n_units`` per stage."""
    out = []
    for st in cfg.stages:
        out.append(tuple(
            tree_map(lambda a: a.new_zeros((st.n_units,) + a.shape),
                     init_block_cache(cfg, spec, batch, length, enc_len,
                                      dtype, device))
            for spec in st.unit))
    return tuple(out)


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

def _rope_dims(cfg: ArchConfig) -> int:
    rd = int(cfg.head_dim * cfg.rope_frac)
    return rd - rd % 2


def _pad_seq(a: torch.Tensor, target: int) -> torch.Tensor:
    """Pad dim 1 (sequence) with zeros up to ``target``."""
    if a.shape[1] >= target:
        return a
    return torch.cat([a, a.new_zeros((a.shape[0], target - a.shape[1])
                                     + a.shape[2:])], 1)


def _gqa_block(x, p, spec: BlockSpec, cfg: ArchConfig, mode: str, cache,
               pos, cache_len=None):
    h = _norm(x, p["ln"], cfg)
    q = attn_lib.project_heads(h, cast(p["wq"]))
    k = attn_lib.project_heads(h, cast(p["wk"]))
    v = attn_lib.project_heads(h, cast(p["wv"]))
    if "bq" in p:
        q = q + cast(p["bq"])
        k = k + cast(p["bk"])
        v = v + cast(p["bv"])
    rd = _rope_dims(cfg)
    if rd and spec.causal:
        if mode == "decode":
            positions = torch.full((1,), pos, device=x.device)
        else:
            positions = torch.arange(x.shape[1], device=x.device)
        cos, sin = rotary_cos_sin(positions, rd, cfg.rope_base)
        q = apply_rotary(q, cos, sin, rd)
        k = apply_rotary(k, cos, sin, rd)

    new_cache = None
    if mode == "decode":
        lc = cache["attn"]["k"].shape[1]
        ring = spec.window is not None and lc == spec.window
        c = attn_lib.cache_insert(cache["attn"], k, v,
                                  pos % lc if ring else pos)
        new_cache = {"attn": c}
        if ring:
            out = attn_lib.decode_attention_ring(q, c, pos, spec.window)
        else:
            out = attn_lib.attention(q, c["k"], c["v"], causal=True,
                                     window=spec.window, q_offset=pos,
                                     kv_len=pos + 1)
    else:
        out = attn_lib.attention(q, k, v, causal=spec.causal,
                                 window=spec.window)
        if mode == "prefill":
            s = x.shape[1]
            horizon = max(cache_len or s, s)
            lc = min(spec.window, horizon) if spec.window else horizon
            if s >= lc:                      # keep last lc, ring-aligned
                kk, vv = k[:, -lc:], v[:, -lc:]
                shift = s % lc
                if shift:
                    kk = torch.roll(kk, shift, 1)
                    vv = torch.roll(vv, shift, 1)
            else:                            # room for future decode steps
                kk, vv = _pad_seq(k, lc), _pad_seq(v, lc)
            new_cache = {"attn": {"k": kk, "v": vv}}
    return x + attn_lib.merge_heads(out, cast(p["wo"])), new_cache


def _mla_block(x, p, cfg: ArchConfig, mode: str, cache, pos,
               cache_len=None):
    """Multi-head latent attention: keys and values from a compressed kv
    (``kv_lora`` wide, the cache) and one rotary key shared by the heads
    (``rope_dim`` wide); rotary on the rope part only.  Decode writes the
    cache at ``pos`` and raises where the JAX package clamps
    (:func:`attention.update_slice`)."""
    h = _norm(x, p["ln"], cfg)
    dh, dr = cfg.head_dim, cfg.rope_dim
    q = torch.einsum("bsd,dhe->bshe", h, cast(p["wq"]))
    qn, qr = q[..., :dh], q[..., dh:]
    ckv = rms_norm(h @ cast(p["w_dkv"]), p["kv_ln"]["scale"])
    kr = h @ cast(p["w_kr"])

    if mode == "decode":
        positions = torch.full((1,), pos, device=x.device)
    else:
        positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = rotary_cos_sin(positions, dr, cfg.rope_base)
    qr = apply_rotary(qr, cos, sin)
    kr = apply_rotary(kr[:, :, None, :], cos, sin)[:, :, 0]

    new_cache = None
    kv_len = None
    if mode == "decode":
        c = {"ckv": attn_lib.update_slice(cache["attn"]["ckv"], ckv, pos),
             "kr": attn_lib.update_slice(cache["attn"]["kr"], kr, pos)}
        new_cache = {"attn": c}
        ckv, kr = c["ckv"], c["kr"]
        kv_len = pos + 1
    elif mode == "prefill":
        horizon = max(cache_len or x.shape[1], x.shape[1])
        new_cache = {"attn": {"ckv": _pad_seq(ckv, horizon),
                              "kr": _pad_seq(kr, horizon)}}

    w_uk, w_uv = cast(p["w_uk"]), cast(p["w_uv"])
    if mode == "decode":
        w_uk, w_uv = attn_lib.gather_for_split_keys(ckv, w_uk, w_uv)
    k_nope = torch.einsum("bsl,lhe->bshe", ckv, w_uk)
    val = torch.einsum("bsl,lhe->bshe", ckv, w_uv)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(
        k_nope.shape[:3] + (dr,))], -1)
    out = attn_lib.attention(torch.cat([qn, qr], -1), k, val, causal=True,
                             q_offset=pos if mode == "decode" else 0,
                             kv_len=kv_len)
    return x + torch.einsum("bshe,hed->bsd", out, cast(p["wo"])), new_cache


def _rec_block(x, p, cfg: ArchConfig, mode: str, cache):
    """The Griffin recurrent block: linear in, causal conv, RG-LRU, gated
    (GELU) linear out."""
    h = _norm(x, p["ln"], cfg)
    xb = h @ cast(p["wx"])
    gate = h @ cast(p["wgate"])
    conv_state = cache["rec"]["conv"] if mode == "decode" else None
    xc, conv_new = causal_conv1d(xb, p["conv_w"], conv_state)
    r = xc @ cast(p["wr"])
    i = xc @ cast(p["wi"])
    if mode == "decode":
        y, h_last = rg_lru_step(xc, r, i, p["lam"], cache["rec"]["h"])
    else:
        y, h_last = rg_lru(xc, r, i, p["lam"])
    out = (gelu(gate) * y) @ cast(p["wout"])
    new_cache = None
    if mode in ("prefill", "decode"):
        conv_dtype = (cache["rec"]["conv"].dtype if cache is not None
                      else CONV_TAIL_DTYPE)
        new_cache = {"rec": {"h": h_last, "conv": conv_new.to(conv_dtype)}}
    return x + out, new_cache


def _ssd_block(x, p, cfg: ArchConfig, mode: str, cache, pos, plain: bool):
    s = cfg.ssm
    bsz, seq = x.shape[:2]
    h = _norm(x, p["ln"], cfg)
    xs = h @ cast(p["wx"])
    z = h @ cast(p["wz"])
    bc = h @ cast(p["wbc"])
    dt = F.softplus((h @ cast(p["wdt"])).float()
                    + p["dt_bias"]).to(x.dtype)

    conv_in = torch.cat([xs, bc], -1)
    conv_state = cache["ssd"]["conv"] if mode == "decode" else None
    conv_out, conv_new = causal_conv1d(conv_in, p["conv_w"], conv_state)
    conv_out = silu(conv_out)
    di, gn = s.d_inner, s.n_groups * s.d_state
    xss = conv_out[..., :di].reshape(bsz, seq, s.n_heads, s.head_dim)
    b = conv_out[..., di:di + gn].reshape(bsz, seq, s.n_groups, s.d_state)
    c = conv_out[..., di + gn:].reshape(bsz, seq, s.n_groups, s.d_state)
    if mode == "decode":
        y, state = ssd_decode_step(xss, dt, p["a_log"], b, c, p["d_skip"],
                                   cache["ssd"]["state"])
    else:
        y, state = ssd_chunked(xss, dt, p["a_log"], b, c, p["d_skip"], s,
                               plain=plain)
    y = y.reshape(bsz, seq, di)
    y = rms_norm(y * silu(z), p["gate_ln"]["scale"])
    out = y @ cast(p["wout"])
    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"ssd": {"state": state,
                             "conv": conv_new.to(CONV_TAIL_DTYPE)}}
    return x + out, new_cache


def _cross_block(x, p, cfg: ArchConfig, mode: str, cache, enc_out):
    """Attention to the encoder's output; its k/v are computed at
    prefill and read from the cache in decode."""
    h = _norm(x, p["ln"], cfg)
    q = attn_lib.project_heads(h, cast(p["wq"]))
    if mode == "decode":
        k, v = cache["cross"]["k"], cache["cross"]["v"]
        new_cache = {"cross": cache["cross"]}
    else:
        k = attn_lib.project_heads(enc_out, cast(p["wk"]))
        v = attn_lib.project_heads(enc_out, cast(p["wv"]))
        new_cache = ({"cross": {"k": k, "v": v}} if mode == "prefill"
                     else None)
    out = attn_lib.attention(q, k, v, causal=False)
    return x + attn_lib.merge_heads(out, cast(p["wo"])), new_cache


def _ffn(x, p, kind: str, cfg: ArchConfig):
    h = _norm(x, p["ln"], cfg)
    if kind == "gelu":
        y = gelu(h @ cast(p["wi"]))
    else:
        y = silu(h @ cast(p["wg"])) * (h @ cast(p["wi"]))
    return x + y @ cast(p["wo"])


def apply_block(x, p, spec: BlockSpec, cfg: ArchConfig, *, mode: str,
                cache=None, pos=None, enc_out=None, cache_len=None,
                plain: bool = False, act_sharding=None):
    """One block; ``plain=True`` runs the kernels' plain versions (the
    oracle; only the ssd mixer has a kernel).  Returns (x, new cache or
    None).

    ``act_sharding`` re-places the residual stream after the mixer and
    after cross-attention, before the next norm reads it: their output
    projections leave a ``DTensor`` x a ``Partial`` sum over "model",
    and DTensor would carry that sum through the norm and gather the
    ffn's weights over "model" instead of reducing x once (each rank
    would then multiply the whole d_ff)."""
    _check_spec(spec)
    if spec.mixer == "gqa":
        x, nc = _gqa_block(x, p["attn"], spec, cfg, mode, cache, pos,
                           cache_len)
    elif spec.mixer == "mla":
        x, nc = _mla_block(x, p["attn"], cfg, mode, cache, pos, cache_len)
    elif spec.mixer == "rec":
        x, nc = _rec_block(x, p["rec"], cfg, mode, cache)
    else:
        x, nc = _ssd_block(x, p["ssd"], cfg, mode, cache, pos, plain)
    x = constrain(x, act_sharding)
    new_cache: Dict[str, Any] = dict(nc or {})
    if spec.cross:
        x, nc = _cross_block(x, p["cross"], cfg, mode, cache, enc_out)
        x = constrain(x, act_sharding)
        new_cache.update(nc or {})
    if spec.ffn == "moe":
        x = x + moe_ffn(_norm(x, p["moe"]["ln"], cfg), p["moe"], cfg.moe)
    elif spec.ffn != "none":
        x = _ffn(x, p["mlp"], spec.ffn, cfg)
    return x, (new_cache or None)


# ---------------------------------------------------------------------------
# Stage / model forward
# ---------------------------------------------------------------------------

def _units(stage_p, n: int) -> list:
    """The stage's per-unit params: views of the stacked leaves, cut by
    one ``unbind`` a leaf, whose backward stacks the units' gradients
    once (a select per unit would write a zero-filled stack per unit)."""
    cols = [a.unbind(0) for a in tree_leaves(stage_p)]

    def unit(u):
        it = iter(cols)
        return tree_map(lambda _: next(it)[u], stage_p)
    return [unit(u) for u in range(n)]


def run_stage(x, stage_p, stage: Stage, cfg: ArchConfig, *, mode: str,
              cache=None, pos=None, enc_out=None, cache_len=None,
              plain: bool = False, remat: bool = True, act_sharding=None):
    """The stage's units in order (``lax.scan`` in the JAX package):
    returns (x, caches stacked over ``n_units``, or None in train and
    encode).  In train mode with ``remat`` each unit runs under
    ``torch.utils.checkpoint`` (``jax.checkpoint`` in the JAX package):
    only the units' inputs are kept for the backward, which recomputes
    each unit's forward.  ``act_sharding`` re-places the (B, S, D)
    activations after every block (`launch.sharding.constrain`).

    Outside decode each unit's weights are gathered over the data axes
    at use (`launch.sharding.gather_fsdp`, the FSDP schedule); under
    remat the backward gathers them again and keeps no gathered copy.  A
    decode step's activations (one token a row) are far smaller than the
    weights, so there the weights stay split and the activations move."""
    fsdp = mode != "decode"

    def unit_fn(x, p_unit, c_unit):
        if fsdp:
            p_unit = gather_fsdp(p_unit)
        ncs = []
        for i, spec in enumerate(stage.unit):
            x, nc = apply_block(x, p_unit[i], spec, cfg, mode=mode,
                                cache=None if c_unit is None else c_unit[i],
                                pos=pos, enc_out=enc_out,
                                cache_len=cache_len, plain=plain,
                                act_sharding=act_sharding)
            x = constrain(x, act_sharding)
            ncs.append(nc)
        return x, tuple(ncs)

    new_caches = []
    for u, p_unit in enumerate(_units(stage_p, stage.n_units)):
        c_unit = None if cache is None else tree_map(lambda a: a[u], cache)
        if mode == "train" and remat:
            x, ncs = torch.utils.checkpoint.checkpoint(
                in_context(unit_fn), x, p_unit, c_unit, use_reentrant=False)
        else:
            x, ncs = unit_fn(x, p_unit, c_unit)
        new_caches.append(ncs)
    if mode in ("train", "encode"):
        return x, None
    return x, tree_map(lambda *a: torch.stack(a), *new_caches)


def _table(params, name: str, fsdp: bool):
    """The embedding or head, gathered over the data axes where
    ``fsdp`` (as :func:`run_stage` gathers a unit's weights)."""
    return gather_fsdp(params[name]) if fsdp else params[name]


def _embed(params, cfg, tokens, fsdp: bool):
    # gather, then cast: the same values as casting the whole table first
    return cast(_table(params, "embed", fsdp)[tokens.long()])


def _logits(params, cfg, x, fsdp: bool):
    x = _norm(x, params["final_norm"], cfg)
    if cfg.tied_embeddings:
        return x @ cast(_table(params, "embed", fsdp)).t()
    return x @ cast(_table(params, "head", fsdp))


def _run_encoder(params, cfg, enc_embeds):
    x = enc_embeds + cast(sinusoidal_positions(
        enc_embeds.shape[1], cfg.d_model, device=enc_embeds.device))[None]
    x, _ = run_stage(x, params["enc_stages"][0], _enc_stage(cfg), cfg,
                     mode="encode", remat=False)
    return _norm(x, params["enc_norm"], cfg)


def forward(params, cfg: ArchConfig, *, tokens, prefix_embeds=None,
            enc_embeds=None, mode: str = "train", cache=None, pos=None,
            cache_len=None, plain: bool = False, remat: bool = True,
            act_sharding=None):
    """Unified forward.

    train:   tokens (B,S) [+ prefix (B,P,D) or encoder (B,Se,D) embeds]
             -> logits (B,P+S,Vp)
    prefill: the same inputs -> (logits (B,1,Vp) of the last position,
             cache)
    decode:  tokens (B,1), cache, pos -> (logits (B,1,Vp), cache)

    ``prefix_embeds`` go before the tokens (not in decode); an
    encoder-decoder runs its encoder on ``enc_embeds`` (not in decode,
    where the cross k/v come from the cache) and adds sinusoidal
    positions to the decoder's input.  ``plain=True`` computes the
    prefill's SSD chunks with the kernel's plain version (the oracle the
    card's prefill is held to); no other block has a kernel.

    act_sharding: an optional ``launch.sharding.NamedSharding`` of the
    (B, S, D) activations, re-asserted after the embedding and at every
    block boundary (a ``redistribute`` of ``DTensor`` activations; plain
    tensors are left as they are).
    """
    enc_out = None
    if cfg.kind == "encdec" and mode != "decode":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder's {mode} "
                             f"needs enc_embeds")
        enc_out = _run_encoder(params, cfg, cast(enc_embeds))
    fsdp = mode != "decode"
    x = constrain(_embed(params, cfg, tokens, fsdp), act_sharding)
    if prefix_embeds is not None and mode != "decode":
        x = torch.cat([cast(prefix_embeds), x], 1)
    if cfg.kind == "encdec":
        if mode == "decode":
            posv = torch.full((1,), pos, device=x.device)
        else:
            posv = torch.arange(x.shape[1], device=x.device)
        x = x + cast(sinusoidal_at(posv, cfg.d_model))[None]

    new_caches = []
    for si, st in enumerate(cfg.stages):
        x, nc = run_stage(x, params["stages"][si], st, cfg, mode=mode,
                          cache=None if cache is None else cache[si],
                          pos=pos, enc_out=enc_out, cache_len=cache_len,
                          plain=plain, remat=remat,
                          act_sharding=act_sharding)
        new_caches.append(nc)
    if mode == "prefill":
        # only the last position's logits are consumed (next-token)
        return _logits(params, cfg, x[:, -1:], fsdp), tuple(new_caches)
    logits = _logits(params, cfg, x, fsdp)
    if mode == "train":
        return logits
    return logits, tuple(new_caches)
