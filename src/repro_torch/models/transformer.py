"""Model assembly: param init, train/prefill/decode forward passes (port
of ``repro/models/transformer.py``).

Params keep the JAX package's pytree: ``embed``, ``final_norm`` and
``stages``, a tuple of stages, each a tuple (one entry per block of the
repeating unit) of dicts whose leaves are stacked over ``n_units``.  The
JAX package scans the units with ``lax.scan``; here :func:`run_stage` is a
Python loop over the stacked axis.  Caches mirror the same structure:
sliding-window attention keeps a ring buffer of the window's length.

The port runs the decoder attention family (``mixer="gqa"``: GQA, MQA,
MHA, sliding windows; ``ffn="dense"`` (SwiGLU) or ``"gelu"``) and the
``ssd`` family (Mamba-2: ``mixer="ssd"``, ``ffn="none"``).  The others
raise ``NotImplementedError`` naming their ROADMAP.md queue 1 item: MLA
and MoE (item 4), RG-LRU, cross-attention and the encoder-decoder
(item 5).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from . import attention as attn_lib
from .common import (apply_rotary, cast, dense_init, embed_init, gelu,
                     layer_norm, rms_norm, rotary_cos_sin, silu)
from .config import ArchConfig, BlockSpec, Stage
from .ssm import causal_conv1d, ssd_chunked, ssd_decode_step


def _unsupported(what: str, item: int):
    """``what`` waits for ROADMAP.md queue 1 ``item``."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item {item}): the "
        f"port runs mixer 'gqa' or 'ssd', ffn 'dense', 'gelu' or 'none', "
        f"decoders only")


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer == "mla":
        raise _unsupported("mixer 'mla'", 4)
    if spec.mixer == "rec":
        raise _unsupported("mixer 'rec'", 5)
    if spec.mixer not in ("gqa", "ssd"):
        raise NotImplementedError(f"mixer {spec.mixer!r} is not ported")
    if spec.ffn not in ("dense", "gelu", "none"):       # 'moe'
        raise _unsupported(f"ffn {spec.ffn!r}", 4)
    if spec.cross:
        raise _unsupported("cross-attention", 5)


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

    if spec.ffn in ("dense", "gelu"):
        f = cfg.d_ff
        p["mlp"] = {
            "ln": _norm_params(cfg, d, device),
            "wi": dense((d, f), d),
            "wo": dense((f, d), f),
        }
        if spec.ffn == "dense":
            p["mlp"]["wg"] = dense((d, f), d)
    return p


def init_params(cfg: ArchConfig, gen=None, device=None) -> Dict:
    """The model's params on ``device`` (f32), drawn from the generator
    ``gen`` (None on the ``meta`` device, which only has shapes)."""
    if cfg.kind != "decoder":
        raise _unsupported(f"kind {cfg.kind!r}", 5)
    d, v = cfg.d_model, cfg.padded_vocab
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (v, d), device=device),
        "final_norm": _norm_params(cfg, d, device),
    }
    if not cfg.tied_embeddings:
        params["head"] = dense_init(gen, (d, v), d, device=device)
    stages = []
    for st in cfg.stages:
        unit = []
        for spec in st.unit:
            blocks = [init_block(gen, cfg, spec, device)
                      for _ in range(st.n_units)]
            unit.append(tree_map(lambda *a: torch.stack(a), *blocks))
        stages.append(tuple(unit))
    params["stages"] = tuple(stages)
    return params


def count_params(cfg: ArchConfig) -> int:
    """Parameter count from the init shapes, computed on ``meta``."""
    shapes = init_params(cfg, device="meta")
    return sum(math.prod(t.shape) for t in tree_leaves(shapes))


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ArchConfig, spec: BlockSpec, batch: int,
                     length: int, dtype=torch.bfloat16,
                     device=None) -> Dict:
    """A block's decode cache, zero-filled: attention's k/v (a ring of
    the window's length where ``spec.window`` is set), or the SSD state
    and the conv tail (O(1) in ``length``)."""
    _check_spec(spec)
    if spec.mixer == "gqa":
        lc = min(length, spec.window) if spec.window else length
        return {"attn": attn_lib.init_kv_cache(
            batch, lc, cfg.n_kv_heads, cfg.head_dim, dtype, device)}
    s = cfg.ssm
    return {"ssd": {
        "state": torch.zeros((batch, s.n_heads, s.head_dim, s.d_state),
                             dtype=dtype, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1,
                             s.d_inner + 2 * s.n_groups * s.d_state),
                            dtype=dtype, device=device)}}


def init_cache(cfg: ArchConfig, batch: int, length: int,
               dtype=torch.bfloat16, device=None):
    """Every block's zero cache, stacked over ``n_units`` per stage."""
    out = []
    for st in cfg.stages:
        out.append(tuple(
            tree_map(lambda a: a.new_zeros((st.n_units,) + a.shape),
                     init_block_cache(cfg, spec, batch, length, dtype,
                                      device))
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
    q = torch.einsum("bsd,dhe->bshe", h, cast(p["wq"]))
    k = torch.einsum("bsd,dhe->bshe", h, cast(p["wk"]))
    v = torch.einsum("bsd,dhe->bshe", h, cast(p["wv"]))
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
    return x + torch.einsum("bshe,hed->bsd", out, cast(p["wo"])), new_cache


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
                             "conv": conv_new.to(torch.bfloat16)}}
    return x + out, new_cache


def _ffn(x, p, kind: str, cfg: ArchConfig):
    h = _norm(x, p["ln"], cfg)
    if kind == "gelu":
        y = gelu(h @ cast(p["wi"]))
    else:
        y = silu(h @ cast(p["wg"])) * (h @ cast(p["wi"]))
    return x + y @ cast(p["wo"])


def apply_block(x, p, spec: BlockSpec, cfg: ArchConfig, *, mode: str,
                cache=None, pos=None, cache_len=None, plain: bool = False):
    """One block; ``plain=True`` runs the kernels' plain versions (the
    oracle; only the ssd mixer has a kernel).  Returns (x, new cache or
    None)."""
    _check_spec(spec)
    if spec.mixer == "gqa":
        x, new_cache = _gqa_block(x, p["attn"], spec, cfg, mode, cache, pos,
                                  cache_len)
    else:
        x, new_cache = _ssd_block(x, p["ssd"], cfg, mode, cache, pos, plain)
    if spec.ffn != "none":
        x = _ffn(x, p["mlp"], spec.ffn, cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# Stage / model forward
# ---------------------------------------------------------------------------

def run_stage(x, stage_p, stage: Stage, cfg: ArchConfig, *, mode: str,
              cache=None, pos=None, cache_len=None, plain: bool = False):
    """The stage's units in order (``lax.scan`` in the JAX package):
    returns (x, caches stacked over ``n_units``, or None in train)."""
    new_caches = []
    for u in range(stage.n_units):
        p_unit = tree_map(lambda a: a[u], stage_p)
        c_unit = None if cache is None else tree_map(lambda a: a[u], cache)
        ncs = []
        for i, spec in enumerate(stage.unit):
            x, nc = apply_block(x, p_unit[i], spec, cfg, mode=mode,
                                cache=None if c_unit is None else c_unit[i],
                                pos=pos, cache_len=cache_len, plain=plain)
            ncs.append(nc)
        new_caches.append(tuple(ncs))
    if mode == "train":
        return x, None
    return x, tree_map(lambda *a: torch.stack(a), *new_caches)


def _embed(params, cfg, tokens):
    # gather, then cast: the same values as casting the whole table first
    return cast(params["embed"][tokens.long()])


def _logits(params, cfg, x):
    x = _norm(x, params["final_norm"], cfg)
    if cfg.tied_embeddings:
        return x @ cast(params["embed"]).t()
    return x @ cast(params["head"])


def forward(params, cfg: ArchConfig, *, tokens, mode: str = "train",
            cache=None, pos=None, cache_len=None, plain: bool = False):
    """Unified forward.

    train:   tokens (B,S) -> logits (B,S,Vp)
    prefill: tokens (B,S) -> (logits (B,1,Vp) of the last position, cache)
    decode:  tokens (B,1), cache, pos -> (logits (B,1,Vp), cache)

    ``plain=True`` computes the prefill's SSD chunks with the kernel's
    plain version (the oracle the card's prefill is held to); the
    attention family has no kernel, so it changes nothing there.
    """
    x = _embed(params, cfg, tokens)
    new_caches = []
    for si, st in enumerate(cfg.stages):
        x, nc = run_stage(x, params["stages"][si], st, cfg, mode=mode,
                          cache=None if cache is None else cache[si],
                          pos=pos, cache_len=cache_len, plain=plain)
        new_caches.append(nc)
    if mode == "prefill":
        # only the last position's logits are consumed (next-token)
        return _logits(params, cfg, x[:, -1:]), tuple(new_caches)
    logits = _logits(params, cfg, x)
    if mode == "train":
        return logits
    return logits, tuple(new_caches)
