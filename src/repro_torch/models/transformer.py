"""Model assembly: param init, train/prefill/decode forward passes (port
of ``repro/models/transformer.py``).

Params keep the JAX package's pytree: ``embed``, ``final_norm`` and
``stages``, a tuple of stages, each a tuple (one entry per block of the
repeating unit) of dicts whose leaves are stacked over ``n_units``.  The
JAX package scans the units with ``lax.scan``; here :func:`run_stage` is a
Python loop over the stacked axis.  Caches mirror the same structure.

The port runs the ``ssd`` family (Mamba-2: ``mixer="ssd"``,
``ffn="none"``).  Any other mixer or ffn raises ``NotImplementedError``:
attention, MLA, RG-LRU and MoE wait (ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from .common import cast, dense_init, embed_init, layer_norm, rms_norm
from .config import ArchConfig, BlockSpec, Stage
from .ssm import causal_conv1d, ssd_chunked, ssd_decode_step


def _unsupported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item 10): the port "
        f"runs mixer='ssd', ffn='none'")


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer != "ssd":
        raise _unsupported(f"mixer {spec.mixer!r}")
    if spec.ffn != "none":
        raise _unsupported(f"ffn {spec.ffn!r}")
    if spec.cross:
        raise _unsupported("cross-attention")


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
    order and distributions (the draws themselves differ)."""
    _check_spec(spec)
    d, s = cfg.d_model, cfg.ssm
    di, hh = s.d_inner, s.n_heads
    gn = 2 * s.n_groups * s.d_state

    def dense(shape, fan_in):
        return dense_init(gen, shape, fan_in, device=device)

    return {"ssd": {
        "ln": _norm_params(cfg, d, device),
        "wx": dense((d, di), d),
        "wz": dense((d, di), d),
        "wbc": dense((d, gn), d),
        "wdt": dense((d, hh), d),
        "dt_bias": torch.zeros((hh,), device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, hh, device=device)),
        "d_skip": torch.ones((hh,), device=device),
        "conv_w": dense((s.conv_width, di + gn), s.conv_width),
        "gate_ln": {"scale": torch.ones((di,), device=device)},
        "wout": dense((di, d), di),
    }}


def init_params(cfg: ArchConfig, gen=None, device=None) -> Dict:
    """The model's params on ``device`` (f32), drawn from the generator
    ``gen`` (None on the ``meta`` device, which only has shapes)."""
    if cfg.kind != "decoder":
        raise _unsupported(f"kind {cfg.kind!r}")
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
                     length: int, enc_len: int = 0,
                     dtype=torch.bfloat16, device=None) -> Dict:
    """A block's decode cache: the SSD state and the conv tail (O(1) in
    ``length``)."""
    _check_spec(spec)
    s = cfg.ssm
    return {"ssd": {
        "state": torch.zeros((batch, s.n_heads, s.head_dim, s.d_state),
                             dtype=dtype, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1,
                             s.d_inner + 2 * s.n_groups * s.d_state),
                            dtype=dtype, device=device)}}


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

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
    conv_out = F.silu(conv_out)
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
    y = rms_norm(y * F.silu(z), p["gate_ln"]["scale"])
    out = y @ cast(p["wout"])
    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"ssd": {"state": state,
                             "conv": conv_new.to(torch.bfloat16)}}
    return x + out, new_cache


def apply_block(x, p, spec: BlockSpec, cfg: ArchConfig, *, mode: str,
                cache=None, pos=None, cache_len=None, plain: bool = False):
    """One block; ``plain=True`` runs the kernels' plain versions (the
    oracle).  Returns (x, new cache or None)."""
    _check_spec(spec)
    return _ssd_block(x, p["ssd"], cfg, mode, cache, pos, plain)


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
    plain version (the oracle the card's prefill is held to).
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
