"""Mixture-of-Experts (port of ``repro/models/moe.py``): token-choice
top-k routing with capacity, GShard one-hot dispatch einsums, computed
in sequence chunks.

Chunking keeps the dispatch and combine tensors O(B * chunk * E *
capacity) instead of O(B * S * E * capacity), so MoE activation memory
stays flat in S.  Expert weights are (E, D, F) / (E, F, D).

The JAX package's chunk ``lax.scan`` is a Python loop here, and its
``jax.checkpoint`` (which changes nothing in a forward) is left out.  The
weights are cast to the compute type once per call rather than once per
chunk: the same values.

Under an optimized train cell's policy mesh (``attention.policy_mesh()``)
the expert weights and the router are gathered at use before the chunks
run — the FSDP schedule: the expert weights keep only their d_ff split
over 'model' (where it divides), the router is replicated.  On
``DTensor`` weights that is a ``redistribute``; plain weights (one
device) are left as they are.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from ..launch.mesh import axis_sizes
from ..launch.sharding import (NamedSharding, P, from_local,
                               local_part, move)
from .attention import policy_mesh
from .common import cast, silu


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    n_shared: int = 0            # shared (always-on) experts, dsv2-style
    capacity_factor: float = 1.25
    chunk: int = 512


def capacity(cfg: MoEConfig, chunk_len: int) -> int:
    return max(1, math.ceil(chunk_len * cfg.top_k * cfg.capacity_factor
                            / cfg.n_experts))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, and on equal
    values the lower index first (a stable descending sort; ``torch.topk``
    promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, cfg: MoEConfig, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, T, E) -> dispatch (B,T,E,cap) one-hot, combine (same,
    prob-weighted), both f32.  Top-k per token; an assignment whose rank
    at its expert is ``cap`` or more is dropped (an all-zero slot row, as
    ``jax.nn.one_hot`` gives out of range)."""
    b, t, e = logits.shape
    k = cfg.top_k
    probs = torch.softmax(logits.float(), -1)
    top_p, top_i = top_k(probs, k)                           # (B,T,K)
    top_p = top_p / top_p.sum(-1, keepdim=True)              # renormalise

    experts = torch.arange(e, device=logits.device)
    onehot = (top_i[..., None] == experts).float()           # (B,T,K,E)
    flat = onehot.reshape(b, t * k, e)
    ranks = (torch.cumsum(flat, 1) - flat).reshape(b, t, k, e)
    keep = (ranks < cap) * onehot
    rank = (ranks * onehot).sum(-1)                          # (B,T,K)
    slots = torch.arange(cap, device=logits.device)
    slot = (rank[..., None] == slots).float()                # (B,T,K,cap)
    disp = torch.einsum("btke,btkc->btec", keep, slot)
    comb = torch.einsum("btke,btkc,btk->btec", keep, slot, top_p)
    return disp, comb


def expert_ffn(xe: torch.Tensor, wi, wg, wo) -> torch.Tensor:
    """xe (B,E,cap,D); weights (E,D,F)/(E,F,D) -> (B,E,cap,D).  The last
    product's operands are made contiguous (no copy where they are): on
    ``DTensor``s its einsum otherwise views a non-contiguous local shard
    and fails (mixtral-8x7b's prefill_32k on the 16x16 pod)."""
    h = torch.einsum("becd,edf->becf", xe, cast(wi))
    g = torch.einsum("becd,edf->becf", xe, cast(wg))
    return torch.einsum("becf,efd->becd", (silu(g) * h).contiguous(),
                        cast(wo).contiguous())


def _experts(x, router, wi, wg, wo, cfg: MoEConfig, chunk: int,
             cap: int, e0: int = 0) -> torch.Tensor:
    """The routed experts of (B,S,D) x, chunk by chunk: route each chunk
    over all the router's experts, run the experts ``e0 .. e0 + E`` of
    ``wi``/``wg``/``wo`` (all of them by default) and combine.  With a
    slice of the experts or of d_ff the result is that slice's part of
    the sum."""
    ys = []
    n_e = wi.shape[0]
    for c in range(x.shape[1] // chunk):
        xc = x[:, c * chunk:(c + 1) * chunk]
        disp, comb = route(xc @ router, cfg, cap)
        if n_e != disp.shape[2]:
            disp, comb = disp[:, :, e0:e0 + n_e], comb[:, :, e0:e0 + n_e]
        xe = torch.einsum("btec,btd->becd", disp.to(xc.dtype), xc)
        ye = expert_ffn(xe, wi, wg, wo)
        ys.append(torch.einsum("btec,becd->btd", comb.to(xc.dtype), ye))
    return torch.cat(ys, 1) if len(ys) > 1 else ys[0]


def _local_experts(x, router, wi, wg, wo, cfg: MoEConfig, chunk: int,
                   cap: int):
    """:func:`_experts` on ``DTensor`` operands, run on each shard's
    local tensors (the ``attention._local_attend`` treatment).  Per mesh
    dim: where x is split on its batch it keeps that split and the
    weights are gathered (routing, whose ranks are a cumsum along each
    batch row, sees whole rows: exact); elsewhere x is whole, and the
    experts keep a split of the experts (EP) or of d_ff where the dim
    divides it, each rank routing every token, running its slice and
    adding a ``Partial`` part of the output; any other split is
    gathered.  The capacity is never split.  DTensor's own einsums split
    the capacity unevenly over a "model" axis that does not divide it
    (60 slots on 16 ranks) and then cannot flatten it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    n_e, f = wi.shape[0], wi.shape[2]
    rep, part = Replicate(), Partial()
    # per mesh dim: the placements of x, wi/wg, wo, the router and the
    # output, then the gradients' of x, wi/wg, wo and the router (a
    # whole operand against a split partner gets a partial gradient)
    plan = []
    for i, size in enumerate(mesh.shape):
        px, pw, po = x.placements[i], wi.placements[i], wo.placements[i]
        if size > 1 and isinstance(px, Shard) and px.dim == 0:
            plan.append((px, rep, rep, px, px, part, part, part))
        elif size > 1 and pw == po == Shard(0) and n_e % size == 0:
            plan.append((rep, pw, po, part, part, pw, po, part))
        elif size > 1 and pw == Shard(2) and po == Shard(1) and \
                f % size == 0:
            plan.append((rep, pw, po, part, part, pw, po, part))
        else:
            plan.append((rep,) * 8)
    p_x, p_w, p_wo, p_out, g_x, g_w, g_wo, g_r = (list(c)
                                                  for c in zip(*plan))
    x, router = move(x, p_x), move(router, [rep] * mesh.ndim)
    wi, wg, wo = move(wi, p_w), move(wg, p_w), move(wo, p_wo)
    _, offset = local_part(wi.shape, mesh, p_w)
    y = _experts(x.to_local(grad_placements=g_x),
                 router.to_local(grad_placements=g_r),
                 wi.to_local(grad_placements=g_w),
                 wg.to_local(grad_placements=g_w),
                 wo.to_local(grad_placements=g_wo), cfg, chunk, cap,
                 e0=offset[0])
    return from_local(y.contiguous(), mesh, p_out, x.shape)


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D).  params: router (D,E), wi/wg (E,D,F),
    wo (E,F,D), optional shared_{wi,wg,wo} ((D,Fs)/(Fs,D))."""
    b, s, d = x.shape
    chunk = min(cfg.chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by moe chunk {chunk}")
    cap = capacity(cfg, chunk)
    router = cast(params["router"])
    wi, wg, wo = (cast(params[n]) for n in ("wi", "wg", "wo"))
    mesh = policy_mesh()
    if mesh is not None:        # FSDP gather-at-use (module docstring)
        mdl = ("model" if wi.shape[-1] % axis_sizes(mesh)["model"] == 0
               else None)

        def gather(w, *spec):
            # after the FSDP gather at use only the "model" split moves
            from torch.distributed.tensor import DTensor
            if not isinstance(w, DTensor):
                return w
            return move(w, NamedSharding(mesh, P(*spec)).placements)
        wi, wg = gather(wi, None, None, mdl), gather(wg, None, None, mdl)
        wo = gather(wo, None, mdl, None)
        router = gather(router, None, None)

    from torch.distributed.tensor import DTensor, Shard
    if isinstance(x, DTensor) and Shard(1) not in wi.placements and \
            Shard(2) not in wo.placements:
        y = _local_experts(x, router, wi, wg, wo, cfg, chunk, cap)
    else:
        # plain tensors; or a decode's DTensors, whose weights keep their
        # split over "data" on d_model (no FSDP gather): DTensor's own
        # einsums move the one-token activations, where the local
        # experts would gather every expert's weights each token
        y = _experts(x, router, wi, wg, wo, cfg, chunk, cap)

    if cfg.n_shared:
        h = x @ cast(params["shared_wi"])
        g = x @ cast(params["shared_wg"])
        y = y + (silu(g) * h) @ cast(params["shared_wo"])
    return y
