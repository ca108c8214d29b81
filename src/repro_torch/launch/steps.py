"""Train, prefill and serve step functions (port of
``repro/launch/steps.py``).

train_step: gradient accumulation over microbatches, each unit of the
model recomputed in the backward; AdamW update; returns (state, metrics).
prefill_step: forward over the full prompt -> (next token, cache).
serve_step: one decode token against the cache -> (next token, cache).

All three take every config of the registry; a batch may carry
``prefix_embeds`` (a vision prefix) and ``enc_embeds`` (an
encoder-decoder's frames) beside ``tokens``.  The JAX package jits these
steps; here they run eagerly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..models import transformer as T
from ..models.config import ArchConfig
from ..optim import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                     tree_leaves, tree_unflatten)


def vocab_mask(cfg: ArchConfig, device=None) -> torch.Tensor:
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab


def _model_inputs(cfg: ArchConfig, batch: Dict[str, Any]) -> Dict[str, Any]:
    kw = {"tokens": batch["tokens"]}
    if "prefix_embeds" in batch:
        kw["prefix_embeds"] = batch["prefix_embeds"]
    if "enc_embeds" in batch:
        kw["enc_embeds"] = batch["enc_embeds"]
    return kw


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, Any],
            act_sharding=None, *, remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy over the real (unpadded) vocabulary.  The
    batch carries S+1 tokens; the model sees the first S, logit t predicts
    token t+1; the positions of a vision prefix are cut off.

    The forward runs with ``plain=True``.  The JAX package's train
    forward is plain ``jnp`` and reaches no kernel, and ``ssd_chunk`` has
    a backward in neither package (its wrapper refuses autograd), so
    mamba2's SSD chunks are differentiated through their plain version
    here, on the card too; the prefill keeps the kernel.  ``act_sharding``
    places the activations (``models.transformer.forward``)."""
    inputs = {**batch, "tokens": batch["tokens"][:, :-1]}
    logits = T.forward(params, cfg, mode="train", plain=True, remat=remat,
                       act_sharding=act_sharding,
                       **_model_inputs(cfg, inputs))
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    mask = vocab_mask(cfg, logits.device)
    labels = batch["tokens"][:, 1:]
    if _vocab_dims(logits):
        return _sharded_nll(logits, labels, mask).mean()
    logits = logits.float().masked_fill(~mask, -1e30)
    logp = torch.log_softmax(logits, -1)
    labels = labels.long()
    return -torch.gather(logp, -1, labels[..., None])[..., 0].mean()


def _vocab_dims(logits) -> list:
    """The mesh dims that split ``DTensor`` logits over their vocabulary
    (last) dim; none for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(logits, DTensor):
        return []
    return [i for i, p in enumerate(logits.placements)
            if p == Shard(logits.ndim - 1)]


def _sharded_nll(logits, labels, mask: torch.Tensor):
    """:func:`loss_fn`'s per-token negative log-likelihood of ``DTensor``
    (B, S, V) logits split over the vocabulary, on local shards (a
    vocab-parallel cross-entropy): each rank masks its slice of the
    padded vocabulary, and the row max, the sum of exponentials and the
    label's logit are all-reduced over the mesh dims that split the
    vocab; the result keeps the logits' batch and sequence splits.
    Gathering the logits would make each rank's backward multiply the
    whole vocabulary (the head's gradient) as every other rank does.
    The max has no gradient, as a log-softmax's shift has none."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from .sharding import from_local, local_part, move, partial_reducer
    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = [Replicate() if isinstance(p, Partial) else p
          for p in logits.placements]
    rows = [p if isinstance(p, Shard) and p.dim < last else Replicate()
            for p in pl]
    logits = move(logits, pl)
    _, off = local_part(logits.shape, mesh, pl)
    local = logits.to_local().float()
    n = local.shape[-1]
    local = local.masked_fill(~mask[off[last]:off[last] + n], -1e30)
    reduce = partial_reducer(mesh, _vocab_dims(logits))
    m = reduce(local.amax(-1, keepdim=True).detach(), "max")
    lse = m[..., 0] + torch.log(reduce(
        torch.exp(local - m).sum(-1, keepdim=True), "sum"))[..., 0]
    lab = move(labels, rows).to_local().long() - off[last]
    inside = (lab >= 0) & (lab < n)
    picked = local.gather(-1, lab.clamp(0, n - 1)[..., None])[..., 0]
    picked = reduce(picked * inside, "sum")
    return from_local(lse - picked, mesh, rows, labels.shape)


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    adamw: AdamWConfig = AdamWConfig()


def init_train_state(cfg: ArchConfig, gen: Optional[torch.Generator],
                     device=None) -> Dict[str, Any]:
    """Params drawn from ``gen`` on ``device`` and a zero AdamW state; on
    the ``meta`` device (``gen`` None) the shapes alone, the ``like`` of a
    restore."""
    params = T.init_params(cfg, gen, device)
    return {"params": params, "opt": adamw_init(params)}


def loss_and_grads(params, cfg: ArchConfig, batch: Dict[str, Any],
                   act_sharding=None, *, remat: bool = True):
    """(loss, gradients in ``params``' structure) of :func:`loss_fn`; a
    leaf the loss does not reach gets zeros, as ``jax.grad`` gives.  A
    ``DTensor`` gradient is placed as its parameter (and so as the Adam
    moments, ``launch.sharding.opt_shardings``): a replicated weight's
    gradient comes out of the backward as a partial sum over the ranks
    that split the batch, which is reduced here."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = loss_fn(tree_unflatten(params, live), cfg, batch, act_sharding,
                   remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [
        torch.zeros_like(p) if g is None else _placed_as(g, p)
        for p, g in zip(leaves, grads)])


def _placed_as(g, p):
    """``g`` redistributed to ``p``'s placements where both are
    ``DTensor``s that differ; else as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(g, DTensor) or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_train_step(cfg: ArchConfig, tc: TrainConfig, act_sharding=None, *,
                    remat: bool = True):
    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        """One optimizer step over ``tc.microbatches`` microbatches, each
        key of ``batch`` split along its batch dimension; the gradients
        accumulate in f32 as ``acc + g / n`` in microbatch order (one
        microbatch: its gradients as they are).  Returns (new state,
        {"loss": mean of the microbatch losses, "grad_norm", "lr"})."""
        params, opt = state["params"], state["opt"]
        n_mb = tc.microbatches
        if any(v.shape[0] % n_mb for v in batch.values()):
            raise ValueError(f"the batch does not split into {n_mb} "
                             f"microbatches")
        mbs = [{k: v.chunk(n_mb)[i] for k, v in batch.items()}
               for i in range(n_mb)]
        if n_mb == 1:
            loss, grads = loss_and_grads(params, cfg, mbs[0], act_sharding,
                                         remat=remat)
            losses = [loss]
        else:
            # zeros_like: a DTensor param's accumulator is sharded alike
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in tree_leaves(params)]
            losses = []
            for mb in mbs:
                loss, g = loss_and_grads(params, cfg, mb, act_sharding,
                                         remat=remat)
                for a, gg in zip(acc, tree_leaves(g)):
                    a.add_(gg.float() / n_mb)
                losses.append(loss)
                del g
            grads = tree_unflatten(params, acc)
        lr = cosine_schedule(opt["step"], peak_lr=tc.peak_lr,
                             warmup_steps=tc.warmup_steps,
                             total_steps=tc.total_steps)
        new_params, new_opt, gnorm = adamw_update(params, grads, opt, lr,
                                                  tc.adamw)
        metrics = {"loss": torch.stack(losses).mean(), "grad_norm": gnorm,
                   "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def _greedy(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the real (unpadded) vocabulary of (B, V) logits: the
    first index of the maximum, as ``jnp.argmax`` takes it.  ``DTensor``
    logits take :func:`_sharded_argmax`."""
    from torch.distributed.tensor import DTensor
    mask = vocab_mask(cfg, logits.device)
    if isinstance(logits, DTensor):
        return _sharded_argmax(logits, mask)
    return logits.float().masked_fill(~mask, -1e30).argmax(-1)


def _sharded_argmax(logits, mask: torch.Tensor):
    """:func:`_greedy` of ``DTensor`` logits, the batch split kept.  A
    partial sum is reduced onto a split of the batch where the batch
    divides (a reduce-scatter: a decode's logits come out whole in the
    batch and partial over "data"), else whole.  Each rank then takes
    the first maximum of its vocabulary slice, and the (value, index)
    pairs are gathered over the mesh dims that split the vocabulary, in
    its order: the first shard holding the maximum gives the first
    index, as over the whole row.  So no rank gathers the logits; and
    DTensor's own argmax over a split dim views each shard's best in a
    way that fails where the batch does not split (batch 1: every
    long_500k cell)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from .sharding import from_local, local_part, move
    mesh = logits.device_mesh
    sizes = mesh.shape
    split = math.prod(n for n, p in zip(sizes, logits.placements)
                      if p == Shard(0))
    pl = []
    for n, p in zip(sizes, logits.placements):
        if isinstance(p, Partial) and logits.shape[0] % (split * n) == 0:
            split *= n
            pl.append(Shard(0))
        else:
            pl.append(Replicate() if isinstance(p, Partial) else p)
    logits = move(logits, pl)
    _, off = local_part(logits.shape, mesh, pl)
    local = logits.to_local().float()
    n = local.shape[1]
    local = local.masked_fill(~mask[off[1]:off[1] + n], -1e30)
    idx = local.argmax(-1, keepdim=True)
    val = local.gather(-1, idx)
    rows = [p if p == Shard(0) else Replicate() for p in pl]
    shards = [Shard(1) if p == Shard(1) else r for p, r in zip(pl, rows)]
    k = logits.shape[1] // n
    val, idx = [from_local(t, mesh, shards, (logits.shape[0], k))
                .redistribute(mesh, rows).to_local()
                for t in (val, idx + off[1])]
    best = idx.gather(-1, val.argmax(-1, keepdim=True))[:, 0]
    return from_local(best, mesh, rows, logits.shape[:1])


def make_prefill_step(cfg: ArchConfig, cache_len: Optional[int] = None,
                      act_sharding=None):
    def prefill_step(params, batch: Dict[str, Any]):
        """batch["tokens"] (B, S) [+ "prefix_embeds", "enc_embeds"] ->
        (next token (B,), cache)."""
        logits, cache = T.forward(params, cfg, mode="prefill",
                                  cache_len=cache_len,
                                  act_sharding=act_sharding,
                                  **_model_inputs(cfg, batch))
        return _greedy(cfg, logits[:, -1]), cache
    return prefill_step


def make_serve_step(cfg: ArchConfig, act_sharding=None):
    def serve_step(params, cache, token, pos):
        """token (B, 1); pos — absolute decode position."""
        logits, new_cache = T.forward(params, cfg, mode="decode",
                                      tokens=token, cache=cache, pos=pos,
                                      act_sharding=act_sharding)
        return _greedy(cfg, logits[:, -1])[:, None], new_cache
    return serve_step
