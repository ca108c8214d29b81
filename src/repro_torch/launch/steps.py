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


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, Any], *,
            remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy over the real (unpadded) vocabulary.  The
    batch carries S+1 tokens; the model sees the first S, logit t predicts
    token t+1; the positions of a vision prefix are cut off.

    The forward runs with ``plain=True``.  The JAX package's train
    forward is plain ``jnp`` and reaches no kernel, and ``ssd_chunk`` has
    a backward in neither package (its wrapper refuses autograd), so
    mamba2's SSD chunks are differentiated through their plain version
    here, on the card too; the prefill keeps the kernel."""
    inputs = {**batch, "tokens": batch["tokens"][:, :-1]}
    logits = T.forward(params, cfg, mode="train", plain=True, remat=remat,
                       **_model_inputs(cfg, inputs))
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    logits = logits.float().masked_fill(
        ~vocab_mask(cfg, logits.device), -1e30)
    logp = torch.log_softmax(logits, -1)
    labels = batch["tokens"][:, 1:].long()
    return -torch.gather(logp, -1, labels[..., None])[..., 0].mean()


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


def loss_and_grads(params, cfg: ArchConfig, batch: Dict[str, Any], *,
                   remat: bool = True):
    """(loss, gradients in ``params``' structure) of :func:`loss_fn`; a
    leaf the loss does not reach gets zeros, as ``jax.grad`` gives."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = loss_fn(tree_unflatten(params, live), cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])


def make_train_step(cfg: ArchConfig, tc: TrainConfig, *, remat: bool = True):
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
            loss, grads = loss_and_grads(params, cfg, mbs[0], remat=remat)
            losses = [loss]
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            losses = []
            for mb in mbs:
                loss, g = loss_and_grads(params, cfg, mb, remat=remat)
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
    """Argmax over the real (unpadded) vocabulary of (B, V) logits."""
    mask = vocab_mask(cfg, logits.device)
    return logits.float().masked_fill(~mask, -1e30).argmax(-1)


def make_prefill_step(cfg: ArchConfig, cache_len: Optional[int] = None):
    def prefill_step(params, batch: Dict[str, Any]):
        """batch["tokens"] (B, S) [+ "prefix_embeds", "enc_embeds"] ->
        (next token (B,), cache)."""
        logits, cache = T.forward(params, cfg, mode="prefill",
                                  cache_len=cache_len,
                                  **_model_inputs(cfg, batch))
        return _greedy(cfg, logits[:, -1]), cache
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, token, pos):
        """token (B, 1); pos — absolute decode position."""
        logits, new_cache = T.forward(params, cfg, mode="decode",
                                      tokens=token, cache=cache, pos=pos)
        return _greedy(cfg, logits[:, -1])[:, None], new_cache
    return serve_step
