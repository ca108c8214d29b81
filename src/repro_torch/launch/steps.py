"""Prefill and serve step functions (port of the serving half of
``repro/launch/steps.py``).

prefill_step: forward over the full prompt -> (next token, cache).
serve_step: one decode token against the cache -> (next token, cache).

Both serve every config of the registry; a batch may carry
``prefix_embeds`` (a vision prefix) and ``enc_embeds`` (an
encoder-decoder's frames) beside ``tokens``.  ``loss_fn`` and
``make_train_step`` wait for the LM training loop (ROADMAP.md queue 1,
item 6).  The JAX package jits these steps; here they run eagerly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models import transformer as T
from ..models.config import ArchConfig


def vocab_mask(cfg: ArchConfig, device=None) -> torch.Tensor:
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab


def _model_inputs(cfg: ArchConfig, batch: Dict[str, Any]) -> Dict[str, Any]:
    kw = {"tokens": batch["tokens"]}
    if "prefix_embeds" in batch:
        kw["prefix_embeds"] = batch["prefix_embeds"]
    if "enc_embeds" in batch:
        kw["enc_embeds"] = batch["enc_embeds"]
    return kw


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
