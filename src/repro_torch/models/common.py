"""Shared model primitives (port of ``repro/models/common.py``): bf16
compute, the norms, and the weight initialisers over a
``torch.Generator``.

The JAX package's ``norm_policy`` (bf16 norm chains, set only by its
training launcher) is not ported: serving uses the default f32 norm."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * cast(scale)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * cast(scale) + cast(bias)


def dense_init(gen: Optional[torch.Generator], shape: Tuple[int, ...],
               fan_in: Optional[int] = None, device=None) -> torch.Tensor:
    """N(0, 1/fan_in) f32, drawn from ``gen`` on ``device`` (``gen`` may
    be None on the ``meta`` device, where nothing is drawn)."""
    fan_in = fan_in or shape[0]
    return (torch.randn(shape, generator=gen, device=device)
            * (1.0 / math.sqrt(fan_in)))


def embed_init(gen: Optional[torch.Generator], shape: Tuple[int, ...],
               device=None) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device) * 0.02


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab so the embedding shards cleanly over the model axis."""
    return ((v + multiple - 1) // multiple) * multiple
