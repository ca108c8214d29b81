"""Shared model primitives (port of ``repro/models/common.py``): bf16
compute, the norms, the activations, rotary and sinusoidal positions,
and the weight
initialisers over a ``torch.Generator`` (which takes the place of the
JAX package's ``keygen``), and ``norm_policy``.

``norm_policy(fast=True)`` (set by ``launch/shapes.py::build_cell`` for
optimized train cells) keeps :func:`rms_norm`'s elementwise chain in
bf16, accumulating the variance in f32 inside the reduction: no f32
copy of the (B, S, D) activations per norm.  The train loop and serving
keep the default f32 norm, as the JAX package's do."""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple

import torch

COMPUTE_DTYPE = torch.bfloat16

_FAST_NORM = contextvars.ContextVar("fast_norm", default=False)


@contextlib.contextmanager
def norm_policy(fast: bool):
    tok = _FAST_NORM.set(fast)
    try:
        yield
    finally:
        _FAST_NORM.reset(tok)


def in_context(fn):
    """``fn`` run in a copy of the caller's context variables: a function
    that ``torch.utils.checkpoint`` recomputes in the backward (which
    autograd may run on a thread of its own, where context variables
    hold their defaults) sees the policies of its forward."""
    ctx = contextvars.copy_context()
    return lambda *a, **k: ctx.run(fn, *a, **k)


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    if _FAST_NORM.get() and dt == torch.bfloat16:
        # the square rounded to bf16, summed in f32; rsqrt in f32 rounded
        # to bf16; both products in bf16, each rounded (as the JAX
        # package writes them)
        var = (x * x).mean(-1, keepdim=True, dtype=torch.float32)
        inv = torch.rsqrt(var + eps).to(dt)
        return x * inv * cast(scale)
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


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` rounded to x's dtype, as a JAX weak-typed scalar is."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` with its roundings: x * sigmoid(x), the sigmoid as
    XLA expands it, 1 / (1 + exp(-x)), each op rounded to x's dtype.
    (``F.silu`` rounds once: 37 % of its bf16 results differ by an ulp.)"""
    one = _const(x, 1.0)
    return x * (one / (one + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh form with its roundings: each op and
    each constant in x's dtype (``F.gelu`` rounds once)."""
    inner = _const(x, math.sqrt(2 / math.pi)) * (
        x + _const(x, 0.044715) * x ** 3)
    return x * (_const(x, 0.5) * (_const(x, 1.0) + torch.tanh(inner)))


def rotary_cos_sin(positions: torch.Tensor, dim: int,
                   base: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin (..., dim//2) in fp32."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 rot_dim: Optional[int] = None) -> torch.Tensor:
    """x: (..., seq, heads, dim); cos/sin: (..., seq, dim_rot//2).
    Rotates the first ``rot_dim`` features (partial rotary supported),
    rotate-half convention; cos/sin are cast to x's dtype first, as the
    JAX package casts them."""
    d = x.shape[-1] if rot_dim is None else rot_dim
    xr, xp = x[..., :d], x[..., d:]
    x1, x2 = xr.chunk(2, dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


def sinusoidal_at(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """positions (n,) -> (n, dim): sines then cosines, in fp32."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.float()[:, None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def sinusoidal_positions(n: int, dim: int, device=None) -> torch.Tensor:
    return sinusoidal_at(torch.arange(n, device=device), dim)


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
