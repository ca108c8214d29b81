"""RG-LRU recurrent mixer (port of ``repro/models/rglru.py``;
RecurrentGemma / Griffin, arXiv:2402.19427).

r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
log a_t = -c * softplus(Lambda) * r_t          (c = 8)
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train/prefill scan the sequence in log depth; decode is the O(1) update.
``jax.lax.associative_scan`` has no public torch counterpart, so
:func:`linear_scan` is a Hillis-Steele scan over the (a, b) pairs with the
reference's ``combine``: ceil(log2 S) steps of (B, S, W) ops.  It forms
the products in another order than XLA's scan, so its results agree with
the reference's to f32 rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

C_FACTOR = 8.0


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it: 1 / (1 + exp(-x))."""
    return 1.0 / (1.0 + torch.exp(-x))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|)), with no threshold (``F.softplus`` returns x above
    20)."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def _gates(x, r, i, lam) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, sqrt(1 - a^2) * sigmoid(i) * x) in f32, as the reference forms
    them."""
    f32 = torch.float32
    log_a = (-C_FACTOR * _softplus(lam.to(f32))) * _sigmoid(r.to(f32))
    a = torch.exp(log_a)
    gated = (_sigmoid(i.to(f32)) * x.to(f32)
             * torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-9)))
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 (h_{-1} = 0): the inclusive
    scan of ``combine((a1, b1), (a2, b2)) = (a1 * a2, b1 * a2 + b2)``,
    Hillis-Steele (each step combines every position with the one ``d``
    before it, d = 1, 2, 4, ...)."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], 1)
        if 2 * d < s:                 # the last step needs no new a
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1)
        d *= 2
    return b


def rg_lru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
           lam: torch.Tensor, h0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i: (B,S,W); lam (W,).  Returns (y (B,S,W), h_last (B,W))."""
    a, gated = _gates(x, r, i, lam)
    if h0 is not None:
        # fold the carried state into the first step
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0.float()[:, None],
                           gated[:, 1:]], 1)
    h = linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1].to(x.dtype)


def rg_lru_step(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                lam: torch.Tensor, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: x,r,i (B,1,W); h (B,W)."""
    a, gated = _gates(x[:, 0], r[:, 0], i[:, 0], lam)
    h_new = a * h.float() + gated
    return h_new.to(x.dtype)[:, None], h_new.to(x.dtype)
