"""Int8 error-feedback gradient compression for slow links (port of
``repro/optim/compression.py``).

Per-tensor symmetric int8 quantisation with an error-feedback residual:
the quantisation error of step t is added back to the gradient of step
t+1, which keeps SGD/Adam convergence (Karimireddy et al., 2019).  The
arithmetic is the JAX package's, op for op in f32, and ``torch.round``
rounds half to even as ``jnp.round`` does, so both packages give the same
bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .adamw import tree_leaves, tree_unflatten


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale) with ``x ~= q * scale``."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_update(grad: torch.Tensor, residual: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad, residual) -> (q, scale, new_residual).  The caller reduces q
    across the slow axis, decompresses, and carries new_residual."""
    corrected = grad.float() + residual
    q, scale = compress_int8(corrected)
    new_residual = corrected - decompress_int8(q, scale)
    return q, scale, new_residual


def compress_pytree(grads, residuals):
    """:func:`ef_compress_update` over same-structured trees: (qs, scales,
    new residuals), each in ``grads``' structure."""
    out = [ef_compress_update(g, r) for g, r in
           zip(tree_leaves(grads), tree_leaves(residuals))]
    return tuple(tree_unflatten(grads, [o[i] for o in out])
                 for i in range(3))
