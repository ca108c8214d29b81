"""Plain PyTorch oracles for every kernel (port of
``repro/kernels/ref.py``): the allclose targets.  Each is the plain
version kept beside its kernel, imported here, not copied again."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_ref
from .grouped_matmul import grouped_matmul_ref
from .im2win_conv import im2win_conv_plain as conv2d_ref
from .ssd_chunk import ssd_chunk_plain
from .tetris_matmul import matmul_ref

__all__ = ["matmul_ref", "grouped_matmul_ref", "conv2d_ref",
           "ssd_intra_chunk_ref", "flash_attention_ref"]


def ssd_intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor,
                        a_log: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD over one chunk (no inter-chunk state): x (B,L,H,P);
    dt (B,L,H); a_log (H,); b,c (B,L,H,N) or (B,L,G,N).
    y[i] = sum_{j<=i} C_i.B_j exp(dA(j,i]) x_j dt_j, in x's dtype."""
    return ssd_chunk_plain(x, dt, a_log, b, c, chunk=x.shape[1])[0]
