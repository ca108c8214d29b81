"""Public wrappers for the kernels (port of ``repro/kernels/ops.py``).

The JAX package's wrappers jit the Pallas kernels and run them in
interpret mode on a CPU.  Here each wrapper calls its kernel's dispatcher:
CUDA tensors launch the hand-written kernel, CPU tensors take its plain
version.  The device comes from the inputs; there is no ``interpret``.
The TPU tile arguments (``block``, ``bm``, ``bf``) are refused: the CUDA
kernels pick their own tiles (the matmuls by
``tetris_matmul.gemm_launch_dims``).
``conv2d``'s ``window`` stays, because it sets the launch grid.

The dtype contract is the reference's: operands are f32 or bf16, all of
one dtype; sums are taken in f32 and the result comes back in the
operands' dtype.  Any other dtype, or mixed dtypes, raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention
from .grouped_matmul import grouped_matmul
from .im2win_conv import im2win_conv
from .tetris_matmul import tetris_matmul


def _no_tiles(**tiles) -> None:
    given = sorted(k for k, v in tiles.items() if v is not None)
    if given:
        raise ValueError(f"{given}: the CUDA kernels pick their own tiles "
                         f"(tetris_matmul.gemm_launch_dims)")


def matmul(x: torch.Tensor, w: torch.Tensor,
           block: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype (``tetris_matmul``)."""
    _no_tiles(block=block)
    return tetris_matmul(x, w)


def gmm(x: torch.Tensor, w: torch.Tensor, bm: Optional[int] = None,
        bf: Optional[int] = None) -> torch.Tensor:
    """x (G, M, D) @ w (G, D, F) -> (G, M, F) in x's dtype
    (``grouped_matmul``)."""
    _no_tiles(bm=bm, bf=bf)
    return grouped_matmul(x, w)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x (B, H, W, C) pre-padded, w (kh, kw, C, O), stride 1 VALID ->
    (B, o_h, o_w, O) in x's dtype (``im2win_conv``)."""
    return im2win_conv(x, w, window=window)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (BH, Sq, D); k/v (BH, Sk, D) -> (BH, Sq, D) in q's dtype
    (``flash_attention``)."""
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)
