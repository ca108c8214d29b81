"""Block-diagonal grouped matmul ``x (G, M, D) @ w (G, D, F) -> (G, M, F)``:
the ``matmul`` executor for G > 1 (port of
``repro/kernels/grouped_matmul.py``).

A dense layer computes x (M, G*D) @ W (G*D, G*F); grouping zeroes the
off-diagonal blocks, and the paper's cycle win (§III-B) is *not touching*
them.  On a TPU ``_gmm_kernel`` iterates only the G diagonal blocks over
the grid ``(G, ⌈M/bm⌉, ⌈F/bf⌉)`` with full-D contraction.  Here the
CUDA kernel of ``csrc/matmul.cu`` (entry ``grouped_matmul_f32``) does the
same with the group on ``blockIdx.z`` and per-group strides, so the
executor's group-major view of the weights is read in place, with the
block tile of ``tetris_matmul.gemm_launch_dims``.

:func:`grouped_matmul` launches it for CUDA tensors (counted in
``grouped_matmul_cuda.launches``, the blocks the C entry reports in
``.blocks``) and takes :func:`grouped_matmul_ref`, the plain version,
only for CPU tensors.
"""
from __future__ import annotations

import torch

from ._build import cuda_operand, no_backward, operand_dtype
from .tetris_matmul import _library, launch_gemm


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: ``einsum("gmd,gdf->gmf")`` in f32, returned in
    x's dtype."""
    return torch.einsum("gmd,gdf->gmf", x.float(), w.float()).to(x.dtype)


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel (replaces ``_gmm_kernel``): x (G, M, D) @
    w (G, D, F) -> (G, M, F) on the card, in x's dtype (bf16 operands
    are cast to f32 on the card for the f32 kernel, the result back to
    bf16).  Counts its launches in ``grouped_matmul_cuda.launches`` and
    the blocks they ran in ``.blocks``."""
    no_backward("grouped_matmul", x, w)
    x, w = cuda_operand(x, "x"), cuda_operand(w, "w")
    dtype = operand_dtype(x=x, w=w)
    x, w = x.float(), w.float()
    (g, m, d), (g2, d2, f) = x.shape, w.shape
    if (g, d) != (g2, d2) or x.device != w.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and w "
                         f"{tuple(w.shape)} on {w.device} do not multiply "
                         f"group by group")
    out = torch.empty((g, m, f), dtype=torch.float32, device=x.device)
    grouped_matmul_cuda.blocks += launch_gemm(
        _library().grouped_matmul_f32, x, w, out, g, m, f, g, m, f, d,
        x.stride(1), w.stride(1), out.stride(1), x.stride(0), w.stride(0),
        out.stride(0))
    grouped_matmul_cuda.launches += 1
    return out.to(dtype)


grouped_matmul_cuda.launches = 0
grouped_matmul_cuda.blocks = 0


def reset_counts() -> None:
    grouped_matmul_cuda.launches = 0
    grouped_matmul_cuda.blocks = 0


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (G, M, D) @ w (G, D, F) -> (G, M, F), diagonal blocks only, f32
    or bf16 (summed in f32) as x and w are.  CUDA tensors launch the
    kernel; CPU tensors take :func:`grouped_matmul_ref`.  No backward
    (:func:`_build.no_backward`)."""
    no_backward("grouped_matmul", x, w)
    operand_dtype(x=x, w=w)
    if x.device.type == "cuda":
        return grouped_matmul_cuda(x, w)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w)
    raise ValueError(f"grouped_matmul: unsupported device {x.device}")
