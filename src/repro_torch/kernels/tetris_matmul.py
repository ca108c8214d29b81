"""Tiled f32 matmul ``x (M, K) @ w (K, N)``: the ``matmul`` executor for
G = 1 (port of ``repro/kernels/tetris_matmul.py``).

On a TPU ``tetris_matmul`` runs ``_mm_kernel`` over the grid
``(⌈M/bm⌉, ⌈N/bn⌉, K/bk)`` with square-inclined blocks chosen under a
VMEM budget (``select_block_shape``, the paper's Alg 3 analogue) and
clamped, overlapping M/N edge blocks.  Here one hand-written CUDA kernel
(``csrc/matmul.cu``, entry ``tetris_matmul_f32``) picks its own tiles
and masks the ragged edges; the VMEM block rule is not ported (it waits
for the autotuner).

:func:`tetris_matmul` launches the kernel for CUDA tensors (counted in
``tetris_matmul_cuda.launches``) and takes :func:`matmul_ref`, the plain
version, only for CPU tensors.  The kernel reads each operand with its
row stride; an operand whose last dimension is not unit-stride is made
contiguous first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import cuda_operand, launch, ptr

SOURCE = "matmul.cu"


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x @ w`` in f32."""
    return torch.matmul(x.float(), w.float())


@functools.cache
def _library() -> ctypes.CDLL:
    """The built ``csrc/matmul.cu``, its C signatures declared (once)."""
    from . import _build
    lib = _build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tetris_matmul_f32.argtypes = [ptr] * 3 + [i32] * 3 + [i64] * 3 \
        + [ptr]
    lib.tetris_matmul_f32.restype = ctypes.c_int
    lib.grouped_matmul_f32.argtypes = [ptr] * 3 + [i32] * 4 + [i64] * 6 \
        + [ptr]
    lib.grouped_matmul_f32.restype = ctypes.c_int
    return lib


def tetris_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel (replaces ``_mm_kernel``): x (M, K) @ w (K, N)
    -> (M, N) f32 on the card.  Counts its launches in
    ``tetris_matmul_cuda.launches``."""
    x, w = cuda_operand(x, "x"), cuda_operand(w, "w")
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2 or x.device != w.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and w "
                         f"{tuple(w.shape)} on {w.device} do not multiply")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    launch(_library().tetris_matmul_f32, x.device, ptr(x), ptr(w), ptr(out),
           m, n, k, x.stride(0), w.stride(0), out.stride(0))
    tetris_matmul_cuda.launches += 1
    return out


tetris_matmul_cuda.launches = 0


def reset_counts() -> None:
    tetris_matmul_cuda.launches = 0


def tetris_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) f32.  CUDA tensors launch the
    kernel; CPU tensors take :func:`matmul_ref`."""
    if x.device.type == "cuda":
        return tetris_matmul_cuda(x, w)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    raise ValueError(f"tetris_matmul: unsupported device {x.device}")
