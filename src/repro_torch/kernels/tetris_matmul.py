"""Tiled f32 matmul ``x (M, K) @ w (K, N)``: the ``matmul`` executor for
G = 1 (port of ``repro/kernels/tetris_matmul.py``).

On a TPU ``tetris_matmul`` runs ``_mm_kernel`` over the grid
``(⌈M/bm⌉, ⌈N/bn⌉, K/bk)`` with square-inclined blocks chosen under a
VMEM budget (``select_block_shape``, the paper's Alg 3 analogue) and
clamped, overlapping M/N edge blocks.  Here one hand-written CUDA kernel
(``csrc/matmul.cu``, entry ``tetris_matmul_f32``) masks the ragged
edges; the VMEM block rule is not ported.  Its block tile comes from
:func:`gemm_launch_dims`, the launch rule this module shares with
``grouped_matmul``: 128 x 128, or 128 x 64 where the smaller tile
leaves the busiest of the card's SMs less work.
:func:`vector_staging` says which of the kernel's two instances runs:
16-byte staging copies where every operand allows them, else 4-byte
ones.

:func:`tetris_matmul` launches the kernel for CUDA tensors (counted in
``tetris_matmul_cuda.launches``, the blocks the C entry reports in
``.blocks``) and takes :func:`matmul_ref`, the plain version, only for
CPU tensors.  The kernel reads each operand with its row stride; an
operand whose last dimension is not unit-stride is made contiguous
first.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from ._build import (address, cuda_operand, launch, no_backward,
                     operand_dtype, ptr)

SOURCE = "matmul.cu"

#: the block tiles compiled in csrc/matmul.cu: BM rows by one of BNS
#: columns
BM, BNS = 128, (128, 64)


class GemmLaunch(NamedTuple):
    """How the kernel lays out one launch."""

    bm: int                      # output rows per block
    bn: int                      # output columns per block
    grid: Tuple[int, int, int]   # (⌈n/bn⌉, ⌈m/bm⌉, groups)
    blocks: int                  # blocks of the launch


def gemm_launch_dims(groups: int, m: int, n: int, sms: int) -> GemmLaunch:
    """The block tile of a (groups, m, n) output that gives the busiest of
    the card's ``sms`` SMs the least work.  The blocks are spread over the
    SMs, so the busiest runs ⌈blocks / sms⌉ of them, and one block of 8
    warps keeps an SM's FMA pipes nearly full, so a second resident block
    overlaps the first but adds no rate: the busiest SM's time is that
    count times one block's work, twice as much at 128 x 128 as at
    128 x 64.  On a tie the larger tile, which loads less from shared
    memory per FMA."""
    best = None
    for bn in BNS:
        grid = (math.ceil(n / bn), math.ceil(m / BM), groups)
        blocks = math.prod(grid)
        cost = math.ceil(blocks / sms) * bn
        if best is None or cost < best[0]:
            best = (cost, GemmLaunch(BM, bn, grid, blocks))
    return best[1]


def sm_count(device: torch.device) -> int:
    """The SMs of the card that ``device`` names."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def vector_staging(*operands: torch.Tensor) -> bool:
    """Whether the kernel may stage with 16-byte copies: every operand's
    base is 16-byte aligned and every stride but the last (1) a multiple
    of 4 floats."""
    bases = [address(t, f"vector_staging operand {i}")
             for i, t in enumerate(operands)]
    return all(a % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:-1])
               for a, t in zip(bases, operands))


def launch_gemm(entry, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                groups: int, m: int, n: int, *args) -> int:
    """Launch ``entry`` (a C entry of csrc/matmul.cu) on x, w, out and
    ``args`` with the tile of :func:`gemm_launch_dims` and the instance of
    :func:`vector_staging`; returns the blocks the C entry launched."""
    d = gemm_launch_dims(groups, m, n, sm_count(x.device))
    blocks = ctypes.c_int(0)
    launch(entry, x.device, ptr(x, "x"), ptr(w, "w"), ptr(out, "out"),
           *args, d.bn, int(vector_staging(x, w, out)), ctypes.byref(blocks))
    return blocks.value


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x @ w`` in f32, returned in x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built ``csrc/matmul.cu``, its C signatures declared (once)."""
    from . import _build
    return declare(_build.load(SOURCE))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/matmul.cu``) with its entries' C
    signatures declared."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    blocks = ctypes.POINTER(ctypes.c_int)
    lib.tetris_matmul_f32.argtypes = [ptr] * 3 + [i32] * 3 + [i64] * 3 \
        + [i32, i32, blocks, ptr]
    lib.tetris_matmul_f32.restype = ctypes.c_int
    lib.grouped_matmul_f32.argtypes = [ptr] * 3 + [i32] * 4 + [i64] * 6 \
        + [i32, i32, blocks, ptr]
    lib.grouped_matmul_f32.restype = ctypes.c_int
    return lib


def tetris_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel (replaces ``_mm_kernel``): x (M, K) @ w (K, N)
    -> (M, N) on the card, in x's dtype.  The kernel is f32: bf16
    operands are cast to f32 on the card first and the result back to
    bf16.  Counts its launches in ``tetris_matmul_cuda.launches`` and the
    blocks they ran in ``.blocks``."""
    no_backward("tetris_matmul", x, w)
    x, w = cuda_operand(x, "x"), cuda_operand(w, "w")
    dtype = operand_dtype(x=x, w=w)
    x, w = x.float(), w.float()
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2 or x.device != w.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and w "
                         f"{tuple(w.shape)} on {w.device} do not multiply")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    tetris_matmul_cuda.blocks += launch_gemm(
        _library().tetris_matmul_f32, x, w, out, 1, m, n, m, n, k,
        x.stride(0), w.stride(0), out.stride(0))
    tetris_matmul_cuda.launches += 1
    return out.to(dtype)


tetris_matmul_cuda.launches = 0
tetris_matmul_cuda.blocks = 0


def reset_counts() -> None:
    tetris_matmul_cuda.launches = 0
    tetris_matmul_cuda.blocks = 0


def tetris_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N), f32 or bf16 (summed in f32) as x
    and w are.  CUDA tensors launch the kernel; CPU tensors take
    :func:`matmul_ref`.  No backward (:func:`_build.no_backward`)."""
    no_backward("tetris_matmul", x, w)
    operand_dtype(x=x, w=w)
    if x.device.type == "cuda":
        return tetris_matmul_cuda(x, w)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    raise ValueError(f"tetris_matmul: unsupported device {x.device}")
