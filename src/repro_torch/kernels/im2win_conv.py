"""Mapping-free im2win convolution: the kernel behind
:func:`repro_torch.kernels.ops.conv2d` (port of the ``im2win_conv`` half
of ``repro/kernels/im2win_conv.py``; the mapping-driven half is
:mod:`repro_torch.kernels.sdk_conv`).

A stride-1 VALID convolution of a pre-padded NHWC input ``x (B, H, W,
C)`` with HWIO weights ``w (kh, kw, C, O)``.  The parallel window is a
``(th, tw)`` tile of outputs picked by the square-inclined rule
(:func:`select_window`, the paper's Alg 3 under the TPU's VMEM budget,
kept so both packages pick the same window); one grid step computes one
window against the whole kernel, border windows clamped, so the grid
size is :func:`n_cycles`.

The CUDA kernel of ``csrc/im2win_conv.cu`` runs each grid step as one
thread-block cluster: :func:`cluster_split` cuts the step's product
(``th*tw`` positions x ``O`` channels) into ``cluster`` blocks, each
staging the window patch and its weight columns in shared memory.  A
launch therefore has ``n_cycles`` clusters and ``n_cycles * cluster``
blocks.

:func:`im2win_conv` launches it for CUDA tensors (counted in
``im2win_conv_cuda.launches``, its grid steps in ``.steps`` and the
blocks the C entry reports it launched in ``.blocks``) and takes :func:`im2win_conv_plain`, ``F.conv2d``
on NCHW views, only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.tetris import factor_pairs_square_first
from ._build import (cuda_operand, launch, no_backward, operand_dtype,
                     ptr)
from .window_product import SMEM_LIMIT, k_groups, round4, smem_bytes

SOURCE = "im2win_conv.cu"

#: The largest cluster cluster_split forms.  8 is the largest portable
#: size, and on an H100 the largest of which the card holds more than 8
#: at once (15; of 9-16 blocks it holds 7, so the 8 steps of a paper
#: layer would take two waves).
MAX_CLUSTER = 8
#: A block's part keeps at least this many output channels (four channel
#: groups of a thread tile) and positions (two row groups).
_MIN_OC, _MIN_POS = 16, 16


def select_window(o_h: int, o_w: int, k: int, c: int, oc: int,
                  vmem_budget: int = 4 * 1024 * 1024,
                  dtype_bytes: int = 4) -> Tuple[int, int]:
    """Square-inclined (th, tw) output tile per window (Alg 3 on TPU)."""
    best = (min(o_h, 8), min(o_w, 8))
    for target in (4096, 1024, 256, 64, 16, 4):
        for a, b in factor_pairs_square_first(target):
            th, tw = min(a, o_h), min(b, o_w)
            patch = (th + k - 1) * (tw + k - 1) * c
            ws = (patch + th * tw * oc) * dtype_bytes + k * k * c * oc \
                * dtype_bytes
            if ws <= vmem_budget:
                return th, tw
    return best


def n_cycles(o_h: int, o_w: int, th: int, tw: int, batch: int = 1) -> int:
    """Grid steps == the mapping's computing-cycle count (ceil form)."""
    return batch * math.ceil(o_h / th) * math.ceil(o_w / tw)


def conv_window(x_shape, w_shape, window: Optional[Tuple[int, int]] = None
                ) -> Tuple[int, int, int, int]:
    """(o_h, o_w, th, tw) of a launch: the caller's window or
    :func:`select_window`'s, cut to the output."""
    _, h, w_, c = x_shape
    k_h, k_w, c2, oc = w_shape
    if c != c2:
        raise ValueError(f"x has {c} channels, w expects {c2}")
    o_h, o_w = h - k_h + 1, w_ - k_w + 1
    if o_h < 1 or o_w < 1:
        raise ValueError(f"kernel {k_h}x{k_w} larger than the input {h}x{w_}")
    th, tw = window or select_window(o_h, o_w, max(k_h, k_w), c, oc)
    return o_h, o_w, min(th, o_h), min(tw, o_w)


def im2win_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.conv2d`` on NCHW / OIHW views in f32,
    returned in x's dtype."""
    conv_window(x.shape, w.shape)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).to(x.dtype)


class BlockTile(NamedTuple):
    """One block's part of a grid step's product and how it stages it."""

    pos: int      # window positions (of th*tw) the block computes
    oc: int       # output channels the block computes, a multiple of 4
    co: int       # channel parts of the cluster (the rest split positions)
    cs: int       # input channels staged at a time
    ks: int       # thread groups splitting the K sum (1: none)
    smem: int     # bytes of shared memory a block uses


def _parts(n: int, want: int, unit: int = 1) -> Tuple[int, int]:
    """(parts, width): the most parts, at most ``want``, into which ``n``
    cuts with widths a multiple of ``unit`` and no part empty."""
    for parts in range(max(1, want), 0, -1):
        width = -(-math.ceil(n / parts) // unit) * unit
        if math.ceil(n / width) == parts:
            return parts, width
    return 1, -(-n // unit) * unit


def cluster_split(th: int, tw: int, oc: int, c: int, kh: int,
                  kw: int) -> Tuple[int, BlockTile]:
    """(cluster, per-block tile) of one grid step: how many blocks share a
    window and which part of its ``th*tw x oc`` product each computes.

    The cluster is ``co`` channel parts (each at least 16 channels wide,
    a multiple of 4) times ``cp`` position parts (each at least 16
    positions), as large as :data:`MAX_CLUSTER` allows, and among equal sizes
    the one with the most channel parts: a block then stages the fewest
    weights.  Block ``rank`` computes positions ``[pi*pos, (pi+1)*pos)`` x
    channels ``[oi*oc_b, (oi+1)*oc_b)`` with ``(pi, oi) = divmod(rank,
    co)``, cut to the window; no part is empty.  ``cs`` is all of ``c``
    when the patch and the weight columns fit shared memory, else the
    fewest equal slices of ``c`` (each a multiple of 4) that fit."""
    npos = th * tw
    best = None
    for want_co in range(1, max(1, min(MAX_CLUSTER, oc // _MIN_OC)) + 1):
        co, oc_b = _parts(oc, want_co, 4)
        cp, pos = _parts(npos, min(MAX_CLUSTER // co, npos // _MIN_POS))
        key = (cp * co, co)
        if best is None or key > best[0]:
            best = (key, co, oc_b, cp, pos)
    _, co, oc_b, cp, pos = best
    n_pix = (th + kh - 1) * (tw + kw - 1)
    for n in range(1, math.ceil(c / 4) + 1):
        cs = c if n == 1 else round4(math.ceil(c / n))
        ks = k_groups(pos, oc_b, kh * kw * round4(cs) // 4)
        smem = smem_bytes(n_pix, kh * kw, cs, pos, oc_b, ks)
        if smem <= SMEM_LIMIT:
            return cp * co, BlockTile(pos, oc_b, co, cs, ks, smem)
    raise ValueError(f"window ({th},{tw}) with a {kh}x{kw} kernel: even 4 "
                     f"staged channels exceed {SMEM_LIMIT} bytes of shared "
                     f"memory")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built ``csrc/im2win_conv.cu``, its C signature declared."""
    from . import _build
    lib = _build.load(SOURCE)
    lib.im2win_conv_f32.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 15 + [ctypes.POINTER(ctypes.c_int),
                                 ctypes.c_void_p]
    lib.im2win_conv_f32.restype = ctypes.c_int
    return lib


def _plan(x_shape, w_shape, window):
    """The launch's shape arguments, grid steps and cluster size."""
    o_h, o_w, th, tw = conv_window(x_shape, w_shape, window)
    b, h, w_, c = x_shape
    k_h, k_w, _, oc = w_shape
    cluster, tile = cluster_split(th, tw, oc, c, k_h, k_w)
    args = (b, h, w_, c, k_h, k_w, oc, th, tw, cluster, tile.co, tile.pos,
            tile.oc, tile.cs, tile.ks)
    return args, n_cycles(o_h, o_w, th, tw, b), cluster


def im2win_conv_cuda(x: torch.Tensor, w: torch.Tensor, *,
                     window: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """Launch the kernel (replaces ``_conv_kernel``): one cluster of
    :func:`cluster_split`'s size per grid step ``(B, ⌈o_h/th⌉,
    ⌈o_w/tw⌉)``.  x (B, H, W, C), w (kh, kw, C, O) on the card ->
    (B, o_h, o_w, O) in x's dtype (the kernel is f32: bf16 operands are
    cast to f32 on the card, the result back to bf16).  Every block
    loads the whole window patch itself (device memory sees it once, the
    cluster's other blocks find it in L2).  Raises when the card cannot place one cluster.  Counts its
    launches in ``im2win_conv_cuda.launches``, grid steps in ``.steps``
    and the blocks the C entry launched (its ``gridDim.x``) in
    ``.blocks``."""
    no_backward("im2win_conv", x, w)
    x, w = cuda_operand(x, "x"), cuda_operand(w, "w")
    dtype = operand_dtype(x=x, w=w)
    x, w = x.float().contiguous(), w.float().contiguous()
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    args, steps, _ = _plan(tuple(x.shape), tuple(w.shape), window)
    o_h, o_w = x.shape[1] - w.shape[0] + 1, x.shape[2] - w.shape[1] + 1
    out = torch.empty((x.shape[0], o_h, o_w, w.shape[3]),
                      dtype=torch.float32, device=x.device)
    blocks = ctypes.c_int(0)
    launch(_library().im2win_conv_f32, x.device, ptr(x, "x"), ptr(w, "w"),
           ptr(out, "out"), *args, ctypes.byref(blocks))
    im2win_conv_cuda.launches += 1
    im2win_conv_cuda.steps += steps
    im2win_conv_cuda.blocks += blocks.value
    return out.to(dtype)


im2win_conv_cuda.launches = 0
im2win_conv_cuda.steps = 0
im2win_conv_cuda.blocks = 0


def reset_counts() -> None:
    im2win_conv_cuda.launches = 0
    im2win_conv_cuda.steps = 0
    im2win_conv_cuda.blocks = 0


def im2win_conv(x: torch.Tensor, w: torch.Tensor, *,
                window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x (B, H, W, C) pre-padded; w (kh, kw, C, O); stride 1 VALID ->
    (B, o_h, o_w, O), f32 or bf16 (summed in f32) as x and w are.  CUDA
    tensors launch the kernel; CPU tensors take
    :func:`im2win_conv_plain`.  No backward
    (:func:`_build.no_backward`)."""
    no_backward("im2win_conv", x, w)
    operand_dtype(x=x, w=w)
    if x.device.type == "cuda":
        return im2win_conv_cuda(x, w, window=window)
    if x.device.type == "cpu":
        return im2win_conv_plain(x, w)
    raise ValueError(f"im2win_conv: unsupported device {x.device}")
