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
size is :func:`n_cycles`.  The CUDA kernel of ``csrc/im2win_conv.cu``
launches exactly that grid, one block per step.

:func:`im2win_conv` launches it for CUDA tensors (counted in
``im2win_conv_cuda.launches``; its blocks in ``im2win_conv_cuda.blocks``)
and takes :func:`im2win_conv_plain`, ``F.conv2d`` on NCHW views, only
for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.tetris import factor_pairs_square_first
from ._build import cuda_operand, launch, ptr

SOURCE = "im2win_conv.cu"


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
    """The plain version: ``F.conv2d`` on NCHW / OIHW views, f32."""
    conv_window(x.shape, w.shape)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built ``csrc/im2win_conv.cu``, its C signature declared."""
    from . import _build
    lib = _build.load(SOURCE)
    lib.im2win_conv_f32.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.im2win_conv_f32.restype = ctypes.c_int
    return lib


def im2win_conv_cuda(x: torch.Tensor, w: torch.Tensor, *,
                     window: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """Launch the kernel (replaces ``_conv_kernel``) over the grid
    ``(B, ⌈o_h/th⌉, ⌈o_w/tw⌉)``: x (B, H, W, C), w (kh, kw, C, O), f32 on
    the card -> (B, o_h, o_w, O) f32.  Counts its launches in
    ``im2win_conv_cuda.launches`` and its blocks in ``.blocks``."""
    x = cuda_operand(x, "x").contiguous()
    w = cuda_operand(w, "w").contiguous()
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    o_h, o_w, th, tw = conv_window(x.shape, w.shape, window)
    b, h, w_, c = x.shape
    k_h, k_w, _, oc = w.shape
    out = torch.empty((b, o_h, o_w, oc), dtype=torch.float32, device=x.device)
    launch(_library().im2win_conv_f32, x.device, ptr(x), ptr(w), ptr(out),
           b, h, w_, c, k_h, k_w, oc, th, tw)
    im2win_conv_cuda.launches += 1
    im2win_conv_cuda.blocks += n_cycles(o_h, o_w, th, tw, b)
    return out


im2win_conv_cuda.launches = 0
im2win_conv_cuda.blocks = 0


def reset_counts() -> None:
    im2win_conv_cuda.launches = 0
    im2win_conv_cuda.blocks = 0


def im2win_conv(x: torch.Tensor, w: torch.Tensor, *,
                window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x (B, H, W, C) pre-padded; w (kh, kw, C, O); stride 1 VALID ->
    (B, o_h, o_w, O) f32.  CUDA tensors launch the kernel; CPU tensors
    take :func:`im2win_conv_plain`."""
    if x.device.type == "cuda":
        return im2win_conv_cuda(x, w, window=window)
    if x.device.type == "cpu":
        return im2win_conv_plain(x, w)
    raise ValueError(f"im2win_conv: unsupported device {x.device}")
