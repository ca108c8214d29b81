"""Fused (flash) attention (port of ``repro/kernels/flash_attention.py``).

On a TPU ``flash_attention`` runs ``_flash_kernel`` over the grid
``(BH, Sq/bq, Sk/bk)``, kv innermost, with the online-softmax running
state (m, l, acc) in VMEM scratch across kv steps:

    m_new = max(m, rowmax(s));  alpha = exp(m - m_new)
    l     = alpha * l + rowsum(exp(s - m_new))
    acc   = alpha * acc + exp(s - m_new) @ v

Causal masking is by absolute position (``q_offset`` for decode and
continuation), masked scores are -1e30, and the epilogue divides by
max(l, 1e-30).  Here the hand-written CUDA kernel of
``csrc/flash_attention.cu`` computes the same with one block per
(bh, q tile) and a loop over kv tiles (D up to 128).

:func:`flash_attention` launches the kernel for CUDA tensors (counted in
``flash_attention_cuda.launches``) and takes :func:`flash_attention_ref`,
the plain softmax version, only for CPU tensors.  The TPU kernel's rule
that Sq and Sk tile by ``min(128, S)`` is not kept: the CUDA kernel masks
ragged q and kv tiles, so every length runs on it.  :func:`mha_flash`
folds GQA head groups into the leading dim.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import cuda_operand, launch, ptr

SOURCE = "flash_attention.cu"
NEG_INF = -1e30
#: largest head dim the kernel takes
MAX_HEAD_DIM = 128


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """The plain version: q (BH, Sq, D); k/v (BH, Sk, D) -> (BH, Sq, D),
    softmax attention with the score matrix in memory."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        pos_q = q_offset + torch.arange(sq, device=q.device)[:, None]
        pos_k = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(pos_k <= pos_q, s, torch.full_like(s, NEG_INF))
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v.float())


@functools.cache
def _library() -> ctypes.CDLL:
    """The built ``csrc/flash_attention.cu``, its C signature declared."""
    from . import _build
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_f32.argtypes = [ptr] * 4 + [i32] * 6 \
        + [ctypes.c_float, ptr]
    lib.flash_attention_f32.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel (replaces ``_flash_kernel``) on q (BH, Sq, D),
    k/v (BH, Sk, D), contiguous (a copy where they are not).  Counts its
    launches in ``flash_attention_cuda.launches``."""
    q, k, v = (cuda_operand(t, n).contiguous()
               for t, n in ((q, "q"), (k, "k"), (v, "v")))
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes 1..{MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0: every query row must "
                         f"see key 0")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on different devices")
    out = torch.empty_like(q)
    launch(_library().flash_attention_f32, q.device, ptr(q), ptr(k), ptr(v),
           ptr(out), bh, sq, sk, d, int(causal), q_offset,
           ctypes.c_float(1.0 / math.sqrt(d)))
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def reset_counts() -> None:
    flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (BH, Sq, D); k/v (BH, Sk, D) — heads pre-folded into the leading
    dim.  Returns (BH, Sq, D) f32, for any Sq and Sk.  CUDA tensors
    launch the kernel; CPU tensors take :func:`flash_attention_ref`."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal,
                                    q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   q_offset=q_offset)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def fold_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q (B, S, H, D), k/v (B, Sk, Hkv, D) -> (B*H, S, D) and
    (B*H, Sk, D) each, kv heads repeated per GQA group (head h reads kv
    head h // (H // Hkv): ``repeat_interleave``, as ``jnp.repeat``)."""
    b, sq, hq, dd = q.shape
    g = hq // k.shape[2]
    qf = q.transpose(1, 2).reshape(b * hq, sq, dd)
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(
        b * hq, k.shape[1], dd)
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(
        b * hq, v.shape[1], dd)
    return qf, kf, vf


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, Hkv, D) -> (B, S, H, D), GQA head
    expansion folded into the flash grid."""
    b, sq, hq, dd = q.shape
    of = flash_attention(*fold_heads(q, k, v), causal=causal)
    return of.reshape(b, hq, sq, dd).transpose(1, 2)
