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
(bh, q tile of 64 or 128 rows) and a loop over 64-key tiles, f32 math on
the CUDA cores for f32 or bf16 operands (D up to 128); rows per block
come from :func:`flash_launch_dims`.

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
import heapq
import math
from typing import NamedTuple

import torch

from ._build import (address, cuda_operand, launch, no_backward,
                     operand_dtype, ptr)
from .tetris_matmul import sm_count
from .window_product import SMEM_LIMIT

SOURCE = "flash_attention.cu"
NEG_INF = -1e30
#: largest head dim the kernel takes
MAX_HEAD_DIM = 128
#: the kernel's instances: head dims (a smaller D runs on the next one
#: up), query rows per block (2 threads a row), keys per kv tile
HEAD_DIMS = (32, 64, 128)
BLOCK_ROWS = (128, 64)
KV_TILE = 64


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """The plain version: q (BH, Sq, D); k/v (BH, Sk, D) -> (BH, Sq, D),
    softmax attention with the score matrix in memory, in f32, returned
    in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        pos_q = q_offset + torch.arange(sq, device=q.device)[:, None]
        pos_k = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(pos_k <= pos_q, s, torch.full_like(s, NEG_INF))
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1),
                        v.float()).to(q.dtype)


class FlashLaunch(NamedTuple):
    """How the kernel lays out one launch."""

    rows: int      # query rows per block (threads: 2 per row)
    dp: int        # the head-dim instance (d rounded up to HEAD_DIMS)
    smem: int      # bytes of shared memory per block
    blocks: int    # blocks of the launch: bh x ceil(sq / rows)


def flash_smem_bytes(rows: int, dp: int) -> int:
    """Shared memory of a block (``smem_floats`` in the source): the q
    tile and a ring of two (k, v) tile pairs, rows of dp + 4 floats, and
    the probability tile, rows of 64 + 4."""
    return 4 * ((rows + 4 * KV_TILE) * (dp + 4) + rows * (KV_TILE + 4))


def busiest_sm_work(bh: int, sq: int, sk: int, rows: int, causal: bool,
                    q_offset: int, sms: int) -> int:
    """The work (query rows x keys visited) of the busiest of ``sms`` SMs
    when the blocks, in the order the card starts them (q tiles last to
    first, heads within a q tile), each go to the SM with the least work
    so far.  A block visits every 64-key tile up to its last row's
    position under the causal mask, every tile otherwise."""
    n_kv = math.ceil(sk / KV_TILE)
    loads = [0] * min(sms, bh * math.ceil(sq / rows))
    for qt in reversed(range(math.ceil(sq / rows))):
        tiles = n_kv
        if causal:
            last = q_offset + min((qt + 1) * rows, sq) - 1
            tiles = min(n_kv, last // KV_TILE + 1)
        for _ in range(bh):
            heapq.heapreplace(loads, loads[0] + rows * tiles * KV_TILE)
    return max(loads)


def flash_launch_dims(bh: int, sq: int, d: int, sms: int, *, sk: int = 0,
                      causal: bool = False, q_offset: int = 0
                      ) -> FlashLaunch:
    """The rows per block (128 or 64) that give the busiest of the card's
    ``sms`` SMs the least work (:func:`busiest_sm_work`; ``sk`` 0 means
    Sk = Sq).  Under the causal mask the diagonal blocks compute masked
    halves, and a 128-row block's half is twice as large.  A tie goes to
    128 rows, which stage each k and v tile once for twice the rows.  A
    layout past 227 KB of shared memory (128 rows at D > 64) is not
    taken."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes 1..{MAX_HEAD_DIM}")
    dp = next(h for h in HEAD_DIMS if d <= h)
    best = None
    for rows in BLOCK_ROWS:
        smem = flash_smem_bytes(rows, dp)
        if smem > SMEM_LIMIT:
            continue
        cost = busiest_sm_work(bh, sq, sk or sq, rows, causal, q_offset, sms)
        if best is None or cost < best[0]:
            best = (cost, FlashLaunch(rows, dp, smem,
                                      bh * math.ceil(sq / rows)))
    return best[1]


def vector_staging(*operands: torch.Tensor) -> bool:
    """Whether the kernel may stage with 16-byte copies: every operand's
    base is 16-byte aligned and its rows (contiguous, of d values) are a
    multiple of 16 bytes."""
    bases = [address(t, f"vector_staging operand {i}")
             for i, t in enumerate(operands)]
    return all(a % 16 == 0 and t.shape[-1] * t.element_size() % 16 == 0
               for a, t in zip(bases, operands))


@functools.cache
def _library() -> ctypes.CDLL:
    """The built ``csrc/flash_attention.cu``, its C signature declared."""
    from . import _build
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [ptr] * 4 + [i32] * 6 \
        + [ctypes.c_float] + [i32] * 3 + [ptr]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         rows: int = 0) -> torch.Tensor:
    """Launch the kernel (replaces ``_flash_kernel``) on q (BH, Sq, D),
    k/v (BH, Sk, D), all f32 or all bf16, contiguous (a copy where they
    are not); returns (BH, Sq, D) in their dtype.  ``rows`` (64 or 128)
    overrides :func:`flash_launch_dims`' rows per block, for measuring
    the two against each other.  Counts its launches in
    ``flash_attention_cuda.launches``."""
    no_backward("flash_attention", q, k, v)
    q, k, v = (cuda_operand(t, n).contiguous()
               for t, n in ((q, "q"), (k, "k"), (v, "v")))
    dtype = operand_dtype(q=q, k=k, v=v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0: every query row must "
                         f"see key 0")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on different devices")
    if rows not in (0, *BLOCK_ROWS):
        raise ValueError(f"rows {rows}: the kernel has {BLOCK_ROWS}")
    rows = rows or flash_launch_dims(bh, sq, d, sm_count(q.device), sk=sk,
                                     causal=causal, q_offset=q_offset).rows
    out = torch.empty_like(q)
    launch(_library().flash_attention_fwd, q.device, ptr(q, "q"),
           ptr(k, "k"), ptr(v, "v"), ptr(out, "out"), bh, sq, sk, d,
           int(causal), q_offset, ctypes.c_float(1.0 / math.sqrt(d)), rows,
           int(dtype == torch.bfloat16), int(vector_staging(q, k, v, out)))
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def reset_counts() -> None:
    flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (BH, Sq, D); k/v (BH, Sk, D) — heads pre-folded into the leading
    dim.  Returns (BH, Sq, D) for any Sq and Sk, f32 or bf16 (softmax and
    sums in f32) as q, k and v are.  CUDA tensors launch the kernel; CPU
    tensors take :func:`flash_attention_ref`.  No backward
    (:func:`_build.no_backward`)."""
    no_backward("flash_attention", q, k, v)
    operand_dtype(q=q, k=k, v=v)
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
