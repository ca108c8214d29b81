"""Attention: GQA / MQA / sliding-window / local, with q-block streaming
(port of ``repro/models/attention.py``), so 32k-prefill activations stay
O(S * block) and sliding-window variants stay sub-quadratic (the kv
slice per q block is bounded by window + block).

Shapes: q (B, Sq, Hq, Dh); k/v (B, Sk, Hkv, Dh) with Hq % Hkv == 0.
GQA is computed grouped: q is viewed as (B, Sq, Hkv, G, Dh) and k/v are
never expanded to Hq heads.  All masks derive from absolute positions,
so the same code serves train (q_offset=0), prefill, and decode (Sq=1,
q_offset=cache position).

These are plain PyTorch ops, as the JAX package's are plain ``jnp``: no
kernel, no ``scaled_dot_product_attention``.  Left out: the JAX
package's attention policy (``attention_policy``: scores sharding and
storage type, context-parallel q blocks, inner remat), which only its
mesh launcher sets; it waits for the LM production mesh (ROADMAP.md
queue 1, item 7b).
The scores are f32, the policy's default.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pos_q: torch.Tensor, pos_k: torch.Tensor, *,
                  causal: bool, window: Optional[int],
                  kv_len: Optional[int], scale: float) -> torch.Tensor:
    """One q block against one kv block.  q (B,Bq,Hkv,G,Dh);
    k/v (B,Sk,Hkv,Dh); returns (B,Bq,Hkv,G,Dv) in v's dtype.

    The scores are f32 from the start (the JAX package asks its einsum
    for an f32 result; a product of two bf16 values is exact in f32), the
    row max and sum f32, and the weights are cast to v's dtype before
    the product with v."""
    scores = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float()) * scale
    mask = torch.ones(scores.shape[-2:], dtype=torch.bool,
                      device=scores.device)
    if causal:
        mask &= pos_k[None, :] <= pos_q[:, None]
    if window is not None:
        mask &= pos_k[None, :] > pos_q[:, None] - window
    if kv_len is not None:        # decode: ignore cache beyond fill level
        mask &= (pos_k < kv_len)[None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    w = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bhgqs,bshd->bqhgd", w, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None,
              q_offset: int = 0,
              kv_len: Optional[int] = None,
              q_block: int = 512) -> torch.Tensor:
    """Multi-head attention with q-block streaming.

    window: sliding/local attention width (None = full).
    q_offset: absolute position of q[0] (decode/continuation).
    kv_len: actual fill level of the kv buffer (decode caches).
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, hkv, g, dh)

    def positions(start, n):
        return start + torch.arange(n, device=q.device)

    if sq <= q_block:
        out = _attend_block(qg, k, v, positions(q_offset, sq),
                            positions(0, sk), causal=causal, window=window,
                            kv_len=kv_len, scale=scale)
        return out.reshape(b, sq, hq, dv)

    sq_orig = sq
    if sq % q_block:                 # pad q; padded rows are discarded
        pad = q_block - sq % q_block
        qg = torch.cat([qg, qg.new_zeros((b, pad) + qg.shape[2:])], 1)
        sq += pad

    # sliding window: each q block only needs a bounded kv slice
    kv_slice = sk if window is None else min(sk, window + q_block)
    outs = []
    for i in range(sq // q_block):   # the JAX package's lax.scan
        qb = qg[:, i * q_block:(i + 1) * q_block]
        kv_start = 0
        kb, vb = k, v
        if kv_slice != sk:
            kv_start = min(max(q_offset + i * q_block
                               - (kv_slice - q_block), 0), sk - kv_slice)
            kb = k[:, kv_start:kv_start + kv_slice]
            vb = v[:, kv_start:kv_start + kv_slice]
        outs.append(_attend_block(
            qb, kb, vb, positions(q_offset + i * q_block, q_block),
            positions(kv_start, kv_slice), causal=causal, window=window,
            kv_len=kv_len, scale=scale))
    out = torch.cat(outs, 1)
    return out.reshape(b, sq, hq, dv)[:, :sq_orig]


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, length: int, hkv: int, dh: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    return {"k": torch.zeros((batch, length, hkv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, length, hkv, dh), dtype=dtype,
                             device=device)}


def update_slice(buf: torch.Tensor, new: torch.Tensor, pos: int
                 ) -> torch.Tensor:
    """A copy of ``buf`` with ``new`` written along dim 1 from ``pos``.

    A write past the end raises ``IndexError``, where the JAX package's
    ``dynamic_update_slice`` clamps the start so the write fits (and
    overwrites earlier slots)."""
    length, n = buf.shape[1], new.shape[1]
    if not 0 <= pos <= length - n:
        raise IndexError(f"{n} cache position(s) at {pos} do not fit a "
                         f"cache of length {length}")
    out = buf.clone()
    out[:, pos:pos + n] = new
    return out


def cache_insert(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int) -> dict:
    """A new cache with (B, S_new, Hkv, Dh) written at position ``pos``
    (:func:`update_slice`); the given one is left as it was.  For ring
    (sliding-window) caches pass pos % length."""
    return {"k": update_slice(cache["k"], k_new, pos),
            "v": update_slice(cache["v"], v_new, pos)}


def decode_attention_ring(q: torch.Tensor, cache: dict, step: int,
                          window: int) -> torch.Tensor:
    """Decode vs a ring buffer of size ``window`` (SWA long-context
    decode).  Ring entries hold absolute positions step-window+1..step
    (mod wrap); masking by absolute position is wrap-invariant, so plain
    full attention over the ring handles it.

    Not :func:`_attend_block`'s numerics, as in the JAX package: the
    scores are formed in the inputs' dtype and scaled there, only then
    taken to f32 for a plain softmax."""
    b, sq, hq, dh = q.shape
    length = cache["k"].shape[1]
    slot = torch.arange(length, device=q.device)
    cur = step % length
    abs_pos = torch.where(slot <= cur, step - cur + slot,
                          step - cur + slot - length)
    hkv = cache["k"].shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    # JAX multiplies by the Python float in the scores' dtype (bf16)
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=q.dtype)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg, cache["k"]) * scale
    scores = scores.float()
    valid = (abs_pos >= 0) & (abs_pos <= step) & (abs_pos > step - window)
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, -1).to(cache["v"].dtype)
    out = torch.einsum("bhgqs,bshd->bqhgd", w, cache["v"])
    return out.reshape(b, sq, hq, dh)
