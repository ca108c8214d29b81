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
kernel, no ``scaled_dot_product_attention``.

The attention policy (:func:`attention_policy`, set by
``launch/shapes.py::build_cell`` and read when the ops run):

* ``scores_dtype``: the scores' storage type (None: f32); bf16 halves
  the softmax chain's traffic while the row max and sum stay f32;
* ``scores_sharding`` and ``cp_axis``: context-parallel q blocks for
  head counts that do not divide the "model" axis — each q block is
  row-sharded over "model" and k/v gathered, so scores, softmax and the
  out-product are local.  On ``DTensor`` operands these are
  ``redistribute`` calls (``launch.sharding.constrain``) under the JAX
  package's divisibility conditions, and each block then runs on its
  shard's local tensors (:func:`_local_attend`), so its scores are
  sharded as its q is; plain tensors are left as they are;
* ``inner_remat``: each streamed q block under ``torch.utils.checkpoint``
  (non-reentrant), its scores recomputed in the backward;
* ``mesh``: the mesh the MoE gather-at-use reads (:func:`policy_mesh`).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Optional

import torch
import torch.utils.checkpoint

from ..launch.mesh import axis_sizes
from ..launch.sharding import (NamedSharding, P, constrain, from_local,
                               gather_uneven, local_part, move,
                               partial_reducer)
from .common import in_context

NEG_INF = -1e30

# --- the attention policy (set by the launcher, read when the ops run) ---
_SCORES_SHARDING = contextvars.ContextVar("scores_sharding", default=None)
_SCORES_DTYPE = contextvars.ContextVar("scores_dtype", default=None)
_CP_AXIS = contextvars.ContextVar("cp_axis", default=None)  # (mesh, bd)
_INNER_REMAT = contextvars.ContextVar("inner_remat", default=False)
_POLICY_MESH = contextvars.ContextVar("policy_mesh", default=None)


def policy_mesh():
    """Mesh registered by the launcher policy (None outside an optimized
    train cell)."""
    return _POLICY_MESH.get()


@contextlib.contextmanager
def attention_policy(scores_sharding=None, scores_dtype=None,
                     cp_axis=None, inner_remat=False, mesh=None):
    """cp_axis: (mesh, batch_dim_name) enables context-parallel q blocks:
    each q block is row-sharded over 'model' and k/v are gathered inside
    attention, so scores, softmax and the out-product are local — the
    rescue path for head counts that don't divide the model axis."""
    t1 = _SCORES_SHARDING.set(scores_sharding)
    t2 = _SCORES_DTYPE.set(scores_dtype)
    t3 = _CP_AXIS.set(cp_axis)
    t4 = _INNER_REMAT.set(inner_remat)
    t5 = _POLICY_MESH.set(mesh)
    try:
        yield
    finally:
        _SCORES_SHARDING.reset(t1)
        _SCORES_DTYPE.reset(t2)
        _CP_AXIS.reset(t3)
        _INNER_REMAT.reset(t4)
        _POLICY_MESH.reset(t5)


def _cp_constrain(qb, k, v):
    """Row-shard a q block over 'model'; replicate k/v heads/dh."""
    cp = _CP_AXIS.get()
    if cp is None:
        return qb, k, v
    mesh, bd = cp
    if qb.shape[1] % axis_sizes(mesh)["model"] == 0:
        qb = constrain(qb, NamedSharding(mesh, P(bd, "model", None, None,
                                                 None)))
        kv = NamedSharding(mesh, P(bd, None, None, None))
        k, v = constrain(k, kv), constrain(v, kv)
    return qb, k, v


def _cp_constrain_out(out):
    """Pin the attention output to q-row sharding too, so the gradient
    of out stays row-sharded in the backward (the redistribute's backward
    is the reverse redistribute)."""
    cp = _CP_AXIS.get()
    if cp is None:
        return out
    mesh, bd = cp
    if out.shape[1] % axis_sizes(mesh)["model"] == 0:
        out = constrain(out, NamedSharding(mesh, P(bd, "model", None, None,
                                                   None)))
    return out


def _constrain_scores(q, sk: int):
    """The scores' sharding, asked of the q block that yields them: the
    scores (B,Hkv,G,Bq,Sk) of a ``DTensor`` block are computed on each
    shard's local operands (:func:`_local_attend`), so they are sharded
    as q (B,Bq,Hkv,G,Dh) is on the same dims.  Applicable only if every
    named dim of the scores divides (decode q=1 doesn't)."""
    ns = _SCORES_SHARDING.get()
    if ns is None:
        return q
    b, bq, hkv, g, _ = q.shape
    shape = (b, hkv, g, bq, sk)
    sizes = axis_sizes(ns.mesh)
    for dim, name in enumerate(ns.spec):
        if name is not None:
            ax = name if isinstance(name, str) else name[0]
            if shape[dim] % sizes[ax]:
                return q
    spec = tuple(ns.spec) + (None,) * (5 - len(ns.spec))
    if spec[4] is not None:
        raise ValueError(f"scores sharding {ns.spec}: a split of the keys "
                         f"is not a split of q")
    return constrain(q, NamedSharding(ns.mesh, P(spec[0], spec[3], spec[1],
                                                 spec[2], None)))


def _local_attend(q, k, v, pos_q, pos_k, **kw):
    """:func:`_attend_block` on ``DTensor`` operands, run on each shard's
    local tensors: batch, kv heads, the G query heads a kv head serves
    and the q rows are independent, so q keeps a split of those dims
    (k/v split alike on batch and kv heads, whole on the rest) and drops
    any other (head_dim, a partial sum) by a gather; the output is
    sharded as q.  DTensor's own propagation through the block's 5-d
    einsums searches strategies exponentially in the mesh's dims (a
    (2, 1, 2) mesh took minutes a step on the CPU).

    k/v that arrive split over their sequence (a decode cache's "model"
    split, ``launch.sharding.cache_spec``, self- and cross-attention's)
    keep that split: q is whole on those mesh dims, each rank scores
    its shard of the keys, and the row max, the row sum and the output
    are all-reduced over them (``launch.sharding.partial_reducer``).
    Gathering the cache would move all of it every block and token."""
    mesh = q.device_mesh
    qp, q_grad, kvp, kv_grad, key_dims = _attend_plan(q, k, v)
    q, k, v = move(q, qp), move(k, kvp), move(v, kvp)
    ql = q.to_local(grad_placements=q_grad)
    kl = k.to_local(grad_placements=kv_grad)
    _, offset = local_part(q.shape, mesh, qp)
    rows = pos_q[offset[1]:offset[1] + ql.shape[1]]
    _, k_off = local_part(k.shape, mesh, kvp)
    keys = pos_k[k_off[1]:k_off[1] + kl.shape[1]]
    out = _attend_block(ql, kl, v.to_local(grad_placements=kv_grad), rows,
                        keys, reduce=partial_reducer(mesh, key_dims),
                        **kw).contiguous()     # the global stride below
    return from_local(out, mesh, qp, tuple(q.shape[:4]) + (v.shape[-1],))


def _attend_plan(q, k, v):
    """(q's placements, q's local gradient's, k/v's, k/v's local
    gradients', the mesh dims that split the keys) of
    :func:`_local_attend` for ``DTensor`` q (B,Sq,Hkv,G,Dh) and k/v
    (B,Sk,Hkv,Dh), per mesh dim: k/v split on their sequence (a decode
    cache's) keep it and q is whole there, its gradient a part of the
    sum; k/v split on the batch give q that split (q moves, not the
    cache); else q keeps a split of its batch, kv heads, rows or query
    heads, k/v alike on the batch and kv heads and whole on the rest
    (where q's rows or query heads are split, each shard's gradient of
    k/v is a part of the sum), and any other split is gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    plan, key_dims = [], []
    rep, part = Replicate(), Partial()
    for i, p in enumerate(q.placements):
        kv = k.placements[i] if k.placements[i] == v.placements[i] else None
        if kv == Shard(1):
            plan.append((rep, part, kv, kv))
            key_dims.append(i)
        elif q.device_mesh.shape[i] > 1 and kv == Shard(0):
            plan.append((kv, kv, kv, kv))
        elif isinstance(p, Shard) and p.dim in (0, 2):
            plan.append((p, p, p, p))
        elif isinstance(p, Shard) and p.dim in (1, 3):
            plan.append((p, p, rep, part))
        else:
            plan.append((rep,) * 4)
    return tuple(list(c) for c in zip(*plan)) + (key_dims,)


def gather_for_split_keys(kv, *ws):
    """Weights ``ws`` gathered whole where ``kv`` is split over its
    sequence (dim 1); anything not a ``DTensor``, or any ``kv`` split
    otherwise, as it is.  MLA's decode makes its keys and values from the
    compressed cache by products with weights split over "model" on
    their heads and over "data" on the latent: whole, they let the keys
    keep the cache's splits (the split-keys decode,
    :func:`_local_attend`), where DTensor would gather the cache over
    one or the other."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(kv, DTensor) or Shard(1) not in kv.placements:
        return ws
    return tuple([move(w, [Replicate()] * w.device_mesh.ndim)
                  if isinstance(w, DTensor) else w for w in ws])


def _head_dim_split(w, dim: int) -> bool:
    """Whether ``w`` is a ``DTensor`` split on its head_dim ``dim``: the
    fallback of ``launch.sharding.param_spec`` where the heads do not
    divide the "model" axis."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(w, DTensor) and any(
        isinstance(p, Shard) and p.dim == dim for p in w.placements)


def _local_product(eq: str, x, w, w_split: tuple, x_dim: dict, out_split):
    """``torch.einsum(eq, x, w)`` of ``DTensor`` operands on each shard's
    local tensors.  Per mesh dim: where ``w`` is split on a dim of
    ``w_split`` it keeps that split and ``x`` takes the matching one
    (``x_dim[w dim]``, None: whole), the output ``out_split(w dim)``
    (a ``Shard`` or a ``Partial`` sum); elsewhere ``w`` is gathered and
    ``x`` keeps a split of its batch or sequence dim (else is gathered),
    which the output keeps.  The gradients' placements follow: a whole
    operand against a split partner gets a partial gradient."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    xp, wp, op, xg, wg = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(pw, Shard) and pw.dim in w_split:
            d = x_dim[pw.dim]
            wp.append(pw)
            wg.append(pw)
            xp.append(Replicate() if d is None else Shard(d))
            xg.append(Partial() if d is None else Shard(d))
            op.append(out_split(pw.dim))
        elif isinstance(px, Shard) and px.dim in (0, 1):
            xp.append(px)
            xg.append(px)
            wp.append(Replicate())
            wg.append(Partial())
            op.append(px)
        else:
            xp.append(Replicate())
            xg.append(Replicate())
            wp.append(Replicate())
            wg.append(Replicate())
            op.append(Replicate())
    x, w = move(x, xp), move(w, wp)
    out = torch.einsum(eq, x.to_local(grad_placements=xg),
                       w.to_local(grad_placements=wg))
    ins, out_dims = eq.split("->")
    size = dict(zip(ins.replace(",", ""), tuple(x.shape) + tuple(w.shape)))
    return from_local(out, mesh, op, tuple(size[c] for c in out_dims))


def _local_heads_product(w, d_model: int, head_dim: int) -> bool:
    """Whether a head projection runs on local shards
    (:func:`_local_product`): ``w`` a ``DTensor`` split on its head_dim
    (the fallback of ``launch.sharding.param_spec`` where the heads do
    not divide "model"), or split on nothing but its heads (the weights
    gathered over the data axes at use).  On the second DTensor's own
    einsum keeps the heads split forward but gathers the weight's
    gradient and the input's in the backward, each rank multiplying
    every head.  A weight still split on d_model (a decode, which
    gathers no weights) takes DTensor's einsum, which moves the small
    activations instead."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(w, DTensor) and (_head_dim_split(w, head_dim) or (
        Shard(d_model) not in w.placements))


def project_heads(x, w):
    """The q/k/v projection ``einsum("bsd,dhe->bshe", x, w)``, on local
    shards where :func:`_local_heads_product` says: there DTensor's own
    einsum flattens (H, dh) and cannot view a split head_dim back, or
    multiplies every head in the backward.  The output keeps a split of
    the heads and the batch and is gathered over head_dim, along which
    rotary, the cache write and attention act (attention would gather
    it: :func:`_local_attend`)."""
    if not _local_heads_product(w, 0, 2):
        return torch.einsum("bsd,dhe->bshe", x, w)
    from torch.distributed.tensor import Replicate, Shard
    out = _local_product("bsd,dhe->bshe", x, w, (1, 2), {1: None, 2: None},
                         lambda d: Shard(d + 1))
    return move(out, [Replicate() if p == Shard(3) else p
                      for p in out.placements])


def merge_heads(out, wo):
    """The output projection ``einsum("bshe,hed->bsd", out, wo)``, on
    local shards where :func:`_local_heads_product` says: each rank sums
    its head or head_dim slice, so the result is a ``Partial`` sum over
    that mesh dim."""
    if not _local_heads_product(wo, 2, 1):
        return torch.einsum("bshe,hed->bsd", out, wo)
    from torch.distributed.tensor import Partial
    return _local_product("bshe,hed->bsd", out, wo, (0, 1), {0: 2, 1: 3},
                          lambda d: Partial())


def group_heads(q, hkv: int):
    """q (B, S, Hq, Dh) viewed as (B, S, Hkv, G, Dh).  A ``DTensor`` q
    split on its heads over a mesh dim that does not divide ``hkv`` (8
    kv heads on a 16-way "model" axis) is gathered on that dim first:
    DTensor cannot view such a split."""
    b, s, hq, dh = q.shape
    return gather_uneven(q, 2, size=hkv).reshape(b, s, hkv, hq // hkv, dh)


def _attend(q, k, v, pos_q, pos_k, **kw):
    """One block: on ``DTensor`` operands with the scores' sharding asked
    of q, on local shards; on plain tensors as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _local_attend(_constrain_scores(q, k.shape[1]), k, v, pos_q,
                             pos_k, **kw)
    return _attend_block(q, k, v, pos_q, pos_k, **kw)


@functools.lru_cache(maxsize=None)
def _rounded(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype``, on the host: a product of two bf16
    values is exact in the f32 a bf16 multiply computes in, and is
    rounded once, as the JAX package's bf16 multiply by its scale."""
    return float(torch.tensor(scale, dtype=dtype))


def _attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pos_q: torch.Tensor, pos_k: torch.Tensor, *,
                  causal: bool, window: Optional[int],
                  kv_len: Optional[int], scale: float,
                  reduce=None) -> torch.Tensor:
    """One q block against one kv block.  q (B,Bq,Hkv,G,Dh);
    k/v (B,Sk,Hkv,Dh); returns (B,Bq,Hkv,G,Dv) in v's dtype.

    The products are summed in f32 (a product of two bf16 values is exact
    in f32) and stored in the policy's scores type: f32 by default, or
    bf16 rounded once, then scaled in bf16 (the JAX package asks its
    einsum for that type and multiplies by the scale in it; bf16 operands
    go to a bf16 GEMM, which sums in f32 and rounds its result).  The row
    max (no gradient, ``stop_gradient``; the max of bf16 values is one of
    them) and the row sum are f32; the mask value, the exponentials and
    the division are in the scores' type; the weights are cast to v's
    dtype before the product with v.  No f32 copy of bf16 scores is
    made.

    ``reduce`` (``launch.sharding.partial_reducer``), where given,
    combines shards of the keys: the row max and the row sum are
    all-reduced before they are used, so each weight is the one the
    whole row gives; the output is summed in f32 over the shards and
    cast to v's dtype once."""
    sdt = _SCORES_DTYPE.get() or torch.float32
    if q.dtype == k.dtype == sdt:
        scores = torch.einsum("bqhgd,bshd->bhgqs", q, k)
    else:
        scores = torch.einsum("bqhgd,bshd->bhgqs", q.float(),
                              k.float()).to(sdt)
    scores = scores * _rounded(scale, sdt)
    mask = torch.ones(scores.shape[-2:], dtype=torch.bool,
                      device=scores.device)
    if causal:
        mask &= pos_k[None, :] <= pos_q[:, None]
    if window is not None:
        mask &= pos_k[None, :] > pos_q[:, None] - window
    if kv_len is not None:        # decode: ignore cache beyond fill level
        mask &= (pos_k < kv_len)[None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(-1, keepdim=True).float().detach()
    if reduce is not None:
        m = reduce(m, "max")
    e = torch.exp(scores - m.to(sdt))
    denom = e.sum(-1, keepdim=True, dtype=torch.float32)
    if reduce is not None:
        denom = reduce(denom, "sum")
    w = (e / denom.to(sdt)).to(v.dtype)
    if reduce is None:
        return torch.einsum("bhgqs,bshd->bqhgd", w, v)
    return reduce(torch.einsum("bhgqs,bshd->bqhgd", w.float(), v.float()),
                  "sum").to(v.dtype)


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
    dim = _query_head_split(q, k, v)
    if dim is not None:
        return _local_heads(q, k, v, dim, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len,
                            q_block=q_block)
    scale = 1.0 / math.sqrt(dh)
    qg = group_heads(q, hkv)

    def positions(start, n):
        return start + torch.arange(n, device=q.device)

    if sq <= q_block:
        qg, k, v = _cp_constrain(qg, k, v)
        out = _attend(qg, k, v, positions(q_offset, sq),
                            positions(0, sk), causal=causal, window=window,
                            kv_len=kv_len, scale=scale)
        return _cp_constrain_out(out).reshape(b, sq, hq, dv)

    sq_orig = sq
    if sq % q_block:                 # pad q; padded rows are discarded
        pad = q_block - sq % q_block
        qg = torch.cat([qg, qg.new_zeros((b, pad) + qg.shape[2:])], 1)
        sq += pad

    cp = _CP_AXIS.get()
    if cp is not None:
        # gather q once a layer, so slicing the blocks is local
        mesh, bd = cp
        qg = constrain(qg, NamedSharding(mesh, P(bd, None, None, None,
                                                 None)))

    # sliding window: each q block only needs a bounded kv slice
    kv_slice = sk if window is None else min(sk, window + q_block)

    def block(qb, kb, vb, pos_q, pos_k):
        qb, kb, vb = _cp_constrain(qb, kb, vb)
        out = _attend(qb, kb, vb, pos_q, pos_k, causal=causal,
                            window=window, kv_len=kv_len, scale=scale)
        return _cp_constrain_out(out)

    run = block
    if _INNER_REMAT.get():
        # scores and softmax recomputed in the backward instead of kept
        # for every block of the layer
        inner = in_context(block)

        def run(*a):
            return torch.utils.checkpoint.checkpoint(inner, *a,
                                                     use_reentrant=False)

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
        outs.append(run(qb, kb, vb,
                        positions(q_offset + i * q_block, q_block),
                        positions(kv_start, kv_slice)))
    out = torch.cat(outs, 1)
    return out.reshape(b, sq, hq, dv)[:, :sq_orig]


def _query_head_split(q, k, v):
    """The mesh dim over which a ``DTensor`` q (B, Sq, Hq, Dh) splits its
    query heads where that dim does not divide the kv heads (8 on a
    16-way "model" axis) but each rank's heads fall within one kv head's
    group or hold whole groups; None if there is none (or more than one,
    or k/v split their sequence there: a decode keeps the cache's split).
    """
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(q, DTensor):
        return None
    hq, hkv = q.shape[2], k.shape[2]
    g = hq // hkv
    dims = [i for i, p in enumerate(q.placements) if p == Shard(2)]
    if len(dims) != 1:
        return None
    i = dims[0]
    n = q.device_mesh.shape[i]
    per = hq // n
    if (hkv % n == 0 or hq % n or (g % per and per % g)
            or Shard(1) in (k.placements[i], v.placements[i])):
        return None
    return i


def _local_heads(q, k, v, dim: int, **kw):
    """:func:`attention` of a ``DTensor`` q split over mesh dim ``dim`` on
    its query heads where that dim does not divide the kv heads
    (:func:`_query_head_split`): each rank attends with its own query
    heads to the one or more kv heads they read, on local tensors (the
    plain :func:`attention`); k/v are whole over ``dim`` and each
    rank's gradient of them a part of the sum.  Elsewhere q and k/v
    keep a split of the batch they share and are whole otherwise.
    DTensor cannot view such a head split as (kv heads, group), so
    every rank would otherwise attend with all heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    qp, kvp, kvg = [], [], []
    for i, p in enumerate(q.placements):
        kv = k.placements[i] if k.placements[i] == v.placements[i] else None
        if i == dim:
            qp.append(p)
            kvp.append(Replicate())
            kvg.append(Partial())
        elif p == kv == Shard(0):
            qp.append(p)
            kvp.append(p)
            kvg.append(p)
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
            kvg.append(Replicate())
    q, k, v = move(q, qp), move(k, kvp), move(v, kvp)
    ql = q.to_local()
    _, off = local_part(q.shape, mesh, qp)
    g = q.shape[2] // k.shape[2]
    h0, h1 = off[2] // g, (off[2] + ql.shape[2] - 1) // g + 1
    out = attention(ql, k.to_local(grad_placements=kvg)[:, :, h0:h1],
                    v.to_local(grad_placements=kvg)[:, :, h0:h1], **kw)
    return from_local(out.contiguous(), mesh, qp,
                      tuple(q.shape[:3]) + (v.shape[-1],))


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
    overwrites earlier slots).  A ``DTensor`` cache is written on local
    shards (:func:`_update_local`)."""
    from torch.distributed.tensor import DTensor
    length, n = buf.shape[1], new.shape[1]
    if not 0 <= pos <= length - n:
        raise IndexError(f"{n} cache position(s) at {pos} do not fit a "
                         f"cache of length {length}")
    if isinstance(buf, DTensor):
        return _update_local(buf, new, pos)
    out = buf.clone()
    out[:, pos:pos + n] = new
    return out


def _update_local(buf, new, pos: int):
    """:func:`update_slice` of a ``DTensor`` cache: ``new``, gathered over
    the mesh dims that split the cache's sequence (and split as the cache
    on every other dim), is written by each rank into the part of its
    local shard that ``[pos, pos + n)`` covers.  DTensor's own slice
    assignment into a sequence-split cache writes into a gathered copy
    and loses the write."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in buf.placements]
    new = new.redistribute(mesh, pl).to_local()
    local = buf.to_local().clone()
    _, offset = local_part(buf.shape, mesh, buf.placements)
    lo = max(pos, offset[1])
    hi = min(pos + new.shape[1], offset[1] + local.shape[1])
    if lo < hi:
        local[:, lo - offset[1]:hi - offset[1]] = new[:, lo - pos:hi - pos]
    return from_local(local, mesh, buf.placements, buf.shape, buf.stride())


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
    taken to f32 for a plain softmax.  ``DTensor`` operands run on local
    shards (:func:`_attend_plan`): a ring split over its slots stays
    split, and the softmax is combined over the shards."""
    from torch.distributed.tensor import DTensor
    b, sq, hq, dh = q.shape
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    slot = torch.arange(length, device=q.device)
    cur = step % length
    abs_pos = torch.where(slot <= cur, step - cur + slot,
                          step - cur + slot - length)
    valid = (abs_pos >= 0) & (abs_pos <= step) & (abs_pos > step - window)
    qg = group_heads(q, k.shape[2])
    if isinstance(qg, DTensor):
        # on local shards, a split ring (the cache's "model" split) kept
        mesh = qg.device_mesh
        qp, _, kvp, _, key_dims = _attend_plan(qg, k, v)
        qg, k, v = move(qg, qp), move(k, kvp), move(v, kvp)
        kl = k.to_local()
        _, k_off = local_part(k.shape, mesh, kvp)
        out = _ring_block(qg.to_local(), kl, v.to_local(),
                          valid[k_off[1]:k_off[1] + kl.shape[1]],
                          partial_reducer(mesh, key_dims)).contiguous()
        out = from_local(out, mesh, qp, tuple(qg.shape[:4]) + (dh,))
    else:
        out = _ring_block(qg, k, v, valid)
    return out.reshape(b, sq, hq, dh)


def _ring_block(qg, k, v, valid, reduce=None):
    """:func:`decode_attention_ring`'s scores and softmax of grouped q
    against ring slots ``valid`` marks.  ``reduce`` combines shards of
    the ring as :func:`_attend_block` combines them: the row max and sum
    all-reduced, the output summed in f32."""
    # JAX multiplies by the Python float in the scores' dtype (bf16)
    scale = torch.tensor(1.0 / math.sqrt(qg.shape[-1]), dtype=qg.dtype)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg, k) * scale
    scores = scores.float().masked_fill(~valid, NEG_INF)
    if reduce is None:
        w = torch.softmax(scores, -1).to(v.dtype)
        return torch.einsum("bhgqs,bshd->bqhgd", w, v)
    m = reduce(scores.amax(-1, keepdim=True), "max")
    e = torch.exp(scores - m)
    w = (e / reduce(e.sum(-1, keepdim=True), "sum")).to(v.dtype)
    return reduce(torch.einsum("bhgqs,bshd->bqhgd", w.float(), v.float()),
                  "sum").to(v.dtype)
