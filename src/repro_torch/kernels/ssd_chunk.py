"""SSD intra-chunk kernel (port of ``repro/kernels/ssd_chunk.py``), the
Mamba-2 prefill hot spot [arXiv:2405.21060].

For each (batch, chunk) of ``L`` tokens and each head, with ``cs`` the
cumulative sum of ``dt * A`` over the chunk (``A = -exp(a_log)``)::

    y[i] = sum_{j<=i} (C_i . B_j) * exp(cs_i - cs_j) * dt_j * x[j]
    S    = sum_j B_j * exp(cs_end - cs_j) * dt_j * x[j]

the masked-decay product and the chunk-final state that the host-side
inter-chunk scan consumes (``models/ssm.py``).  On a TPU ``_ssd_kernel``
holds a whole chunk's (L, L, H) decay tensor in VMEM.  Here
``csrc/ssd_chunk.cu`` has two instances:

* bf16 (the one that serves) runs every product on the tensor cores.
  C . B^T does not depend on the head, so a y block owns (chunk, group,
  128-row query tile, a slice of the group's heads) and computes each
  16 x 16 score tile once for the slice; the f32 operand of the y and
  state products (the decayed scores times dt, and x dt times the decay)
  is split into bf16 ``hi + lo`` (within 2^-18; ``hi + mid + lo``,
  within 2^-27, for the states), the other operand (x, B) is the exact
  bf16 input.  State blocks, one per (chunk, head), write the states in
  the same launch.  :func:`ssd_launch_dims` picks the slice width and
  the launch order (heaviest blocks first); :func:`vector_staging` picks
  16-byte or element-wise staging.
* f32 keeps the CUDA-core body of the first port: one block per (chunk,
  head, query tile) and one more per (chunk, head) for the state.

B and C come as (B, S, G, N) and head ``h`` reads group ``h // (H // G)``
(``G == H`` is the TPU kernel's pre-repeated signature).
:func:`ssd_chunk` launches the kernel for CUDA tensors (counted in
``ssd_chunk_cuda.launches``, its blocks in ``ssd_chunk_cuda.blocks``) and
takes :func:`ssd_chunk_plain` only for CPU tensors; a ``DTensor`` runs
the same choice on each rank's local shards (:func:`ssd_chunk_local`).
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import NamedTuple, Tuple

import torch

from ._build import address, launch, no_backward, ptr
from .tetris_matmul import sm_count
from .window_product import SMEM_LIMIT

SOURCE = "ssd_chunk.cu"
#: largest head dim the kernel takes (its y accumulators)
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)
#: the bf16 instance: keys of a key tile (and p rows of a state pass),
#: query rows of a y block (eight warps of 16), bf16 a staged row is
#: padded by, state columns of one state pass, slots of a state block's
#: ring
TILE, QUERY_ROWS, PAD, STATE_COLS, STATE_SLOTS = 64, 128, 8, 128, 2
#: its instances: n8 tiles of y a warp holds per head (the first >=
#: round16(P) / 8), and heads a y block may take, at most
#: MAX_ACC_TILES / tiles of them (the y accumulators)
ACC_TILES = (2, 4, 8, 16)
SLICE_HEADS = (1, 2, 4)
MAX_ACC_TILES = 16


def _check_shapes(x, dt, a_log, b, c, chunk: int) -> None:
    bsz, s, h, _ = x.shape
    g = b.shape[2]
    if dt.shape != (bsz, s, h) or a_log.shape != (h,) or b.ndim != 4 \
            or b.shape[:2] != (bsz, s) or c.shape != b.shape:
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_log "
                         f"{tuple(a_log.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} do not match")
    if h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    if s % chunk:
        raise ValueError(f"S {s} % chunk {chunk} != 0")


class _LocalCumsum(torch.autograd.Function):
    """``torch.cumsum`` of a ``DTensor`` whose backward, the reversed
    cumsum autograd writes as flip, cumsum, flip, runs on the local
    shard (``dim`` made whole first where it is split): DTensor has no
    strategy for ``aten.flip`` in every torch (none in 2.11), and the
    local ops are the ones autograd runs on a plain tensor, so the
    gradient is bitwise the same."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim = dim % x.ndim
        return torch.cumsum(x, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate, Shard
        from ..launch.sharding import from_local, move
        dim = ctx.dim
        if g.numel() <= 1 or g.shape[dim] == 1:
            return g, None
        pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
              for p in g.placements]
        g = move(g, pl)
        local = g.to_local().flip(dim).cumsum(dim).flip(dim)
        return from_local(local, g.device_mesh, pl, g.shape), None


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``; on a ``DTensor`` (not ``meta``: the dry
    run keeps DTensor's own op) through :class:`_LocalCumsum`."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and x.device.type != "meta":
        return _LocalCumsum.apply(x, dim)
    return torch.cumsum(x, dim)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., l) -> (..., l, l) with out[i,j] = sum a[j+1..i], -inf above
    the diagonal (decay matrix exponent: its exp is 0 there, never NaN)."""
    n = a.shape[-1]
    cs = cumsum(a, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(n, n, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, in f32 with the (L, L) decay in memory:
    x (B,S,H,P); dt (B,S,H); a_log (H,); b/c (B,S,G,N) -> (y_intra
    (B,S,H,P) in x's dtype, states (B, S/chunk, H, P, N) f32)."""
    _check_shapes(x, dt, a_log, b, c, chunk)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc, f32 = s // chunk, torch.float32
    xf = x.to(f32).reshape(bsz, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(bsz, nc, chunk, h)
    bf = b.to(f32).repeat_interleave(h // g, dim=2).reshape(
        bsz, nc, chunk, h, n)
    cf = c.to(f32).repeat_interleave(h // g, dim=2).reshape(
        bsz, nc, chunk, h, n)
    da = dtf * -torch.exp(a_log.to(f32))                       # (B,nc,L,H)
    dec = torch.exp(segsum(da.movedim(-1, -2)))                # (B,nc,H,L,L)
    cb = torch.einsum("bnihs,bnjhs->bnhij", cf, bf)
    xdt = xf * dtf[..., None]
    y = torch.einsum("bnhij,bnjhp->bnihp", cb * dec, xdt)
    cs = cumsum(da, 2)
    dec_end = torch.exp(cs[:, :, -1:, :] - cs)                  # (B,nc,L,H)
    states = torch.einsum("bnjhs,bnjh,bnjhp->bnhps", bf, dec_end, xdt)
    return y.reshape(bsz, s, h, p).to(x.dtype), states


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def acc_tiles(p: int) -> int:
    """The instance's n8 tiles of y a warp holds per head at head dim
    ``p``."""
    return next(k for k in ACC_TILES if _round16(p) // 8 <= k)


def ssd_smem_bytes(heads: int, chunk: int, p: int, n: int) -> int:
    """Shared memory of a bf16 block, the larger of its two roles (mirrors
    ``smem_bytes`` in the source).  A y block: two f32 arrays per head
    over the chunk padded to whole query tiles, the C tile (128 rows), a
    ring of two (B tile, ``heads`` x tiles).  A state block: two f32
    arrays, a ring of two (an x tile of <= 64 columns, a B tile of <=
    128)."""
    lp = math.ceil(chunk / QUERY_ROWS) * QUERY_ROWS
    np_, pp = _round16(n) + PAD, _round16(p) + PAD
    y = 8 * heads * lp + 2 * QUERY_ROWS * np_ + 4 * TILE * (np_ + heads * pp)
    xw = min(_round16(p), TILE) + PAD
    bw = min(_round16(n), STATE_COLS) + PAD
    return max(y, 8 * lp + 2 * STATE_SLOTS * TILE * (xw + bw))


class SsdLaunch(NamedTuple):
    heads: int        # heads a y block applies its scores to
    slices: int       # head slices of a group
    state_level: int  # query-tile levels launched before the state blocks
    blocks: int       # y blocks + state blocks
    smem: int         # bytes of shared memory a block


def block_work(chunk: int, p: int, n: int, qt: int, heads: int) -> int:
    """Tensor-core multiply-adds of a y block of query tile ``qt`` with
    ``heads`` heads (``heads`` 0: of a state block), padding included.
    Each warp of a y block owns 16 query rows and, per key tile, runs the
    16-key steps that hold a key <= its last row: per step the scores
    (16 x 16 x round16(N)) once and each head's hi and lo products (2 x
    16 x 16 x round16(P)).  A state block runs the hi, mid and lo
    products over every key tile (3 x 64 x round16(P) x round16(N)
    each)."""
    np_, pp = _round16(n), _round16(p)
    if heads == 0:
        return math.ceil(chunk / TILE) * 3 * TILE * pp * np_
    q0 = qt * QUERY_ROWS
    end = min(q0 + QUERY_ROWS, chunk)
    steps = sum(min(4, (r0 + 15 - kt * TILE) // 16 + 1)
                for r0 in range(q0, end, 16)
                for kt in range((end - 1) // TILE + 1)
                if r0 + 15 - kt * TILE >= 0)
    return steps * 16 * 16 * (np_ + 2 * heads * pp)


def launch_works(batch: int, seq: int, heads: int, head_dim: int,
                 groups: int, d_state: int, chunk: int, slice_heads: int,
                 state_level: int) -> list:
    """The work (:func:`block_work`) of every block of a bf16 launch, in
    the order the kernel numbers them: the query tiles last to first,
    within one (batch * chunk, group, head slice), and the state blocks
    (one per (batch * chunk, head)) after ``state_level`` query tiles."""
    rep, nc = heads // groups, seq // chunk
    n_qt = math.ceil(chunk / QUERY_ROWS)
    state = [block_work(chunk, head_dim, d_state, 0, 0)] * (batch * nc
                                                            * heads)
    sizes = [min(slice_heads, rep - s) for s in range(0, rep, slice_heads)]
    works = []
    for level, qt in enumerate(reversed(range(n_qt))):
        if level == state_level:
            works += state
        works += [block_work(chunk, head_dim, d_state, qt, hs)
                  for hs in sizes] * (batch * nc * groups)
    return works + (state if state_level == n_qt else [])


@functools.lru_cache(maxsize=256)
def ssd_launch_dims(batch: int, seq: int, heads: int, head_dim: int,
                    groups: int, d_state: int, chunk: int, sms: int, *,
                    slice_heads: int = 0) -> SsdLaunch:
    """The bf16 launch: the heads a y block takes and the launch order.

    Per (batch * chunk, group) the y blocks of one query tile share their
    scores across a slice of the group's heads: a wider slice computes
    C . B^T fewer times but makes fewer blocks.  Blocks start heaviest
    first: the query tiles last to first, and the state blocks (one per
    (batch * chunk, head)) after the query tiles whose full-slice blocks
    have at least their work.  Of the widths the kernel has
    (:data:`SLICE_HEADS`, at most ``MAX_ACC_TILES / acc_tiles(P)``, at
    most the group's heads, within shared memory) the rule takes the one
    that gives the busiest of ``sms`` SMs the least work when each block
    in launch order goes to the SM with the least work so far; a tie
    goes to the wider slice.
    ``slice_heads`` forces a width (for measuring them against each
    other).  Cached: the wrapper asks at every call, and scheduling some
    1,500 blocks takes about a millisecond of host time."""
    if seq % chunk or heads % groups:
        raise ValueError(f"S {seq} % chunk {chunk} or H {heads} % G "
                         f"{groups} != 0")
    rep, n_qt = heads // groups, math.ceil(chunk / QUERY_ROWS)
    widths = [w for w in SLICE_HEADS
              if w * acc_tiles(head_dim) <= MAX_ACC_TILES
              and (w <= rep or w == 1)
              and ssd_smem_bytes(w, chunk, head_dim, d_state) <= SMEM_LIMIT]
    if slice_heads:
        if slice_heads not in widths:
            raise ValueError(f"{slice_heads} heads a block: the kernel "
                             f"takes {widths} at P {head_dim}, N {d_state}")
        widths = [slice_heads]
    if not widths:
        raise ValueError(f"no bf16 layout fits chunk {chunk}, P "
                         f"{head_dim}, N {d_state} in shared memory")
    state = block_work(chunk, head_dim, d_state, 0, 0)
    best = None
    for w in widths:
        level = sum(block_work(chunk, head_dim, d_state, qt, w) >= state
                    for qt in range(n_qt))
        works = launch_works(batch, seq, heads, head_dim, groups, d_state,
                             chunk, w, level)
        loads = [0] * min(sms, len(works))
        for work in works:
            heapq.heapreplace(loads, loads[0] + work)
        lay = SsdLaunch(w, math.ceil(rep / w), level, len(works),
                        ssd_smem_bytes(w, chunk, head_dim, d_state))
        if best is None or max(loads) <= best[0]:
            best = (max(loads), lay)
    return best[1]


def vector_staging(*operands: torch.Tensor) -> bool:
    """Whether the bf16 kernel may stage with 16-byte copies: every
    operand's base is 16-byte aligned, its strides but the last and its
    rows (N or P values) multiples of 8 bf16."""
    bases = [address(t, f"vector_staging operand {i}")
             for i, t in enumerate(operands)]
    return all(a % 16 == 0 and t.shape[-1] % 8 == 0
               and all(s % 8 == 0 for s in t.stride()[:-1])
               for a, t in zip(bases, operands))


class SsdArgs(ctypes.Structure):
    """One launch's sizes and strides; mirrors ``struct SsdArgs`` in
    ``csrc/ssd_chunk.cu`` field for field."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "batch", "seq", "heads", "head_dim", "groups", "d_state", "chunk")]
        + [(f, ctypes.c_longlong) for f in (
            "x_b", "x_s", "x_h", "dt_b", "dt_s", "b_b", "b_s", "b_g",
            "c_b", "c_s", "c_g")])


@functools.cache
def _library() -> ctypes.CDLL:
    """The built ``csrc/ssd_chunk.cu``, its C signature declared."""
    from . import _build
    lib = _build.load(SOURCE)
    vp = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.ssd_chunk_fwd.argtypes = [vp] * 7 + [
        ctypes.POINTER(SsdArgs), i32, i32, i32, i32, ctypes.POINTER(i32), vp]
    lib.ssd_chunk_fwd.restype = ctypes.c_int
    return lib


def _operand(t: torch.Tensor, name: str, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as the kernel reads it: CUDA, ``dtype``, unit last stride."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, the kernel needs a "
                         f"CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, x is {dtype}: the kernel "
                         f"takes one type for x, dt, b and c")
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
                   slice_heads: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (replaces ``_ssd_kernel``) on x (B,S,H,P), dt
    (B,S,H), b/c (B,S,G,N), all f32 or all bf16, and a_log (H,).  Views
    with a unit last stride are read in place.  bf16 takes
    :func:`ssd_launch_dims`' layout (``slice_heads`` forces its width).
    Counts its launches in ``ssd_chunk_cuda.launches`` and the blocks the
    C entry reports in ``ssd_chunk_cuda.blocks``."""
    no_backward("ssd_chunk", x, dt, a_log, b, c)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x is {x.dtype}, the kernel takes {_DTYPES}")
    x, dt, b, c = (_operand(t, n, x.dtype) for t, n in
                   ((x, "x"), (dt, "dt"), (b, "b"), (c, "c")))
    _check_shapes(x, dt, a_log, b, c, chunk)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if p > MAX_HEAD_DIM:
        raise ValueError(f"head dim {p}: the kernel takes <= {MAX_HEAD_DIM}")
    if len({x.device, dt.device, b.device, c.device, a_log.device}) != 1:
        raise ValueError("the operands lie on different devices")
    a_log = a_log.to(torch.float32).contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    states = torch.empty((bsz, s // chunk, h, p, n), dtype=torch.float32,
                         device=x.device)
    args = SsdArgs(bsz, s, h, p, g, n, chunk,
                   *x.stride()[:3], *dt.stride()[:2], *b.stride()[:3],
                   *c.stride()[:3])
    bf16 = x.dtype == torch.bfloat16
    lay = (ssd_launch_dims(bsz, s, h, p, g, n, chunk, sm_count(x.device),
                           slice_heads=slice_heads) if bf16 else None)
    blocks = ctypes.c_int(0)
    launch(_library().ssd_chunk_fwd, x.device, ptr(x, "x"), ptr(dt, "dt"),
           ptr(a_log, "a_log"), ptr(b, "b"), ptr(c, "c"), ptr(y, "y"),
           ptr(states, "states"), ctypes.byref(args),
           int(bf16), lay.heads if bf16 else 0,
           lay.state_level if bf16 else 0,
           int(bf16 and vector_staging(x, b, c)), ctypes.byref(blocks))
    ssd_chunk_cuda.launches += 1
    ssd_chunk_cuda.blocks += blocks.value
    return y, states


ssd_chunk_cuda.launches = 0
ssd_chunk_cuda.blocks = 0


def reset_counts() -> None:
    ssd_chunk_cuda.launches = 0
    ssd_chunk_cuda.blocks = 0


def local_placements(placements, mesh_shape, batch: int, heads: int,
                     groups: int) -> list:
    """The placements of x (B,S,H,P) (and dt, and the states (B, S/chunk,
    H, P, N)) under which every rank runs the kernel on its local shards:
    x's splits of the batch (dim 0) and of the heads (dim 2) where they
    are even and each rank's heads read whole groups or all read one
    group; ``Replicate()`` on every other mesh dim.  So these are
    redistributed first: a ``Partial``, a split of the sequence or of P,
    an uneven batch or head split (``ssd_chunked`` gathers an uneven head
    split itself, before this), and heads that straddle a group (all
    head splits then)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [p if type(p) is Shard and p.dim in (0, 2) else Replicate()
          for p in placements]
    rep = heads // groups
    for dim, size in ((0, batch), (2, heads)):
        ways = math.prod(n for n, p in zip(mesh_shape, pl)
                         if p == Shard(dim))
        local = size // ways
        if size % ways or (dim == 2 and local % rep and rep % local):
            pl = [Replicate() if p == Shard(dim) else p for p in pl]
    return pl


def ssd_chunk_local(x, dt, a_log, b, c, *, chunk: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunk` on ``DTensor`` operands: each rank runs the
    per-device function on its local shards (:func:`ssd_chunk_cuda` on
    the card, :func:`ssd_chunk_plain` on the CPU) and the outputs are
    wrapped back, y with x's placements and the states with the same
    batch and head splits.  x and dt are first placed by
    :func:`local_placements` (which says what is redistributed); b and c
    keep x's batch split and take the rest whole, and a rank slices from
    them the groups its heads read, and from a_log (made whole) its
    heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..launch.sharding import from_local, local_part, move
    mesh = x.device_mesh
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    _check_shapes(x, dt, a_log, b, c, chunk)
    pl = local_placements(x.placements, mesh.shape, bsz, h, g)
    x, dt = move(x, pl), move(dt, pl)
    _, off = local_part(x.shape, mesh, pl)
    xl = x.to_local()
    h0, hl = off[2], xl.shape[2]
    rep = h // g
    g0, g1 = h0 // rep, (h0 + hl - 1) // rep + 1
    bc_pl = [Shard(0) if q == Shard(0) else Replicate() for q in pl]
    b, c = (move(t, bc_pl).to_local()[:, :, g0:g1] for t in (b, c))
    if isinstance(a_log, DTensor):
        a_log = move(a_log, [Replicate()] * mesh.ndim).to_local()
    a_log = a_log[h0:h0 + hl]
    dtl = dt.to_local()
    if xl.device.type == "cuda":
        y, states = ssd_chunk_cuda(xl, dtl, a_log, b, c, chunk=chunk)
    elif xl.device.type == "cpu":
        y, states = ssd_chunk_plain(xl, dtl, a_log, b, c, chunk=chunk)
    else:
        raise ValueError(f"ssd_chunk: unsupported device {xl.device}")
    # contiguous, as the global strides from_local states: the plain
    # version's y is a permuted view (the kernel's outputs already are)
    return (from_local(y.contiguous(), mesh, pl, x.shape),
            from_local(states.contiguous(), mesh, pl,
                       (bsz, s // chunk, h, p, n)))


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H) post-softplus; a_log (H,); b/c (B,S,G,N).
    S % chunk == 0.  Returns (y_intra (B,S,H,P) in x's dtype, states
    (B, S/chunk, H, P, N) f32).  CUDA tensors launch the kernel; CPU
    tensors take :func:`ssd_chunk_plain`, and so do ``meta`` tensors
    (shapes without data: the dry run, ``launch.dryrun``, which reaches
    no kernel), ``DTensor``s on ``meta`` included.  Other ``DTensor``s
    run on each rank's local shards (:func:`ssd_chunk_local`): on the
    card that launches the kernel or raises.  No backward
    (:func:`_build.no_backward`)."""
    from torch.distributed.tensor import DTensor
    no_backward("ssd_chunk", x, dt, a_log, b, c)
    if isinstance(x, DTensor) and x.device.type != "meta":
        return ssd_chunk_local(x, dt, a_log, b, c, chunk=chunk)
    if x.device.type == "cuda":
        return ssd_chunk_cuda(x, dt, a_log, b, c, chunk=chunk)
    if x.device.type in ("cpu", "meta"):
        return ssd_chunk_plain(x, dt, a_log, b, c, chunk=chunk)
    raise ValueError(f"ssd_chunk: unsupported device {x.device}")
