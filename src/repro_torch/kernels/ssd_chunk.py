"""SSD intra-chunk kernel (port of ``repro/kernels/ssd_chunk.py``), the
Mamba-2 prefill hot spot [arXiv:2405.21060].

For each (batch, chunk) of ``L`` tokens and each head, with ``cs`` the
cumulative sum of ``dt * A`` over the chunk (``A = -exp(a_log)``)::

    y[i] = sum_{j<=i} (C_i . B_j) * exp(cs_i - cs_j) * dt_j * x[j]
    S    = sum_j B_j * exp(cs_end - cs_j) * dt_j * x[j]

the masked-decay product and the chunk-final state that the host-side
inter-chunk scan consumes (``models/ssm.py``).  On a TPU ``_ssd_kernel``
holds a whole chunk's (L, L, H) decay tensor in VMEM; here the CUDA
kernel of ``csrc/ssd_chunk.cu`` gives a block one (chunk, head) and a
64-row query tile and loops over key tiles, with one more block per
(chunk, head) for the state.

B and C come as (B, S, G, N) and head ``h`` reads group ``h // (H // G)``
(``G == H`` is the TPU kernel's pre-repeated signature).
:func:`ssd_chunk` launches the kernel for CUDA tensors (counted in
``ssd_chunk_cuda.launches``) and takes :func:`ssd_chunk_plain` only for
CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ._build import launch, ptr

SOURCE = "ssd_chunk.cu"
#: largest head dim the kernel takes (its y accumulators)
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)


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


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., l) -> (..., l, l) with out[i,j] = sum a[j+1..i], -inf above
    the diagonal (decay matrix exponent: its exp is 0 there, never NaN)."""
    n = a.shape[-1]
    cs = torch.cumsum(a, -1)
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
    cs = torch.cumsum(da, dim=2)
    dec_end = torch.exp(cs[:, :, -1:, :] - cs)                  # (B,nc,L,H)
    states = torch.einsum("bnjhs,bnjh,bnjhp->bnhps", bf, dec_end, xdt)
    return y.reshape(bsz, s, h, p).to(x.dtype), states


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
    lib.ssd_chunk_fwd.argtypes = [vp] * 7 + [ctypes.POINTER(SsdArgs),
                                             ctypes.c_int, vp]
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
                   b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (replaces ``_ssd_kernel``) on x (B,S,H,P), dt
    (B,S,H), b/c (B,S,G,N), all f32 or all bf16, and a_log (H,).  Views
    with a unit last stride are read in place.  Counts its launches in
    ``ssd_chunk_cuda.launches``."""
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
    launch(_library().ssd_chunk_fwd, x.device, ptr(x), ptr(dt), ptr(a_log),
           ptr(b), ptr(c), ptr(y), ptr(states), ctypes.byref(args),
           int(x.dtype == torch.bfloat16))
    ssd_chunk_cuda.launches += 1
    return y, states


ssd_chunk_cuda.launches = 0


def reset_counts() -> None:
    ssd_chunk_cuda.launches = 0


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H) post-softplus; a_log (H,); b/c (B,S,G,N).
    S % chunk == 0.  Returns (y_intra (B,S,H,P) in x's dtype, states
    (B, S/chunk, H, P, N) f32).  CUDA tensors launch the kernel; CPU
    tensors take :func:`ssd_chunk_plain`."""
    if x.device.type == "cuda":
        return ssd_chunk_cuda(x, dt, a_log, b, c, chunk=chunk)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, a_log, b, c, chunk=chunk)
    raise ValueError(f"ssd_chunk: unsupported device {x.device}")
