"""Mamba-2 SSD (state-space duality) mixer, chunked form (port of
``repro/models/ssm.py``) [arXiv:2405.21060].

Prefill runs the chunked algorithm: the intra-chunk quadratic part and
each chunk's final state on the ``ssd_chunk`` kernel
(:mod:`repro_torch.kernels.ssd_chunk`), then the inter-chunk state
recurrence (a loop over chunks) and its contribution to y here, in f32.
Decode is the O(1) recurrent update.  ``segsum`` and ``cumsum`` (whose
backward runs on a ``DTensor``'s local shard) live beside the kernel's
plain version, which uses them, and are re-exported here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..kernels.ssd_chunk import (cumsum, segsum, ssd_chunk,  # noqa: F401
                                 ssd_chunk_plain)
from ..launch.sharding import gather_uneven
from .common import cast


@dataclass(frozen=True)
class SSMConfig:
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int = 128
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                cfg: SSMConfig, init_state: Optional[torch.Tensor] = None,
                *, plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H) post-softplus; a_log (H,) with
    A=-exp(a_log); b,c (B,S,G,N); d_skip (H,).  Returns (y (B,S,H,P),
    state (B,H,P,N)), both in x's dtype.  ``plain=True`` takes the
    intra-chunk part from ``ssd_chunk_plain`` on any device (the oracle).
    ``DTensor`` x and dt split unevenly over their heads are gathered
    there first (``launch.sharding.gather_uneven``)."""
    x, dt = gather_uneven(x, 2), gather_uneven(dt, 2)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    chunk = min(cfg.chunk, s)
    s_orig = s
    if s % chunk:
        # pad with dt=0 tokens: decay exp(0)=1 and contribution dt*x=0,
        # so padding is exact for both outputs and the final state
        pad = chunk - s % chunk

        def zpad(a):
            return torch.cat([a, a.new_zeros((bsz, pad) + a.shape[2:])], 1)
        x, dt, b, c = zpad(x), zpad(dt), zpad(b), zpad(c)
        s += pad
    nc, rep, f32 = s // chunk, h // g, torch.float32

    intra = ssd_chunk_plain if plain else ssd_chunk
    y_intra, states = intra(x, dt, a_log, b, c, chunk=chunk)

    a = -torch.exp(a_log.to(f32))
    da_cs = cumsum((dt.to(f32) * a).reshape(bsz, nc, chunk, h), 2)
    chunk_decay = torch.exp(da_cs[:, :, -1])                  # (B,nc,H)
    hs = (x.new_zeros((bsz, h, p, n), dtype=f32) if init_state is None
          else init_state.to(f32))
    h_prevs = []                            # the state BEFORE each chunk
    for i in range(nc):
        h_prevs.append(hs)
        hs = hs * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prev = torch.stack(h_prevs, 1).reshape(bsz, nc, g, rep, p, n)

    # inter-chunk contribution: C_i exp(dA_cs[i]) h_prev, group by group
    c_c = c.to(f32).reshape(bsz, nc, chunk, g, n)
    y_inter = torch.einsum("bnigs,bngrps->bnigrp", c_c, h_prev)
    y_inter = y_inter.reshape(bsz, nc, chunk, h, p) * torch.exp(da_cs)[..., None]

    y = (y_intra.to(f32) + y_inter.reshape(bsz, s, h, p)).to(x.dtype)
    y = y + x * d_skip.to(x.dtype)[None, None, :, None]
    return y[:, :s_orig], hs.to(x.dtype)


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                    state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: x (B,1,H,P); b,c (B,1,G,N); state (B,H,P,N)."""
    h = x.shape[2]
    rep = h // b.shape[2]
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    da = torch.exp(dt[:, 0].to(f32) * a)                      # (B,H)
    b_rep = b[:, 0].repeat_interleave(rep, dim=1).to(f32)     # (B,H,N)
    c_rep = c[:, 0].repeat_interleave(rep, dim=1).to(f32)
    xdt = (x[:, 0] * dt[:, 0, :, None].to(x.dtype)).to(f32)
    new_state = (state.to(f32) * da[..., None, None]
                 + torch.einsum("bhp,bhn->bhpn", xdt, b_rep))
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_rep)
    y = y.to(x.dtype) + x[:, 0] * d_skip.to(x.dtype)[None, :, None]
    return y[:, None], new_state.to(state.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x (B,S,D); w (K,D); state (B,K-1,D) holds
    the trailing inputs of the previous segment.  Returns (y, new_state)."""
    k, s = w.shape[0], x.shape[1]
    pad = (x.new_zeros((x.shape[0], k - 1, x.shape[2])) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], 1)
    y = xp[:, 0:s] * cast(w[0])[None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * cast(w[i])[None, None, :]
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return y, new_state
