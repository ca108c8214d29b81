"""Inter-layer glue: the deterministic adapters between mapped layers
(port of ``repro/exec/glue.py``).

A `NetworkMapping` chains layers whose padded specs rarely line up
exactly; the glue closes the gap in two orthogonal directions:

* **spatial** — :func:`fit_spatial` 2x2-max-pools while the carry is
  >= 2x the next layer's (padded) input, then center-pads / center-crops
  to the exact size.  Deterministic in the *shapes* only.
* **channel** — :func:`resolve_chain` classifies how layer i feeds
  layer i+1 from pure channel arithmetic: ``"chain"`` when the next
  layer's ic equals this layer's oc, ``"concat"`` (DenseNet-style: the
  layer's unpadded input is concatenated with its output) when it
  equals their sum, and a clear error otherwise.

Glue is a structured `core.GlueSpec`: ``kind`` is the carry rule
(:data:`GLUE_KINDS`), plus optional per-layer stages the CIM macros do
not execute — ``pre`` layernorm passthrough (:func:`layernorm`), ``act``
activations (:data:`ACTIVATIONS`), ``save``/``kind="residual"`` for
transformer residual adds, and the ``post="attention"`` stage
(:func:`attention_stage`) that turns a fused qkv projection's output
into attention context via `kernels.flash_attention` between two mapped
matmuls.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.types import GlueSpec  # noqa: F401  (re-export)

#: Post-layer carry updates a plan can prescribe (LayerPlan.glue.kind).
GLUE_KINDS = ("chain", "concat", "residual", "last")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


#: Per-layer glue activations (GlueSpec.act).  A layer whose glue names
#: one overrides any network-global ``activation`` for that layer.
ACTIVATIONS = {"relu": F.relu, "gelu": _gelu, "silu": F.silu}


def layernorm(x: torch.Tensor, dim: int = 1,
              eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free layernorm over the channel axis (GlueSpec.pre),
    with the biased variance (``jnp.var``).  Norms stay outside the CIM
    macros as passthrough stages; learned scale/bias would fold into the
    next matmul's mapped weights."""
    mu = x.mean(dim=dim, keepdim=True)
    var = x.var(dim=dim, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def attention_stage(y: torch.Tensor, heads, causal: bool, *,
                    plain: bool = False) -> torch.Tensor:
    """The attention stage (GlueSpec.post="attention"): consume a fused
    qkv projection's output ``y (B, (hq+2*hkv)*hd, M, 1)`` and return
    context ``(B, hq*hd, M, 1)`` for the mapped O projection.

    Runs `kernels.flash_attention.mha_flash` for every M: the CUDA
    kernel masks ragged tiles, so the JAX package's plain branch for an
    M that does not tile by 128 is not needed.  ``plain=True`` takes
    `flash_attention_ref` instead (the oracle forward).  The stage is
    glue, not a mapped layer, so cycle accounting is unaffected either
    way."""
    from ..kernels import flash_attention as fa
    hq, hkv, hd = heads
    b, c, m, w = y.shape
    if w != 1 or c != (hq + 2 * hkv) * hd:
        raise ValueError(f"attention_stage: qkv output {tuple(y.shape)} != "
                         f"(B, {(hq + 2 * hkv) * hd}, M, 1) for "
                         f"heads={heads}")
    tok = y[..., 0].transpose(1, 2)                      # (B, M, C)
    q = tok[..., :hq * hd].reshape(b, m, hq, hd)
    k = tok[..., hq * hd:(hq + hkv) * hd].reshape(b, m, hkv, hd)
    v = tok[..., (hq + hkv) * hd:].reshape(b, m, hkv, hd)
    if not plain:
        o = fa.mha_flash(q, k, v, causal=causal)
    else:
        o = fa.flash_attention_ref(*fa.fold_heads(q, k, v), causal=causal)
        o = o.reshape(b, hq, m, hd).transpose(1, 2)
    return o.reshape(b, m, hq * hd).transpose(1, 2)[..., None]


def fit_spatial(x: torch.Tensor, i_h: int, i_w: int) -> torch.Tensor:
    """Deterministic inter-layer adapter: 2x2 max-pool while the feature
    map is >= 2x the next layer's (padded) input, then center pad / crop
    to the exact size.  Mirrored by the oracle composition so the
    cross-check compares executors, not plumbing."""
    while x.shape[-2] >= 2 * i_h and x.shape[-1] >= 2 * i_w:
        x = F.max_pool2d(x, 2, 2)
    for ax, tgt in ((-2, i_h), (-1, i_w)):
        d = tgt - x.shape[ax]
        if d > 0:
            pad = [0, 0, 0, 0]
            i = 0 if ax == -1 else 2
            pad[i:i + 2] = [d // 2, d - d // 2]
            x = F.pad(x, pad)
        elif d < 0:
            lo = (-d) // 2
            x = x.narrow(x.ndim + ax, lo, tgt)
    return x


def center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Center (h, w) spatial slice of x (..., H, W) with H >= h, W >= w."""
    y0 = (x.shape[-2] - h) // 2
    x0 = (x.shape[-1] - w) // 2
    return x[..., y0:y0 + h, x0:x0 + w]


def resolve_chain(name: str, oc: int, carry_c: int,
                  nxt_name: str, nxt_ic: int) -> str:
    """Classify how a layer with ``oc`` output channels (and ``carry_c``
    carried input channels) feeds the next layer: ``"chain"`` or
    ``"concat"``.  Raises the chaining error on any other arithmetic —
    at plan-compile time, not mid-forward."""
    if nxt_ic == oc:
        return "chain"
    if nxt_ic == carry_c + oc:
        return "concat"
    raise ValueError(
        f"cannot chain {name} (oc={oc}, carry={carry_c}) into "
        f"{nxt_name} (ic={nxt_ic})")
