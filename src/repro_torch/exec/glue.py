"""Inter-layer glue: the deterministic adapters between mapped layers
(port of ``repro/exec/glue.py``, CNN part).

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

``layernorm`` and the attention stage of the transformer lowerings are
not ported yet.
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


#: Per-layer glue activations (GlueSpec.act).
ACTIVATIONS = {"relu": F.relu, "gelu": _gelu, "silu": F.silu}


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
