"""Execute a :class:`NetworkPlan` (port of ``repro/exec/run.py``).

PyTorch runs eagerly, so the forward is a Python loop over the planned
layers: each layer's glue is replayed, then its planned executor runs.
The JAX package's whole-forward ``jax.jit`` program and its lookahead
``_fence`` barrier (which only shaped XLA's schedule inside that
program) have no counterpart here; ``NetworkPlan.lookahead`` stays in
the IR and is inert.  Capturing the forward in a CUDA graph is later
work.  Torch has no input-buffer donation: ``donate`` is accepted and
changes nothing.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..cnn.cim_conv import cim_conv2d, reference_conv2d
from ..cnn.mapped_net import mapped_conv2d
from ..kernels.sdk_conv import sdk_conv
from .glue import ACTIVATIONS, center_crop, fit_spatial
from .plan import LayerPlan, NetworkPlan

ConvFn = Callable[[LayerPlan, torch.Tensor, torch.Tensor], torch.Tensor]


def _layer_conv(lp: LayerPlan, x: torch.Tensor,
                kernel: torch.Tensor) -> torch.Tensor:
    """Dispatch one layer to its planned executor."""
    m = lp.mapping
    if lp.executor == "mapped":
        return mapped_conv2d(m, x, kernel)
    if lp.executor == "sdk":
        return sdk_conv(m, x, kernel, block=lp.block,
                        vmem_budget=lp.vmem_budget)
    return cim_conv2d(m, x, kernel)


def _oracle_conv(lp: LayerPlan, x: torch.Tensor,
                 kernel: torch.Tensor) -> torch.Tensor:
    return reference_conv2d(lp.mapping.layer, x, kernel,
                            groups=lp.mapping.group)


def _forward(plan: NetworkPlan, kernels: Sequence[torch.Tensor],
             x: torch.Tensor, activation, conv: ConvFn) -> torch.Tensor:
    """The planned forward chain.  Glue kinds were classified at compile
    time (exec/glue.py); this only replays them."""
    for lp, k in zip(plan.layers, kernels):
        lay = lp.mapping.layer
        xp = fit_spatial(x, lay.i_h, lay.i_w)
        y = conv(lp, xp, k)
        if lp.glue.act != "none":
            y = ACTIVATIONS[lp.glue.act](y)
        elif activation is not None:
            y = activation(y)
        if lp.glue.kind == "concat":
            skip = center_crop(xp, y.shape[-2], y.shape[-1])
            x = torch.cat([skip, y], dim=1)
        else:                       # "chain" / "last"
            x = y
    return x


def _check_call(plan: NetworkPlan, kernels, x: torch.Tensor) -> None:
    if len(kernels) != len(plan.layers):
        raise ValueError(f"{len(kernels)} kernels for "
                         f"{len(plan.layers)} planned layers")
    if plan.batch is not None and x.shape[0] != plan.batch:
        raise ValueError(f"batch {x.shape[0]} != plan batch {plan.batch}"
                         f" — pad the request or recompile")
    lay0 = plan.layers[0].mapping.layer
    if x.shape[1] != lay0.ic:
        raise ValueError(f"{lay0.name}: input has {x.shape[1]} channels,"
                         f" layer expects {lay0.ic}")
    for t in (x, *kernels):
        if t.device.type != plan.device:
            raise ValueError(f"a tensor on {t.device} was passed to a plan "
                             f"compiled for {plan.device}")


def execute_plan(plan: NetworkPlan, kernels: Sequence[torch.Tensor],
                 x: torch.Tensor, *, activation=None,
                 donate: bool = False) -> torch.Tensor:
    """Run the planned forward on the plan's device.

    ``kernels[i]`` is layer i's kernel in grouped HWIO layout, ``x`` the
    (batch, ic, i_h, i_w) input; both must lie on the plan's device.
    ``activation`` applies after every layer.  ``donate`` is accepted
    for the JAX package's signature; torch has no buffer donation, so
    it changes nothing (serving reports ``donated=False``)."""
    _check_call(plan, kernels, x)
    return _forward(plan, kernels, x, activation, _layer_conv)


def execute_looped(plan: NetworkPlan, kernels: Sequence[torch.Tensor],
                   x: torch.Tensor, *, activation=None) -> torch.Tensor:
    """One executor call per layer with the glue between — the JAX
    package's per-layer baseline.  Eager PyTorch dispatches
    :func:`execute_plan` the same way, so the two are one loop here."""
    _check_call(plan, kernels, x)
    return _forward(plan, kernels, x, activation, _layer_conv)


def execute_oracle(plan: NetworkPlan, kernels: Sequence[torch.Tensor],
                   x: torch.Tensor, *,
                   activation: Optional[Callable] = None) -> torch.Tensor:
    """``F.conv2d`` composed over the SAME compiled chain — the oracle
    the plan executors are cross-checked against (pruned channels must
    be zeroed in ``kernels``)."""
    _check_call(plan, kernels, x)
    return _forward(plan, kernels, x, activation, _oracle_conv)
