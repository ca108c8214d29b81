"""Execute a :class:`NetworkPlan` (port of ``repro/exec/run.py``).

PyTorch runs eagerly, so the forward is a Python loop over the planned
layers: each layer's glue is replayed around its planned executor —
spatial fit, the ``save`` stack, ``pre`` layernorm, the layer, its
``act``, the ``post`` attention stage, then the carry rule (chain,
concat, residual add).  While `repro_torch.tracing` records, the
forward, each layer, its executor call, its attention stage and each
glue stage are spans.
The JAX package's whole-forward ``jax.jit`` program and its lookahead
``_fence`` barrier (which only shaped XLA's schedule inside that
program) have no counterpart here; ``NetworkPlan.lookahead`` stays in
the IR and is inert.  Capturing the forward in a CUDA graph is later
work.  Torch has no input-buffer donation: ``donate`` is accepted and
changes nothing, and :func:`donation_supported` is False.

A plan with remat segments runs each segment under
``torch.utils.checkpoint`` when autograd records the forward: the
backward recomputes a segment from its boundary carry instead of
keeping every layer's saved tensors (exec/memory.py prices both).

`apply_layer` runs ONE layer of a (possibly layerwise) plan — the
`cnn.models.apply_cnn` path, which owns the pooling, bias and
activation between convs — and `execute_layerwise` runs every layer of
a plan on its own input.

Every entry point takes the live ``mesh`` (`launch.mesh.Mesh`) a plan
was compiled for: the mapped layers whose ``LayerPlan.use_mesh`` the
compiler set run their super-steps over it (`cnn.mapped_net`), the
others ignore it.  A plan compiled on a mesh refuses a call without
that mesh's shape, and the reverse.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..cnn.cim_conv import cim_conv2d, reference_conv2d
from ..cnn.mapped_net import mapped_conv2d
from ..kernels._build import needs_backward
from ..kernels.matmul_exec import matmul_layer, matmul_layer_ref
from ..kernels.sdk_conv import sdk_conv, sdk_placed
from .glue import (ACTIVATIONS, attention_stage, center_crop, fit_spatial,
                   layernorm)
from ..launch.mesh import check_mesh
from .plan import LayerPlan, NetworkPlan, mesh_axes

ConvFn = Callable[..., torch.Tensor]


def _layer_conv(lp: LayerPlan, x: torch.Tensor, kernel: torch.Tensor,
                weights=None, *, mesh=None) -> torch.Tensor:
    """Dispatch one layer to its planned executor.  ``weights`` is the
    layer's entry of `PlanConstants.weights` (None: none prepared);
    ``mesh`` reaches the mapped executor where the plan said so.  The
    ``reference`` executor runs its window list on the card's
    `sdk_placed` kernel when x is on CUDA and autograd would not
    differentiate the call, else `cim_conv2d`: on the CPU, and in
    training, where the card counts it in ``sdk_placed.fallbacks``."""
    m = lp.mapping
    if lp.executor == "mapped":
        return mapped_conv2d(m, x, kernel, weights=weights,
                             mesh=mesh if lp.use_mesh else None)
    if lp.executor == "sdk":
        return sdk_conv(m, x, kernel, block=lp.block,
                        vmem_budget=lp.vmem_budget)
    if lp.executor == "matmul":
        return matmul_layer(m, x, kernel)
    if x.device.type == "cuda":
        if not needs_backward(x, kernel):
            return sdk_placed(m, x, kernel)
        sdk_placed.fallbacks += 1
    return cim_conv2d(m, x, kernel)


def _oracle_conv(lp: LayerPlan, x: torch.Tensor, kernel: torch.Tensor,
                 weights=None) -> torch.Tensor:
    """The plain function of a layer: the einsum of a matmul layer,
    ``F.conv2d`` of a conv layer."""
    if getattr(lp.mapping.layer, "op", "conv") == "matmul":
        return matmul_layer_ref(lp.mapping, x, kernel)
    return reference_conv2d(lp.mapping.layer, x, kernel,
                            groups=lp.mapping.group)


def _segment(plan: NetworkPlan, s: int, e: int, activation, conv: ConvFn,
             plain: bool, consts, x: torch.Tensor, *kernels: torch.Tensor
             ) -> torch.Tensor:
    """Layers [s, e) of the planned chain on carry ``x``; ``kernels`` are
    theirs, ``consts`` (None or `PlanConstants.weights`) the whole
    plan's.  Glue kinds were classified at compile time (exec/glue.py);
    this only replays them.  The saved-residual stack is segment-local:
    the segment pass cuts only where it is empty (exec/remat.py)."""
    # with explicit glue (transformer lowerings) the glue owns every
    # nonlinearity — the network-global activation applies only to
    # inferred-glue (CNN) plans, where no GlueSpec.act is ever set
    explicit = plan.net.glue is not None
    saved = []                      # GlueSpec.save stack (residual bases)
    begin, end = tracing.begin, tracing.end
    for i, (lp, k) in enumerate(zip(plan.layers[s:e], kernels), s):
        lay = lp.mapping.layer
        spec = lp.glue
        span = begin("layer", lay.name, lp.executor)
        stage = begin("glue", "fit")
        xp = fit_spatial(x, lay.i_h, lay.i_w)
        end(stage)
        if spec.save:               # residual base: the pre-norm input
            saved.append(xp)
        xin = xp
        if spec.pre == "layernorm":
            stage = begin("glue", "layernorm")
            xin = layernorm(xp)
            end(stage)
        stage = begin("exec", lp.executor)
        y = conv(lp, xin, k, None if consts is None else consts[i])
        end(stage)
        act = (ACTIVATIONS[spec.act] if spec.act != "none"
               else None if explicit else activation)
        if act is not None:
            stage = begin("glue", "act")
            y = act(y)
            end(stage)
        if spec.post == "attention":
            stage = begin("attention", "attention")
            y = attention_stage(y, spec.heads, spec.causal, plain=plain)
            end(stage)
        if spec.kind == "concat":
            stage = begin("glue", "carry")
            skip = center_crop(xp, y.shape[-2], y.shape[-1])
            x = torch.cat([skip, y], dim=1)
            end(stage)
        elif spec.kind == "residual":
            stage = begin("glue", "carry")
            x = saved.pop() + y     # channel match checked at compile
            end(stage)
        else:                       # "chain" / "last"
            x = y
        end(span)
    return x


def _forward(plan: NetworkPlan, kernels: Sequence[torch.Tensor],
             x: torch.Tensor, activation, conv: ConvFn,
             plain: bool = False, remat: bool = False,
             consts=None) -> torch.Tensor:
    """The planned forward chain.  With ``remat`` and more than one plan
    span, each span runs under ``torch.utils.checkpoint`` while autograd
    records; otherwise the whole chain runs as one segment.  ``plain``
    runs the attention stage on its plain softmax version (the
    oracle)."""
    opened = tracing.begin("forward", plan.net.name)
    try:
        spans = plan.spans
        if not (remat and len(spans) > 1 and torch.is_grad_enabled()):
            return _segment(plan, 0, len(plan.layers), activation, conv,
                            plain, consts, x, *kernels)
        for s, e in spans:
            body = functools.partial(_segment, plan, s, e, activation, conv,
                                     plain, consts)
            x = checkpoint(body, x, *kernels[s:e], use_reentrant=False)
        return x
    finally:
        tracing.end(opened)


def donation_supported(mesh=None) -> bool:
    """Whether the plan's inputs can be donated to the forward: never —
    torch has no input-buffer donation (the JAX package donates on an
    accelerator), with or without a mesh."""
    return False


def _check_mesh(plan: NetworkPlan, mesh) -> None:
    """The live mesh must have the plan's compile-mesh shape (None for a
    plan compiled without one)."""
    check_mesh(mesh)
    axes = mesh_axes(mesh)
    if axes != plan.mesh_axes:
        raise ValueError(
            f"mesh {axes} does not match the plan's compile mesh "
            f"{plan.mesh_axes} — recompile the plan for this mesh")


def _check_call(plan: NetworkPlan, kernels, x: torch.Tensor,
                mesh=None, *, with_mesh: bool = True) -> None:
    if not plan.chained:
        raise ValueError(
            "execute_plan needs a chained plan; this one was compiled "
            "with chained=False (per-layer dispatch via apply_layer)")
    if len(kernels) != len(plan.layers):
        raise ValueError(f"{len(kernels)} kernels for "
                         f"{len(plan.layers)} planned layers")
    if with_mesh:
        _check_mesh(plan, mesh)
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
                 x: torch.Tensor, *, mesh=None, activation=None,
                 donate: bool = False, constants=None) -> torch.Tensor:
    """Run the planned forward on the plan's device.

    ``kernels[i]`` is layer i's kernel in grouped HWIO layout, ``x`` the
    (batch, ic, i_h, i_w) input; both must lie on the plan's device, and
    so does the output.  ``mesh`` is the live mesh matching
    ``plan.mesh_axes`` (None for a plan compiled without one).
    ``activation`` applies after every layer of an inferred-glue (CNN)
    plan; explicit glue (transformer lowerings) owns its nonlinearities
    and ignores it.  ``donate`` is accepted
    for the JAX package's signature; torch has no buffer donation, so
    it changes nothing (serving reports ``donated=False``).  A plan with
    remat segments checkpoints each segment when autograd records.
    ``constants`` is a shared `exec.constants.PlanConstants` handle for
    this plan's network: its pre-materialized shifted-weight blocks feed
    the mapped layers in place of their in-forward weight prep
    (``prepare_constants``)."""
    _check_call(plan, kernels, x, mesh)
    consts = None
    if constants is not None:
        if constants.net != plan.net:
            raise ValueError("constants were prepared for a different "
                             "network mapping than this plan")
        if constants.executors != plan.executors:
            raise ValueError(
                f"constants were prepared for executors "
                f"{constants.executors}, plan resolved {plan.executors}")
        if len(constants.weights) != len(plan.layers):
            raise ValueError(f"{len(constants.weights)} constant entries "
                             f"for {len(plan.layers)} planned layers")
        consts = constants.weights
    return _forward(plan, kernels, x, activation,
                    functools.partial(_layer_conv, mesh=mesh), remat=True,
                    consts=consts)


def execute_looped(plan: NetworkPlan, kernels: Sequence[torch.Tensor],
                   x: torch.Tensor, *, mesh=None,
                   activation=None) -> torch.Tensor:
    """One executor call per layer with the glue between — the JAX
    package's per-layer baseline.  Eager PyTorch dispatches
    :func:`execute_plan` the same way, so the two are one loop here."""
    _check_call(plan, kernels, x, mesh)
    return _forward(plan, kernels, x, activation,
                    functools.partial(_layer_conv, mesh=mesh))


def execute_oracle(plan: NetworkPlan, kernels: Sequence[torch.Tensor],
                   x: torch.Tensor, *,
                   activation: Optional[Callable] = None) -> torch.Tensor:
    """Plain functions composed over the SAME compiled chain — the oracle
    the plan executors are cross-checked against: ``F.conv2d`` for conv
    layers, `matmul_layer_ref` for matmul layers and
    `flash_attention_ref` for every attention stage; no kernel wrapper
    is called (pruned channels must be zeroed in ``kernels``).  It takes
    no mesh: the oracle runs every layer on ``x``'s device, whatever mesh
    the plan was compiled for."""
    if not plan.chained:
        raise ValueError("execute_oracle needs a chained plan")
    _check_call(plan, kernels, x, with_mesh=False)
    return _forward(plan, kernels, x, activation, _oracle_conv, plain=True)


def apply_layer(plan: NetworkPlan, i: int, x: torch.Tensor,
                kernel: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """Execute layer ``i`` of the plan on its own — the `apply_cnn`
    path, where pooling / bias / activation between convs belong to the
    model, not the plan."""
    _check_mesh(plan, mesh)
    return _layer_conv(plan.layers[i], x, kernel, mesh=mesh)


def execute_layerwise(plan: NetworkPlan, kernels: Sequence[torch.Tensor],
                      xs: Sequence[torch.Tensor], *,
                      mesh=None) -> Tuple[torch.Tensor, ...]:
    """Every layer on its OWN input — a layer set that does not chain
    (several bench networks are representative layer sets).  One
    executor call per layer, as :func:`apply_layer` in a loop."""
    if len(kernels) != len(plan.layers) or len(xs) != len(plan.layers):
        raise ValueError(f"{len(kernels)} kernels / {len(xs)} inputs for "
                         f"{len(plan.layers)} planned layers")
    _check_mesh(plan, mesh)
    return tuple(_layer_conv(lp, x, k, mesh=mesh)
                 for lp, k, x in zip(plan.layers, kernels, xs))
