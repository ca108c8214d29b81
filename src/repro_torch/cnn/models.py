"""Benchmark CNNs over parameter trees, NCHW (port of
``repro/cnn/models.py``).

The models consume the same ``ConvLayerSpec`` stacks the mapping layer
uses, so the trained network and the mapped network are structurally
identical.  ``group`` applies TetrisG grouped convolutions: every conv's
kernel takes the grouped layout ``(k, k, ic/G, oc)``.  Parameters are
leaf tensors with ``requires_grad``, in the JAX package's dict layout
(``convs[i].w/b``, ``head.w/b``), so weights carry across one to one
(`cnn.weights.params_from_numpy`).

Forward paths (``executor=``):
  * ``"reference"`` — ``F.conv2d`` (default without mappings)
  * ``"cim"``       — the placement-batched reference executor
    (cim_conv2d; default with mappings)
  * ``"mapped"``    — the macro-parallel executor (mapped_conv2d)
  * ``"sdk"``       — the sdk kernels (plain tiles on a CPU); forward
    only: the kernels have no backward (`kernels._build.no_backward`)

Every mapping-driven path resolves through a layerwise execution plan
(``compile_plan(chained=False)``) and `exec.run.apply_layer`: the model
owns the pooling, bias and activation between convs.  Remat segments of
that plan run under ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.types import ConvLayerSpec, LayerMapping, NetworkMapping
from ..exec import apply_layer, compile_plan
from .cim_conv import reference_conv2d

#: apply_cnn executor -> plan executor policy ("reference" stays the
#: plain F.conv2d path, outside any plan)
_PLAN_POLICY = {"cim": "reference", "mapped": "mapped", "sdk": "sdk"}


@dataclass(frozen=True)
class CNNConfig:
    name: str
    convs: Tuple[ConvLayerSpec, ...]      # padded specs, in order
    num_classes: int = 10
    group: int = 1                        # TetrisG grouping (1 = off)
    pool_after: Tuple[int, ...] = ()      # conv indices followed by 2x2 pool

    def grouped(self, g: int) -> "CNNConfig":
        for c in self.convs:
            if c.ic % g or c.oc % g:
                raise ValueError(f"{c.name} not divisible by G={g}")
        return CNNConfig(self.name + f"-g{g}", self.convs, self.num_classes,
                         g, self.pool_after)


def cnn8_config(in_size: int = 16, in_ch: int = 8, group: int = 1
                ) -> CNNConfig:
    """CNN8-shaped stack at a geometry a CPU trains: the paper's CNN8
    channel progression (24-32-32-64-64 after the stem), 3x3 convs."""
    s = in_size + 2
    convs = (
        ConvLayerSpec("c1", s, s, 3, 3, in_ch, 24),
        ConvLayerSpec("c2", s, s, 3, 3, 24, 32),
        ConvLayerSpec("c3", s, s, 3, 3, 32, 32),
        ConvLayerSpec("c4", s // 2 + 1, s // 2 + 1, 3, 3, 32, 64),
        ConvLayerSpec("c5", s // 2 + 1, s // 2 + 1, 3, 3, 64, 64),
    )
    return CNNConfig("cnn8", convs, group=group, pool_after=(2,))


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.requires_grad_(True)


def init_cnn(gen: torch.Generator, cfg: CNNConfig) -> Dict:
    """He-initialised conv kernels (grouped layout) and zero biases, drawn
    from ``gen`` on its device; the head is drawn later by
    :func:`ensure_head` from a seed taken here (``_head_key``)."""
    dev = gen.device
    params: Dict = {"convs": []}
    g = cfg.group
    for c in cfg.convs:
        fan_in = c.k_h * c.k_w * c.ic // g
        w = torch.randn((c.k_h, c.k_w, c.ic // g, c.oc), generator=gen,
                        device=dev) * math.sqrt(2.0 / fan_in)
        params["convs"].append({"w": _leaf(w),
                                "b": _leaf(torch.zeros(c.oc, device=dev))})
    params["head"] = None
    params["_head_key"] = (int(torch.randint(2 ** 62, (1,), generator=gen,
                                             device=dev)), dev)
    return params


def ensure_head(params: Dict, cfg: CNNConfig) -> Dict:
    """Draw the linear head (convs[-1].oc -> num_classes) if it is still
    missing, from the seed :func:`init_cnn` kept."""
    if params["head"] is None:
        d = cfg.convs[-1].oc
        seed, dev = params.pop("_head_key")
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        w = torch.randn((d, cfg.num_classes), generator=gen, device=dev)
        params["head"] = {
            "w": _leaf(w * math.sqrt(1.0 / d)),
            "b": _leaf(torch.zeros(cfg.num_classes, device=dev)),
        }
    params.pop("_head_key", None)
    return params


def _pad(x: torch.Tensor, target: int) -> torch.Tensor:
    pad = target - x.shape[-1]
    lo, hi = pad // 2, pad - pad // 2
    return F.pad(x, (lo, hi, lo, hi))


def apply_cnn(params: Dict, cfg: CNNConfig, x: torch.Tensor,
              mappings: Optional[Sequence[LayerMapping]] = None,
              executor: Optional[str] = None, mesh=None,
              remat=None) -> torch.Tensor:
    """x (b, in_ch, H, W) -> logits (b, num_classes).

    ``executor`` selects the conv path (module docstring); None resolves
    to "cim" when mappings are given, else "reference".  Mapping-driven
    executors compile a layerwise plan on ``x``'s device for this batch.
    ``remat`` asks its segment pass for checkpoint boundaries (any conv
    may end a segment) and runs each segment's convs and pooling under
    ``torch.utils.checkpoint`` — mapping-driven executors only: the
    ``F.conv2d`` path has no plan to segment.  ``mesh`` is an optional
    ("row", "col") or ("data", "row", "col") mesh for the mapped executor
    (`launch.mesh.make_macro_mesh`); the plan decides per layer whether
    it runs over it."""
    if executor is None:
        executor = "reference" if mappings is None else "cim"
    if executor not in ("reference", "cim", "mapped", "sdk"):
        raise ValueError(f"unknown executor {executor!r}")
    if executor != "reference" and mappings is None:
        raise ValueError(f"executor={executor!r} needs mappings")
    plan = None
    if executor != "reference":
        net = NetworkMapping(
            name=cfg.name, algorithm=mappings[0].algorithm,
            array=mappings[0].array, layers=tuple(mappings),
            grid=mappings[0].grid)
        plan = compile_plan(net, executor_policy=_PLAN_POLICY[executor],
                            mesh=mesh, batch=x.shape[0], device=x.device,
                            chained=False, remat=remat)
    elif remat is not None:
        raise ValueError("remat needs a mapping-driven executor — the "
                         "plan's segment pass owns the boundaries")
    head = params["head"]
    if head is None:
        raise ValueError("call ensure_head(params, cfg) first")

    def segment(lo, hi, x, *ws):
        for i in range(lo, hi):
            c = cfg.convs[i]
            x = _pad(x, c.i_w)
            w, b = ws[2 * (i - lo)], ws[2 * (i - lo) + 1]
            if plan is not None:
                y = apply_layer(plan, i, x, w, mesh=mesh)
            else:
                y = reference_conv2d(c, x, w, groups=cfg.group)
            x = F.relu(y + b[None, :, None, None])
            if i in cfg.pool_after:
                x = F.max_pool2d(x, 2, 2)
        return x

    spans = plan.spans if plan is not None else ((0, len(cfg.convs)),)
    remat_on = len(spans) > 1 and torch.is_grad_enabled()
    for lo, hi in spans:
        ws = [t for p in params["convs"][lo:hi] for t in (p["w"], p["b"])]
        body = functools.partial(segment, lo, hi)
        if remat_on:
            # the backward re-runs this conv slice from its boundary
            # carry instead of keeping every layer's saved tensors
            x = checkpoint(body, x, *ws, use_reentrant=False)
        else:
            x = body(x, *ws)
    feats = x.mean(dim=(2, 3))                        # GAP
    return feats @ head["w"] + head["b"]
