"""Training through the mapping IR (port of ``repro/cnn/train.py``):
the Table II proxy and the plan trainer.

MNIST/CIFAR/TinyImageNet are not available offline; the claim under
test — grouped convolutions are near-lossless — is checked on a seeded
synthetic image-classification task (:mod:`repro_torch.data`): the
CNN8-shaped stack with G in {1, 2, 4} under identical budgets.
``executor="mapped"`` (or "cim") trains through the mapping-driven
executors: every conv of every step runs as its ``LayerMapping``
prescribes, through a layerwise plan (`cnn.models.apply_cnn`).

Both trainers share the step:

* the **optimizer** is `optim.adamw` with :data:`ADAM` (plain Adam: no
  decay, no clipping), bit-identical to a hand-rolled Adam;
* **gradient accumulation**: ``accum`` microbatches per optimizer step,
  each one's masked per-example loss SUM differentiated on its own; the
  summed loss and gradients are divided by the *valid* example count
  once — so accumulation and padding change the gradient by no more
  than f32 summation order;
* **pad-and-mask**: a ragged tail batch is padded to the step's
  ``(accum, microbatch)`` shape with zero-weight masks;
* **the mesh**: with a ``mesh`` bound, the microbatch pads up to the
  mesh's data axis (`launch.mesh.pad_to_data_axis`; plans refuse a
  batch the data axis does not divide), so ``batch`` becomes
  ``accum x padded microbatch`` and the mapped layers run over the mesh.

`train_plan` trains the kernels of a **chained** NetworkMapping (and a
linear head on the pooled features) through `execute_plan`, with
``remat`` segments from the plan's memory model (exec/memory.py,
exec/remat.py) run under ``torch.utils.checkpoint``.  When
``REPRO_TRAIN_MEM_BUDGET`` is set, a plan whose peak estimate exceeds it
refuses to train before any device work; ``remat="auto"`` segments
under that budget and trains.  Plans with ``sdk`` or ``matmul`` layers
are refused: those kernels have no backward, here or in the reference.

Initial parameters and data come from :func:`_draws`, from a CPU
``torch.Generator`` seeded with ``seed`` and moved to the device, so a
run on the card and one on the CPU start from the same values.  The JAX
package draws from ``jax.random``, which torch cannot replay; the
parity tests replace :func:`_draws` with the reference's draws.
Torch has no buffer donation (``donated`` is always False).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from ..core.grouped import tetrisg_layer
from ..core.types import ArrayConfig, LayerMapping, MacroGrid, NetworkMapping
from ..data.synthetic import image_task
from ..device import DeviceLike, resolve_device, synchronize
from ..exec import compile_plan, donation_supported, execute_plan
from ..exec.remat import ENV_BUDGET
from ..launch.mesh import check_mesh, pad_to_data_axis
from ..optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                           tree_leaves, tree_map, tree_unflatten)
from .mapped_net import zero_pruned_kernels
from .models import CNNConfig, apply_cnn, ensure_head, init_cnn

#: Plain Adam via the shared AdamW module: decay and clipping off.  With
#: these settings `adamw_update` is bit-identical to the classic
#: ``p - lr*mh/(sqrt(vh)+eps)`` update.
ADAM = AdamWConfig(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                   grad_clip=float("inf"))


@dataclass
class TrainResult:
    config: str
    group: int
    steps: int
    final_loss: float
    train_acc: float
    test_acc: float
    executor: str = "reference"


@dataclass
class PlanTrainResult:
    """`train_plan` outcome + the memory-model facts beside it."""
    name: str
    steps: int
    batch: int
    accum: int
    final_loss: float
    first_loss: float
    peak_mb: float              # estimate of the plan as segmented
    unremat_peak_mb: float      # estimate with remat off
    segments: int
    donated: bool


def train_mappings(cfg: CNNConfig, array: ArrayConfig,
                   grid: MacroGrid = MacroGrid()
                   ) -> Tuple[LayerMapping, ...]:
    """Per-conv TetrisG mappings pinned to the config's grouping factor,
    so each mapping's group matches the trained kernels' grouped layout
    ``(k, k, ic/G, oc)``."""
    return tuple(tetrisg_layer(c, array, grid, groups=(cfg.group,))
                 for c in cfg.convs)


def _per_example_nll(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]


def loss_fn(params, cfg: CNNConfig, x, y, mappings=None, executor=None):
    logits = apply_cnn(params, cfg, x, mappings=mappings, executor=executor)
    return _per_example_nll(logits, y).mean()


def _pad_and_mask(x: torch.Tensor, y: torch.Tensor, batch: int):
    """Pad a (possibly ragged) tail batch to ``batch`` examples with a
    0/1 validity mask — the step sees ONE shape."""
    k = x.shape[0]
    mask = torch.ones((k,), dtype=torch.float32, device=x.device)
    if k < batch:
        pad = batch - k
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        y = torch.cat([y, y.new_zeros((pad,))])
        mask = torch.cat([mask, mask.new_zeros((pad,))])
    return x, y, mask


def _accum_grads(loss_sum_fn: Callable, params, xb, yb, mask):
    """Differentiate each of the ``accum`` microbatches' masked loss SUM
    on its own and add up losses and gradients; divide by the valid
    count once at the end — gradients are those of the unpadded
    whole-batch mean up to f32 summation order, and padded rows add
    exact zeros.

    ``loss_sum_fn(params, x, y, mask) -> masked per-example SUM``;
    ``xb``/``yb``/``mask`` are (accum, microbatch, ...)."""
    leaves = tree_leaves(params)
    lsum = torch.zeros((), dtype=torch.float32, device=mask.device)
    gsum = [torch.zeros_like(p) for p in leaves]
    for a in range(xb.shape[0]):
        lv = loss_sum_fn(params, xb[a], yb[a], mask[a])
        grads = torch.autograd.grad(lv, leaves)
        lsum = lsum + lv.detach()
        gsum = [s + g for s, g in zip(gsum, grads)]
    count = mask.sum()
    return lsum / count, tree_unflatten(params, [g / count for g in gsum])


def _make_step(loss_sum_fn: Callable, lr: float):
    """The shared optimizer step: accumulate, then Adam."""

    def step(params, opt, xb, yb, mask):
        loss, grads = _accum_grads(loss_sum_fn, params, xb, yb, mask)
        params, opt, _ = adamw_update(params, grads, opt, lr, ADAM)
        return tree_map(lambda p: p.requires_grad_(True), params), opt, loss

    return step


def _microbatched(x, y, mask, accum: int):
    mb = x.shape[0] // accum
    return (x.reshape((accum, mb) + tuple(x.shape[1:])),
            y.reshape((accum, mb)),
            mask.reshape((accum, mb)))


def _check_accum(accum: int, batch: int) -> None:
    if accum < 1 or batch % accum:
        raise ValueError(f"accum={accum} must divide batch={batch}")


def _step_batch(batch: int, accum: int, mesh) -> Tuple[int, int]:
    """(microbatch, batch) of the compiled step: the microbatch pads up
    to the mesh's data axis when a mesh is bound."""
    _check_accum(accum, batch)
    check_mesh(mesh)
    micro = pad_to_data_axis(batch // accum, mesh)
    return micro, micro * accum


def _draws(kind: str, seed: int, device: torch.device, **kw):
    """The trainers' one source of randomness: initial parameters and
    data from a CPU ``torch.Generator`` seeded with ``seed``, moved to
    ``device``.  ``kind="cnn"`` (``cfg``, ``n_train``, ``n_test``) gives
    ``(params, (xs, ys, xt, yt))`` for `train_cnn`; ``kind="plan"``
    (``net``, ``n_train``, ``num_classes``, ``out_c``) gives ``(params,
    (xs, ys))`` for `train_plan`."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    if kind == "cnn":
        cfg = kw["cfg"]
        data = image_task(gen, n_train=kw["n_train"], n_test=kw["n_test"],
                          size=cfg.convs[0].i_w - 2,
                          channels=cfg.convs[0].ic,
                          num_classes=cfg.num_classes)
        params = ensure_head(init_cnn(gen, cfg), cfg)
    else:
        net, nc, out_c = kw["net"], kw["num_classes"], kw["out_c"]
        first = net.layers[0].layer
        data = image_task(gen, n_train=kw["n_train"], n_test=1,
                          size=max(4, first.i_w - 2), channels=first.ic,
                          num_classes=nc)[:2]
        head = torch.randn((out_c, nc), generator=gen) * (1.0 / out_c) ** 0.5
        params = {"kernels": init_plan_kernels(net, gen), "head": head}
    params = tree_map(lambda p: p.detach().to(device).requires_grad_(True),
                      params)
    return params, tuple(t.to(device) for t in data)


def train_cnn(cfg: CNNConfig, *, steps: int = 300, batch: int = 64,
              lr: float = 3e-3, seed: int = 0,
              n_train: int = 2048, n_test: int = 512,
              executor: str = "reference",
              array: Optional[ArrayConfig] = None,
              grid: MacroGrid = MacroGrid(),
              accum: int = 1, remat=None, mesh=None,
              device: DeviceLike = None) -> TrainResult:
    """The Table II accuracy study trainer (module docstring) on
    ``device`` (default: the card).

    ``accum`` splits each ``batch`` into that many microbatches per
    optimizer step (``batch % accum == 0``); ``remat`` forwards to the
    layerwise plan's segment pass (mapping-driven executors only);
    ``mesh`` runs the mapped layers of the loss over it, each microbatch
    padded to its data axis."""
    _, batch = _step_batch(batch, accum, mesh)
    dev = resolve_device(device)
    params, (xs, ys, xt, yt) = _draws("cnn", seed, dev, cfg=cfg,
                                      n_train=n_train, n_test=n_test)
    mappings = None
    if executor != "reference":
        mappings = train_mappings(cfg, array or ArrayConfig(512, 512), grid)

    def loss_sum(params, x, y, mask):
        logits = apply_cnn(params, cfg, x, mappings=mappings,
                           executor=executor, mesh=mesh, remat=remat)
        return (_per_example_nll(logits, y) * mask).sum()

    step = _make_step(loss_sum, lr)
    opt = adamw_init(params)
    n = xs.shape[0]
    loss = float("nan")
    for i in range(steps):
        lo = (i * batch) % max(1, n - batch)
        xb, yb, mask = _pad_and_mask(xs[lo:lo + batch], ys[lo:lo + batch],
                                     batch)
        params, opt, lval = step(params, opt,
                                 *_microbatched(xb, yb, mask, accum))
        loss = float(lval)

    @torch.no_grad()
    def acc(x, y):
        logits = apply_cnn(params, cfg, x, mappings=mappings,
                           executor=executor)
        return float((logits.argmax(-1) == y).float().mean())

    return TrainResult(
        config=cfg.name, group=cfg.group, steps=steps, final_loss=loss,
        train_acc=acc(xs[:n_test], ys[:n_test]), test_acc=acc(xt, yt),
        executor=executor)


def init_plan_kernels(net: NetworkMapping, gen: torch.Generator) -> list:
    """He-init kernels in the executor layout ``(k_h, k_w, ic/G, oc)``,
    drawn from ``gen`` on its device, pruned channels zeroed to match
    the mapping."""
    ks = []
    for m in net.layers:
        c = m.layer
        fan_in = c.k_h * c.k_w * c.ic // m.group
        ks.append(torch.randn((c.k_h, c.k_w, c.ic // m.group, c.oc),
                              generator=gen, device=gen.device)
                  * (2.0 / fan_in) ** 0.5)
    return zero_pruned_kernels(net, ks)


@dataclass
class PlanTraining:
    """What `train_plan` trains: the compiled plan, the initial
    parameters ``{"kernels", "head"}``, the data and the masked loss sum
    of a microbatch."""
    plan: object                # NetworkPlan
    params: dict
    xs: torch.Tensor
    ys: torch.Tensor
    batch: int
    accum: int
    loss_sum: Callable

    def batch_at(self, i: int):
        """Step ``i``'s (x, y, mask), each (accum, microbatch, ...)."""
        n, batch = self.xs.shape[0], self.batch
        lo = (i * batch) % max(1, n - batch)
        xb, yb, mask = _pad_and_mask(self.xs[lo:lo + batch],
                                     self.ys[lo:lo + batch], batch)
        return _microbatched(xb, yb, mask, self.accum)


def plan_training(net: NetworkMapping, *, batch: int = 8, seed: int = 0,
                  accum: int = 1, remat=None, executor_policy="reference",
                  mesh=None, num_classes: int = 10, n_train: int = 256,
                  device: DeviceLike = None) -> PlanTraining:
    """Compile ``net`` for training on ``device`` (over ``mesh``, each
    microbatch padded to its data axis) and draw its initial parameters
    and data — `train_plan`'s set-up, before any step.  Raises
    ValueError for a plan with ``sdk`` or ``matmul`` layers and
    MemoryError when the plan's peak estimate exceeds
    ``REPRO_TRAIN_MEM_BUDGET``."""
    micro, batch = _step_batch(batch, accum, mesh)
    dev = resolve_device(device)
    plan = compile_plan(net, executor_policy=executor_policy, mesh=mesh,
                        batch=micro, remat=remat, device=dev)
    no_grad = [f"{lp.mapping.layer.name}:{lp.executor}"
               for lp in plan.layers if lp.executor in ("sdk", "matmul")]
    if no_grad:
        raise ValueError(
            f"{net.name}: layers {no_grad} resolved to kernels with no "
            f"backward (neither has the reference's); train through the "
            f"'reference' or 'mapped' executors")
    budget = os.environ.get(ENV_BUDGET)
    if budget and plan.peak_bytes > int(budget):
        raise MemoryError(
            f"{net.name}: plan peak estimate {plan.peak_bytes / 1e6:.1f}MB "
            f"exceeds {ENV_BUDGET}={int(budget) / 1e6:.1f}MB "
            f"(remat={remat!r}, {len(plan.spans)} segment(s)) — compile "
            f"with remat='auto' or a byte budget to segment under it")
    last = plan.layers[-1]
    out_c = last.mapping.layer.oc
    if last.glue.kind == "concat":      # DenseNet: carry + final output
        out_c += last.carry_c
    params, (xs, ys) = _draws("plan", seed, dev, net=net, n_train=n_train,
                              num_classes=num_classes, out_c=out_c)

    def loss_sum(params, x, y, mask):
        feats = execute_plan(plan, params["kernels"], x, mesh=mesh,
                             activation=torch.relu).mean(dim=(2, 3))
        per = _per_example_nll(feats @ params["head"], y)
        return (per * mask).sum()

    return PlanTraining(plan=plan, params=params, xs=xs, ys=ys, batch=batch,
                        accum=accum, loss_sum=loss_sum)


def train_plan(net: NetworkMapping, *, steps: int = 10, batch: int = 8,
               lr: float = 1e-3, seed: int = 0, accum: int = 1,
               remat=None, executor_policy="reference", mesh=None,
               num_classes: int = 10, n_train: int = 256,
               losses: Optional[list] = None,
               step_times: Optional[list] = None,
               device: DeviceLike = None) -> PlanTrainResult:
    """Train a chained NetworkMapping's kernels (+ a linear head on the
    pooled features) through `execute_plan` on ``device`` (default: the
    card), with ``remat`` segments under ``torch.utils.checkpoint`` and
    the mapped layers over ``mesh`` (module docstring; set-up and
    refusals in :func:`plan_training`).  The result's ``batch`` is the
    step's batch, padded as the mesh needs.
    Pass a list as ``losses`` to collect the per-step loss, and/or one as
    ``step_times`` for per-step wall seconds, each taken after a device
    synchronise (the first includes the warm-up)."""
    tr = plan_training(net, batch=batch, seed=seed, accum=accum,
                       remat=remat, executor_policy=executor_policy,
                       mesh=mesh, num_classes=num_classes, n_train=n_train,
                       device=device)
    dev = tr.xs.device
    step = _make_step(tr.loss_sum, lr)
    params, opt = tr.params, adamw_init(tr.params)
    loss = first_loss = float("nan")
    for i in range(steps):
        xb, yb, mask = tr.batch_at(i)
        t0 = time.perf_counter()
        params, opt, lval = step(params, opt, xb, yb, mask)
        synchronize(dev)
        loss = float(lval)
        if step_times is not None:
            step_times.append(time.perf_counter() - t0)
        if i == 0:
            first_loss = loss
        if losses is not None:
            losses.append(loss)
    plan = tr.plan
    return PlanTrainResult(
        name=net.name, steps=steps, batch=tr.batch, accum=accum,
        final_loss=loss, first_loss=first_loss,
        peak_mb=plan.peak_bytes / 1e6,
        unremat_peak_mb=plan.unremat_peak_bytes / 1e6,
        segments=len(plan.spans), donated=donation_supported(mesh))
