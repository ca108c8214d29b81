"""Batched serving driver: compiled-plan throughput (images/s, tokens/s).

Port of the fixed mode of ``repro/launch/serve_cnn.py``: map a benchmark
conv stack once — reusing a persistent on-disk mapping cache so a cold
replica skips the window search — compile the mapping into a
:class:`repro_torch.exec.NetworkPlan` (executor choice, schedule and glue
fixed at compile time), then drive steady-state forward passes through
``execute_plan`` on the card and report images/s.

:func:`serve` takes any NetworkMapping, including a transformer lowered
by ``launch.transformer.transformer_mapping`` (matmul layers with
explicit glue).  Its request row is a ``(d_model, seq, 1)`` frame of
token embeddings, and ``ServeStats.tokens_per_s`` reports
``batch * seq`` tokens per batch time beside images/s.  The CLI serves
the CNN benchmarks only, as in the JAX package, where transformers are
served through the fleet mode.

    python -m repro_torch.launch.serve_cnn --net cnn8 --batch 8 \
        --steps 20 --policy auto

Kernels and inputs are drawn from ``np.random.RandomState(--seed)`` in
the JAX package's order, so both packages serve the same weights and
images bit for bit.  Prints a ``serve/...`` CSV row
(``name,us_per_call,derived``) plus a human-readable summary.  Dynamic,
fleet and multi-replica serving, meshes and ``--autotune`` are not
ported yet.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import ArrayConfig, MacroGrid, grid_search, map_net, memo, networks
from ..device import DeviceLike, resolve_device, synchronize
from . import batching


def _parse_grid(text: str) -> MacroGrid:
    r, c = text.lower().split("x")
    return MacroGrid(int(r), int(c))


def map_for_serving(net: str, array: ArrayConfig, algorithm: str,
                    grid: MacroGrid = None, p_max: int = None,
                    groups=(1, 2, 4)):
    """Map ``net`` for serving (fixed grid or Alg 2 budget sweep) and
    return ``(mapping, search_seconds)``.  With a warm disk cache
    (``memo.set_disk_cache`` / ``REPRO_MAPPING_CACHE``) a cold process
    performs zero search-table builds."""
    layers = networks.NETWORKS[net]()
    kw = {"groups": groups} if algorithm == "TetrisG-SDK" else {}
    t0 = time.perf_counter()
    if p_max is not None:
        mapping = grid_search(net, layers, array, p_max, algorithm,
                              **kw).best
    else:
        mapping = map_net(net, layers, array, algorithm,
                          grid or MacroGrid(), **kw)
    return mapping, time.perf_counter() - t0


def _serving_kernels(net_mapping, seed: int, device: torch.device
                     ) -> Tuple[np.random.RandomState, List[torch.Tensor]]:
    """The serving kernels, drawn as the JAX package draws them: one
    ``randn * 0.1`` per layer in grouped HWIO layout, f32, pruned
    channels zeroed.  Returns the generator too: the input comes next."""
    from ..cnn.mapped_net import zero_pruned_kernels
    rng = np.random.RandomState(seed)
    ks = [torch.as_tensor(
        (rng.randn(m.layer.k_h, m.layer.k_w, m.layer.ic // m.group,
                   m.layer.oc) * 0.1).astype(np.float32), device=device)
        for m in net_mapping.layers]
    return rng, zero_pruned_kernels(net_mapping, ks)


def serving_inputs(net_mapping, batch: int, seed: int,
                   device: DeviceLike = None
                   ) -> Tuple[List[torch.Tensor], np.ndarray]:
    """(kernels on ``device``, host input batch) of a serving run — the
    JAX package's values for the same ``seed``.  A matmul layer's kernel
    is ``(1, 1, ic // G, oc)`` and a transformer's input
    ``(batch, d_model, seq, 1)``, drawn in the same order."""
    dev = resolve_device(device)
    rng, ks = _serving_kernels(net_mapping, seed, dev)
    first = net_mapping.layers[0].layer
    x = rng.randn(batch, first.ic, first.i_h, first.i_w).astype(np.float32)
    return ks, x


@dataclass
class ServeStats:
    """One steady-state measurement: effective rate counts the images
    the caller asked for; padded counts what the plan executed."""

    images_per_s: float         # request images / batch time (effective)
    padded_images_per_s: float  # plan-batch images / batch time
    s_per_batch: float
    request_batch: int
    plan_batch: int
    plan: object                # the NetworkPlan served from
    warmup_steps: int = 0       # warmup forwards actually executed
    donated: bool = False       # torch has no buffer donation
    #: request tokens / batch time for a lowered transformer (batch rows
    #: x ``tokens_per_row``); None for conv nets
    tokens_per_s: Optional[float] = None


def serve(net_mapping, batch: int, steps: int, warmup: int = 2,
          seed: int = 0, policy="mapped", block: Optional[str] = None,
          vmem_budget: Optional[int] = None,
          device: DeviceLike = None, inputs=None) -> ServeStats:
    """Steady-state batched forward passes through a compiled plan on
    ``device`` (default: the card).

    ``warmup`` is honored exactly, including 0; the count actually
    executed is reported in ``ServeStats.warmup_steps``.  ``block`` and
    ``vmem_budget`` reach the sdk layers (see `compile_plan`).
    ``inputs``, where given, must be the result of
    ``serving_inputs(net_mapping, batch, seed, device)`` with the same
    arguments; it is served instead of drawing it again (a full-width
    transformer's weights take seconds to draw).  Nothing checks that
    it was drawn for this net and seed beyond the plan's shape checks,
    and ``seed`` is then unused."""
    from ..exec import compile_plan, execute_plan
    from .transformer import tokens_per_row

    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    plan = compile_plan(net_mapping, executor_policy=policy, batch=batch,
                        device=dev, block=block, vmem_budget=vmem_budget)
    ks, x = inputs if inputs is not None else serving_inputs(
        net_mapping, batch, seed, dev)
    ring = batching.InputRing(x, device=dev)

    def step():
        y = execute_plan(plan, ks, ring.next())
        synchronize(dev)
        return y

    for _ in range(warmup):          # build the kernels, steady the caches
        step()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    dt = (time.perf_counter() - t0) / steps
    seq = tokens_per_row(net_mapping)
    return ServeStats(images_per_s=batch / dt, padded_images_per_s=batch / dt,
                      s_per_batch=dt, request_batch=batch, plan_batch=batch,
                      plan=plan, warmup_steps=warmup, donated=ring.donated,
                      tokens_per_s=None if seq is None else batch * seq / dt)


def main(argv=None) -> ServeStats:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="cnn8", choices=sorted(networks.NETWORKS))
    ap.add_argument("--alg", default="TetrisG-SDK")
    ap.add_argument("--ar", type=int, default=512)
    ap.add_argument("--ac", type=int, default=512)
    ap.add_argument("--grid", type=_parse_grid, default=None,
                    help="fixed macro grid RxC (default: 1x1)")
    ap.add_argument("--p-max", type=int, default=None,
                    help="Alg 2 macro-budget sweep instead of --grid")
    ap.add_argument("--batch", type=int, default=8, help="request batch")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2,
                    help="untimed warmup forwards; 0 is honored (timing "
                         "then includes the kernels' first build)")
    ap.add_argument("--policy", default="mapped",
                    choices=("mapped", "reference", "sdk", "auto"),
                    help="plan executor policy (per-layer for 'auto')")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent mapping/plan cache directory "
                         "(default: $REPRO_MAPPING_CACHE)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.cache_dir is not None:
        memo.set_disk_cache(args.cache_dir)

    mapping, search_s = map_for_serving(
        args.net, ArrayConfig(args.ar, args.ac), args.alg,
        grid=args.grid, p_max=args.p_max)
    # snapshot at the measurement boundary: serving traffic (plan-cache
    # lookups) must not leak into the search stats
    st = memo.snapshot()
    print(f"{args.net} [{args.alg}] grid={mapping.grid.r}x{mapping.grid.c} "
          f"total_cycles={mapping.total_cycles} search={search_s*1e3:.1f}ms "
          f"(table_builds={st['table_misses']} disk_hits={st['disk_hits']} "
          f"disk_writes={st['disk_writes']})")

    s = serve(mapping, args.batch, args.steps, warmup=args.warmup,
              seed=args.seed, policy=args.policy, device=dev)
    print(s.plan.describe())
    print(f"device={dev} batch={args.batch}: {s.images_per_s:.1f} images/s"
          f" ({s.s_per_batch*1e3:.3f} ms/batch, executor={args.policy}, "
          f"warmup_steps={s.warmup_steps}, donated={s.donated})")
    print(f"serve/{args.net}/b{args.batch},{s.s_per_batch*1e6:.1f},"
          f"images_per_s={s.images_per_s:.1f};"
          f"padded_images_per_s={s.padded_images_per_s:.1f};"
          f"plan_batch={s.plan_batch};"
          f"dispatches={s.plan.host_dispatches};mesh=none;"
          f"search_ms={search_s*1e3:.1f};table_builds={st['table_misses']};"
          f"disk_hits={st['disk_hits']}")
    return s


if __name__ == "__main__":
    main()
