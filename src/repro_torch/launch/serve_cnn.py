"""Batched serving driver: compiled-plan throughput (images/s, tokens/s).

Port of ``repro/launch/serve_cnn.py``: map a benchmark conv stack once —
reusing a persistent on-disk mapping cache so a cold replica skips the
window search — compile the mapping into
:class:`repro_torch.exec.NetworkPlan` objects (executor choice,
schedule and glue fixed at compile time), then drive forward passes through
``execute_plan`` on the card.  Four serving modes:

* **fixed** (:func:`serve`) — every step serves one fixed request batch.
  It takes any NetworkMapping, including a transformer lowered by
  ``launch.transformer.transformer_mapping``, whose request row is a
  ``(d_model, seq, 1)`` frame of token embeddings;
  ``ServeStats.tokens_per_s`` reports ``batch * seq`` tokens per batch
  time beside images/s.
* **dynamic** (:func:`serve_dynamic`, ``--max-delay-ms``) — ragged
  Poisson arrivals (:func:`poisson_arrivals`) drain through a max-delay
  coalescer (`launch/batching.py`) into the smallest tier of a
  power-of-two plan ladder; the padded rows are zero and dropped
  (pad-and-mask).  Per-tier effective vs padded images/s and queue-delay
  percentiles are reported.
* **fleet** (``--fleet cnn8,inception,densenet40``) — several networks
  share the card under mixed Poisson traffic: per-model coalescers and
  plan ladders behind a cross-model drain policy, with prepared
  shifted-weight constants shared across each network's tiers
  (`launch/fleet.py`).  Names resolve against the conv benchmarks and
  the transformer lowerings (``whisper_smoke``, ``stablelm_smoke``); a
  layer set such as inception serves as its chainable prefix.
* **multi-replica** (``--replicas N``) — N spawned worker processes,
  each with its own CUDA context and plan ladder, behind a least-loaded
  router with heartbeat recovery (`launch/replica.py`).

    python -m repro_torch.launch.serve_cnn --net cnn8 --batch 8 \
        --steps 20 --policy auto
    python -m repro_torch.launch.serve_cnn --net cnn8 --policy auto \
        --max-batch 8 --max-delay-ms 2 --max-request 4 --requests 64 \
        --arrival-rate 500
    python -m repro_torch.launch.serve_cnn --policy auto \
        --fleet cnn8,inception,densenet40 --max-batch 4 \
        --max-delay-ms 2 --requests 48 --arrival-rate 200 --slo-ms 50
    python -m repro_torch.launch.serve_cnn --net cnn8 --policy auto \
        --replicas 2 --max-batch 4 --max-delay-ms 2 --requests 48 \
        --cache-dir /tmp/mapping-cache

Kernels and inputs are drawn from ``np.random.RandomState(--seed)`` in
the JAX package's order, so both packages serve the same weights and
images bit for bit.  Each mode prints the JAX package's CSV rows
(``name,us_per_call,derived``: ``serve/...``, ``serve_dyn/...``,
``serve_fleet/...``, ``serve_replica/...``) plus a human-readable
summary.  ``--autotune`` runs the measured-feedback autotuner
(`repro_torch.tune`) for this net, the device's fleet and the batch
profile first — instant with a warm ``--cache-dir`` — then serves the
winner's full config; ``--policy tuned`` serves a persisted winner
without searching (the ``auto`` executors when nothing was tuned), in
every mode.  ``--no-donate`` is accepted and changes nothing (torch has
no buffer donation).  Not ported: ``--no-mesh`` and
``--worker-devices`` (the port has no mesh).

    python -m repro_torch.launch.serve_cnn --net cnn8 --batch 8 \
        --autotune --cache-dir /tmp/mapping-cache
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

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
          seed: int = 0, policy="mapped", lookahead: Optional[int] = None,
          block: Optional[str] = None,
          vmem_budget: Optional[int] = None,
          device: DeviceLike = None, inputs=None) -> ServeStats:
    """Steady-state batched forward passes through a compiled plan on
    ``device`` (default: the card).

    ``warmup`` is honored exactly, including 0; the count actually
    executed is reported in ``ServeStats.warmup_steps``.  ``lookahead``,
    ``block`` and ``vmem_budget`` reach the plan (see `compile_plan`;
    left unset, ``policy="tuned"`` fills them from the winner).
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
                        device=dev, lookahead=lookahead, block=block,
                        vmem_budget=vmem_budget)
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


def poisson_arrivals(n: int, rate_per_s: float, max_rows: int,
                     seed: int = 0) -> Tuple[Tuple[float, int], ...]:
    """A synthetic ragged arrival schedule: ``n`` requests with
    exponential inter-arrival times at ``rate_per_s`` (0 → a fully
    backlogged queue, everything arrives at t=0) and uniform ragged
    sizes in [1, max_rows] — the JAX package's schedule for the same
    seed."""
    if n < 1:
        raise ValueError(f"need >= 1 request, got {n}")
    if max_rows < 1:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}")
    rng = np.random.RandomState(seed)
    if rate_per_s > 0:
        gaps = rng.exponential(1.0 / rate_per_s, size=n)
        times = np.cumsum(gaps) - gaps[0]       # first request at t=0
    else:
        times = np.zeros(n)
    rows = rng.randint(1, max_rows + 1, size=n)
    return tuple((float(t), int(r)) for t, r in zip(times, rows))


def serve_dynamic(net_mapping, requests: Sequence[Tuple[float, int]], *,
                  max_batch: int, max_delay_ms: float,
                  tiers: Optional[Sequence[int]] = None,
                  policy="mapped", warmup: int = 1, seed: int = 0,
                  adaptive_delay: bool = False,
                  lookahead: Optional[int] = None,
                  block: Optional[str] = None,
                  vmem_budget: Optional[int] = None,
                  device: DeviceLike = None,
                  clock=time.perf_counter,
                  sleep=time.sleep) -> batching.DynamicServeStats:
    """Arrival-driven serving through the plan ladder on ``device``
    (default: the card).

    ``requests`` is a schedule of ``(arrival_s, rows)`` pairs (seconds
    relative to measurement start, e.g. :func:`poisson_arrivals`).  The
    loop pushes each arrival into a max-delay :class:`batching.Coalescer`
    as its time comes, sleeps only until the next arrival or the oldest
    request's delay deadline, and serves every coalesced batch through
    the smallest ladder tier that fits: the batch is uploaded as one
    host array whose spare rows are zero, and the output rows past the
    request rows are dropped (pad-and-mask).  Once no future arrival
    remains the queue is force-drained.  Each batch ends in a device
    synchronize, so ``TierStats.exec_s`` holds the device's work.

    ``warmup`` forwards per tier run before the clock starts (0 honored:
    the kernels' first load then lands in the measurement).
    ``adaptive_delay`` swaps the fixed coalescing delay for the
    load-proportional `batching.AdaptiveDelay` policy.  ``lookahead``,
    ``block`` and ``vmem_budget`` reach every tier's plan (unset, a
    ``"tuned"`` policy fills them per tier)."""
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    if max_delay_ms < 0:
        raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
    requests = tuple(requests)      # may be a generator: snapshot once
    big = max((r for _, r in requests), default=0)
    if big > max_batch:             # fail before serving, not mid-drain
        raise ValueError(f"request of {big} rows exceeds max_batch="
                         f"{max_batch} — requests are never split")
    tiers = batching.batch_tiers(max_batch) if tiers is None \
        else tuple(tiers)
    ladder = batching.PlanLadder(net_mapping, tiers, policy=policy,
                                 lookahead=lookahead, block=block,
                                 vmem_budget=vmem_budget, device=device)
    if ladder.max_batch < max_batch:
        raise ValueError(
            f"tiers {ladder.tiers} do not cover max_batch={max_batch} — "
            f"a full coalesced batch would have no plan to run on")
    ks, pool = serving_inputs(net_mapping, ladder.max_batch, seed,
                              ladder.device)
    shape = pool.shape[1:]
    warmup_steps = 0
    for _ in range(warmup):
        for t in ladder.tiers:       # load every tier's kernels up front
            ladder.run(t, ks, pool[:t])
            warmup_steps += 1

    delay_policy = (batching.AdaptiveDelay(max_delay_ms / 1e3, max_batch)
                    if adaptive_delay else None)
    co = batching.Coalescer(max_batch, max_delay_ms / 1e3,
                            delay_policy=delay_policy)
    # stable sort on TIME ONLY: a plain sorted() would order tied
    # timestamps (every backlogged stream) by rows, silently reordering
    # the FIFO the coalescer promises to preserve
    pending = deque(sorted(requests, key=lambda tr: tr[0]))
    stats = {t: batching.TierStats(plan_batch=t) for t in ladder.tiers}
    served_rows = padded_rows = 0
    t0 = clock()
    while pending or len(co):
        now = clock() - t0
        while pending and pending[0][0] <= now:
            arrival, rows = pending.popleft()
            co.push(rows, arrival)   # delay measured from scheduled arrival
        batch = co.pop(now, force=not pending)
        if not batch:
            deadline = co.next_deadline()
            horizon = min(pending[0][0] if pending else float("inf"),
                          deadline if deadline is not None else float("inf"))
            if horizon > now:
                sleep(horizon - now)
            continue
        rows = sum(r.rows for r in batch)
        tier, _ = ladder.plan_for(rows)
        x_np = np.zeros((tier,) + shape, np.float32)
        x_np[:rows] = pool[:rows]    # padded rows stay zero (pad-and-mask)
        launch = clock() - t0
        ladder.run(tier, ks, x_np)
        stats[tier].record(batch, launch, exec_s=clock() - t0 - launch)
        served_rows += rows
        padded_rows += tier
    wall = clock() - t0
    return batching.DynamicServeStats(
        tiers=stats, request_images=served_rows, padded_images=padded_rows,
        wall_s=wall, warmup_steps=warmup_steps)


def _print_dynamic(net: str, s: batching.DynamicServeStats, *, tag: str,
                   max_batch: int, max_delay_ms: float,
                   compiles: int, st: dict) -> None:
    """Human summary + harness CSV rows (one per served tier, one
    aggregate) for a dynamic run.  ``st`` is the SEARCH-phase stats
    snapshot — never the live dict (plan-ladder cache traffic would
    leak into the search columns)."""
    print(s.describe())
    for t in sorted(s.tiers):
        ts = s.tiers[t]
        if not ts.batches:
            continue
        print(f"serve_dyn/{net}/tier{t},"
              f"{ts.exec_s / ts.batches * 1e6:.1f},"
              f"images_per_s={ts.request_images / max(ts.exec_s, 1e-12):.1f};"
              f"padded_images_per_s="
              f"{ts.padded_images / max(ts.exec_s, 1e-12):.1f};"
              f"batches={ts.batches};"
              f"p50_ms={ts.delay_ms(50):.2f};p95_ms={ts.delay_ms(95):.2f};"
              f"p99_ms={ts.delay_ms(99):.2f}")
    # aggregate percentiles over the POOLED per-tier samples — never an
    # average of the per-tier p50/p95/p99 printed above
    pooled = (f"p50_ms={s.delay_ms(50):.2f};p95_ms={s.delay_ms(95):.2f};"
              f"p99_ms={s.delay_ms(99):.2f};" if s.delays_s else "")
    print(f"serve_dyn/{net}/all,"
          f"{s.wall_s / max(s.request_images, 1) * 1e6:.1f},"
          f"images_per_s={s.images_per_s:.1f};"
          f"padded_images_per_s={s.padded_images_per_s:.1f};"
          f"{pooled}"
          f"tiers={'/'.join(str(t) for t in sorted(s.tiers))};"
          f"plan_compiles={compiles};mesh={tag};"
          f"max_batch={max_batch};max_delay_ms={max_delay_ms};"
          f"warmup_steps={s.warmup_steps};"
          f"table_builds={st['table_misses']};disk_hits={st['disk_hits']}")


def _print_fleet(stats, *, tag: str, max_batch: int, max_delay_ms: float,
                 st: dict) -> None:
    """Human summary + harness CSV rows for a fleet run: one
    ``serve_fleet/<net>`` row per model, one ``serve_fleet/all``
    aggregate."""
    print(stats.describe())
    for name, ms in stats.models.items():
        if not ms.batches:
            continue
        exec_s = sum(t.exec_s for t in ms.tiers.values())
        ds = ms.delays_s
        tok = ""
        if ms.request_tokens is not None:
            tok = (f"tokens_per_s="
                   f"{ms.request_tokens / max(exec_s, 1e-12):.1f};")
        print(f"serve_fleet/{name},"
              f"{exec_s / ms.batches * 1e6:.1f},"
              f"images_per_s={ms.request_images / max(exec_s, 1e-12):.1f};"
              f"padded_images_per_s="
              f"{ms.padded_images / max(exec_s, 1e-12):.1f};"
              f"{tok}"
              f"dropped_layers={ms.dropped_layers};"
              f"batches={ms.batches};"
              f"tiers={'/'.join(str(t) for t in sorted(ms.tiers))};"
              f"p50_ms={batching.percentile(ds, 50)*1e3:.2f};"
              f"p95_ms={batching.percentile(ds, 95)*1e3:.2f};"
              f"p99_ms={batching.percentile(ds, 99)*1e3:.2f};"
              f"slo_attainment={ms.slo_attainment:.3f}")
    # fleet-wide percentiles over the POOLED per-model delay samples —
    # never an average of the per-model percentiles printed above
    pooled = (f"p50_ms={stats.delay_ms(50):.2f};"
              f"p95_ms={stats.delay_ms(95):.2f};"
              f"p99_ms={stats.delay_ms(99):.2f};" if stats.delays_s else "")
    print(f"serve_fleet/all,"
          f"{stats.wall_s / max(stats.request_images, 1) * 1e6:.1f},"
          f"images_per_s={stats.images_per_s:.1f};"
          f"padded_images_per_s={stats.padded_images_per_s:.1f};"
          f"{pooled}"
          f"models={'/'.join(stats.models)};"
          f"slo_attainment={stats.slo_attainment:.3f};mesh={tag};"
          f"max_batch={max_batch};max_delay_ms={max_delay_ms};"
          f"warmup_steps={stats.warmup_steps};"
          f"shared_constants={stats.shared_constants};"
          f"table_builds={st['table_misses']};disk_hits={st['disk_hits']}")


def fleet_mappings(names: Sequence[str], array: ArrayConfig,
                   algorithm: str, *, grid: MacroGrid = None,
                   p_max: int = None, seq: int = 16
                   ) -> Tuple[dict, dict, float]:
    """``(mappings, dropped_layers, search_s)`` of a fleet, each name
    mapped as ``--fleet`` serves it: a conv benchmark through
    :func:`map_for_serving`, cut to its chainable prefix when it is a
    layer set; a `launch.transformer.TRANSFORMERS` name lowered at
    ``seq`` tokens a row."""
    from . import fleet, transformer
    mappings, dropped, search_s = {}, {}, 0.0
    for n in names:
        t0 = time.perf_counter()
        if n in transformer.TRANSFORMERS:
            full = transformer.transformer_mapping(
                n, seq=seq, array=array, algorithm=algorithm,
                grid=grid or MacroGrid())
            s = time.perf_counter() - t0
        else:
            full, s = map_for_serving(n, array, algorithm, grid=grid,
                                      p_max=p_max)
        search_s += s
        mappings[n] = fleet.chainable_prefix(full)
        dropped[n] = len(full.layers) - len(mappings[n].layers)
        if dropped[n]:
            print(f"{n}: serving the chainable prefix "
                  f"({len(mappings[n].layers)}/{len(full.layers)} layers"
                  f" — the net is a layer set, not a chain)")
    return mappings, dropped, search_s


def _main_fleet(args, dev: torch.device):
    """``--fleet a,b,c``: mixed Poisson traffic across several models
    on one device (`launch/fleet.serve_fleet`).  Names resolve against
    the conv benchmarks (`core.networks.NETWORKS`) and the transformer
    lowerings (`launch.transformer.TRANSFORMERS`) — a mixed
    CNN+transformer fleet serves both kinds side by side, with tokens/s
    reported next to images/s."""
    from . import fleet, transformer
    names = [n.strip() for n in args.fleet.split(",") if n.strip()]
    unknown = [n for n in names
               if n not in networks.NETWORKS
               and n not in transformer.TRANSFORMERS]
    if unknown:
        raise SystemExit(
            f"unknown fleet nets {unknown} — choose from "
            f"{sorted(networks.NETWORKS)} or "
            f"{sorted(transformer.TRANSFORMERS)}")
    mappings, dropped, search_s = fleet_mappings(
        names, ArrayConfig(args.ar, args.ac), args.alg, grid=args.grid,
        p_max=args.p_max, seq=args.seq)
    st = memo.snapshot()
    max_batch = args.max_batch or args.batch
    max_delay_ms = 2.0 if args.max_delay_ms is None else args.max_delay_ms
    max_request = args.max_request or min(4, max_batch)
    config = fleet.FleetConfig(models=tuple(
        fleet.ModelSpec(n, max_batch=max_batch,
                        max_delay_s=max_delay_ms / 1e3,
                        slo_ms=args.slo_ms) for n in names))
    trace = fleet.mixed_poisson_trace(names, args.requests,
                                      args.arrival_rate, max_request,
                                      seed=args.seed)
    print(f"fleet [{args.alg}] nets={'/'.join(names)} device={dev} "
          f"search={search_s*1e3:.1f}ms "
          f"(table_builds={st['table_misses']} "
          f"disk_hits={st['disk_hits']})")
    stats, _ = fleet.serve_fleet(
        mappings, config, trace, policy=args.policy, warmup=args.warmup,
        seed=args.seed, share_constants=not args.no_share_constants,
        dropped_layers=dropped, device=dev)
    _print_fleet(stats, tag="none", max_batch=max_batch,
                 max_delay_ms=max_delay_ms, st=st)
    return stats


def _print_replicas(net: str, rs, *, n: int, max_batch: int,
                    max_delay_ms: float) -> None:
    """Human summary + harness CSV rows for a multi-replica run: one
    ``serve_replica/<net>/w<i>`` row per worker, one aggregate."""
    print(rs.describe())
    for wid in sorted(rs.workers):
        v = rs.workers[wid]
        if not v.batches and v.alive:
            continue
        print(f"serve_replica/{net}/w{wid},"
              f"{v.exec_s / max(v.batches, 1) * 1e6:.1f},"
              f"requests={v.served_requests};images={v.served_rows};"
              f"batches={v.batches};alive={int(v.alive)};"
              f"startup_ms={v.startup_s*1e3:.1f};"
              f"table_builds={v.table_misses};disk_hits={v.disk_hits}")
    pooled = (f"p50_ms={rs.delay_ms(50):.2f};p95_ms={rs.delay_ms(95):.2f};"
              f"p99_ms={rs.delay_ms(99):.2f};" if rs.delays_s else "")
    print(f"serve_replica/{net}/all,"
          f"{rs.wall_s / max(rs.request_images, 1) * 1e6:.1f},"
          f"images_per_s={rs.images_per_s:.1f};"
          f"padded_images_per_s={rs.padded_images_per_s:.1f};"
          f"{pooled}"
          f"replicas={n};deaths={rs.deaths};requeued={rs.requeued};"
          f"duplicate_serves={rs.duplicate_serves};"
          f"max_batch={max_batch};max_delay_ms={max_delay_ms}")


def _main_replicas(args, dev: torch.device):
    """``--replicas N``: spawn N worker processes (each mapping and
    compiling behind the shared disk cache, each with its own CUDA
    context), route a Poisson trace through the least-loaded
    dispatcher, report aggregate and per-replica rates
    (`launch/replica.serve_replicas`)."""
    from .replica import WorkerConfig, serve_replicas
    max_batch = args.max_batch or args.batch
    max_delay_ms = 2.0 if args.max_delay_ms is None else args.max_delay_ms
    max_request = args.max_request or min(4, max_batch)
    trace = poisson_arrivals(args.requests, args.arrival_rate, max_request,
                             seed=args.seed)
    cfg = WorkerConfig(
        net=args.net, array=(args.ar, args.ac), alg=args.alg,
        grid=(args.grid.r, args.grid.c) if args.grid is not None else None,
        p_max=args.p_max, max_batch=max_batch, max_delay_ms=max_delay_ms,
        adaptive_delay=args.adaptive_delay, policy=args.policy,
        seed=args.seed, cache_dir=args.cache_dir, warmup=args.warmup,
        device=str(dev))
    print(f"{args.net} [{args.alg}] replicas={args.replicas} "
          f"max_batch={max_batch} max_delay_ms={max_delay_ms} "
          f"requests={args.requests} rate={args.arrival_rate}/s "
          f"device={dev}")
    rs = serve_replicas(trace, cfg, args.replicas,
                        dead_after_s=args.dead_after_ms / 1e3,
                        kill_worker=args.kill_worker)
    _print_replicas(args.net, rs, n=args.replicas, max_batch=max_batch,
                    max_delay_ms=max_delay_ms)
    return rs


def main(argv=None):
    """The CLI; returns the run's stats (`ServeStats`, or
    `batching.DynamicServeStats`, `fleet.FleetStats`,
    `replica.ReplicaStats` for the other modes)."""
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
                    choices=("mapped", "reference", "sdk", "auto",
                             "tuned"),
                    help="plan executor policy (per-layer for 'auto'; "
                         "'tuned' loads the autotuner's persisted "
                         "winner, falling back to 'auto')")
    ap.add_argument("--autotune", action="store_true",
                    help="run the measured-feedback autotuner "
                         "(repro_torch.tune) for this net / device fleet "
                         "/ batch profile first — instant with a warm "
                         "--cache-dir — then serve the winner's full "
                         "config (policy, lookahead, sdk knobs, tiers); "
                         "fixed and dynamic modes — --fleet and "
                         "--replicas serve a persisted winner through "
                         "--policy tuned")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent mapping/plan cache directory "
                         "(default: $REPRO_MAPPING_CACHE)")
    ap.add_argument("--cache-max-bytes", type=int, default=None,
                    help="mtime-LRU size cap for --cache-dir")
    ap.add_argument("--no-donate", action="store_true",
                    help="accepted for the JAX package's CLI; torch has "
                         "no buffer donation, so it changes nothing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    dyn = ap.add_argument_group(
        "dynamic batching (arrival-driven; enabled by --max-delay-ms)")
    dyn.add_argument("--max-delay-ms", type=float, default=None,
                     help="coalescer max delay: a queued request is "
                          "served at latest this long after arrival")
    dyn.add_argument("--max-batch", type=int, default=None,
                     help="largest coalesced batch / top ladder tier "
                          "(default: --batch)")
    dyn.add_argument("--arrival-rate", type=float, default=0.0,
                     help="synthetic Poisson arrivals per second "
                          "(0: fully backlogged queue)")
    dyn.add_argument("--requests", type=int, default=32,
                     help="number of synthetic requests to serve")
    dyn.add_argument("--max-request", type=int, default=None,
                     help="largest rows per ragged request (default: "
                          "min(4, max-batch))")
    dyn.add_argument("--adaptive-delay", action="store_true",
                     help="scale the coalescing delay with queue depth "
                          "(deep backlog drains immediately, an idle "
                          "queue waits up to --max-delay-ms)")
    rep = ap.add_argument_group(
        "multi-replica serving (process scale-out; enabled by --replicas)")
    rep.add_argument("--replicas", type=int, default=None,
                     help="spawn this many worker processes, each with "
                          "its own CUDA context and plan ladder, behind a "
                          "least-loaded router (reuses the dynamic-"
                          "batching knobs per worker)")
    rep.add_argument("--dead-after-ms", type=float, default=5000.0,
                     help="heartbeat deadline: a worker silent this "
                          "long is declared dead and its in-flight "
                          "requests re-queued to survivors")
    rep.add_argument("--kill-worker", type=int, default=None,
                     help="crash-inject: kill this worker id once it "
                          "has work in flight (recovery demo — the run "
                          "must still serve every request exactly once)")
    flt = ap.add_argument_group(
        "fleet serving (multi-model; enabled by --fleet)")
    flt.add_argument("--fleet", default=None,
                     help="comma list of models to serve together on one "
                          "device under mixed Poisson traffic — conv nets "
                          "(cnn8,inception,densenet40) and transformer "
                          "lowerings (stablelm_smoke,whisper_smoke) mix "
                          "freely; reuses the dynamic-batching knobs per "
                          "model")
    flt.add_argument("--seq", type=int, default=16,
                     help="sequence length (tokens per request row) for "
                          "transformer fleet members")
    flt.add_argument("--slo-ms", type=float, default=None,
                     help="per-request queue-delay SLO target for "
                          "attainment reporting (fleet mode)")
    flt.add_argument("--no-share-constants", action="store_true",
                     help="prepare shifted-weight constants in every "
                          "forward instead of once per network")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.cache_dir is not None:
        memo.set_disk_cache(args.cache_dir, max_bytes=args.cache_max_bytes)

    if args.fleet is not None:
        return _main_fleet(args, dev)

    if args.replicas is not None:
        return _main_replicas(args, dev)

    mapping, search_s = map_for_serving(
        args.net, ArrayConfig(args.ar, args.ac), args.alg,
        grid=args.grid, p_max=args.p_max)
    # snapshot at the measurement boundary: serving traffic (plan-cache
    # lookups, ladder compiles) must not leak into the search stats
    st = memo.snapshot()
    print(f"{args.net} [{args.alg}] grid={mapping.grid.r}x{mapping.grid.c} "
          f"total_cycles={mapping.total_cycles} search={search_s*1e3:.1f}ms "
          f"(table_builds={st['table_misses']} disk_hits={st['disk_hits']} "
          f"disk_writes={st['disk_writes']})")

    if args.max_delay_ms is not None:
        from ..exec import compile_counts
        max_batch = args.max_batch or args.batch
        max_request = args.max_request or min(4, max_batch)
        reqs = poisson_arrivals(args.requests, args.arrival_rate,
                                max_request, seed=args.seed)
        policy, tiers = args.policy, None
        lookahead = block = vmem_budget = None
        if args.autotune:
            from .. import tune
            res = tune.autotune(mapping, batch=max_batch, device=dev,
                                ragged=tuple(r for _, r in reqs),
                                max_delay_ms=args.max_delay_ms,
                                seed=args.seed)
            print(f"autotune: {res.describe()}")
            cand = res.config.candidate
            policy, lookahead = cand.policy, cand.lookahead
            block, vmem_budget = cand.block, cand.vmem_budget
            tiers = tune.resolve_tiers(cand, max_batch)
        s = serve_dynamic(mapping, reqs, max_batch=max_batch,
                          max_delay_ms=args.max_delay_ms, tiers=tiers,
                          policy=policy, warmup=args.warmup,
                          seed=args.seed,
                          adaptive_delay=args.adaptive_delay,
                          lookahead=lookahead, block=block,
                          vmem_budget=vmem_budget, device=dev)
        compiles = sum(compile_counts(net=mapping).values())
        _print_dynamic(args.net, s, tag="none", max_batch=max_batch,
                       max_delay_ms=args.max_delay_ms, compiles=compiles,
                       st=st)
        return s

    policy = args.policy
    lookahead = block = vmem_budget = None
    if args.autotune:
        from .. import tune
        res = tune.autotune(mapping, batch=args.batch, device=dev,
                            seed=args.seed)
        print(f"autotune: {res.describe()}")
        cand = res.config.candidate
        policy, lookahead = cand.policy, cand.lookahead
        block, vmem_budget = cand.block, cand.vmem_budget
    s = serve(mapping, args.batch, args.steps, warmup=args.warmup,
              seed=args.seed, policy=policy, lookahead=lookahead,
              block=block, vmem_budget=vmem_budget, device=dev)
    print(s.plan.describe())
    pol_tag = args.policy if isinstance(policy, str) else \
        "tuned:" + "/".join(sorted(set(policy)))
    print(f"device={dev} batch={args.batch}: {s.images_per_s:.1f} images/s"
          f" ({s.s_per_batch*1e3:.3f} ms/batch, executor={pol_tag}, "
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
