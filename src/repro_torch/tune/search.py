"""Measured-feedback search driver: seeded successive halving (port of
``repro/tune/search.py``).

`autotune` is the entry point.  Per (net mapping, device fleet, batch
profile) it:

1. **loads** a persisted winner when one exists (`memo.load_tuning` —
   a warm disk cache means a cold process adopts the tuned config with
   ZERO measurements);
2. else **enumerates** the joint space (tune/space.py) and **seeds** a
   shortlist from the analytical cycle model — only the shortlist is
   ever measured;
3. **measures** the shortlist against wall-clock with interleaved-round
   medians (tune/measure.py) under **successive halving**: every stage
   halves the pool (keeping the best ``1/eta``) and multiplies the
   per-candidate rounds by ``eta``, so cheap early rounds discard the
   clearly-bad seeds and the budget concentrates on the contenders.
   The ``"auto"``-default baseline candidate survives every cut
   (champion–challenger), so the final stage always measures the winner
   and the default in the SAME interleaved rounds — the tuned config
   can tie the default, but never lose to it on its own evidence;
4. **persists** the winner (`memo.store_tuning`) under the exact batch
   profile and under the generic (batch=None) slot, so ladder tiers
   compiled at other batches inherit it.

The fleet in the key comes from the device the search measures on and
the devices its mesh splits build over (:func:`fleet_signature`): a
winner tuned on the card is never found by a ``device="cpu"`` plan, nor
the reverse, and one tuned over eight mesh entries is not found by a
one-device search.  Each candidate's split is rebuilt over those devices
(`launch.mesh.mesh_from_split`); a split they cannot realise runs on the
single-device path.  Every measured step ends in a
device synchronize, so the clock holds the device's work and not only
its enqueue.

Both the timer (``clock``) and the per-candidate step builder
(``runner``) are injectable, which makes the whole search deterministic
under test: a fake runner that advances a fake clock by scripted
per-candidate costs must reproduce the halving schedule and the winner
exactly — the same trials as the JAX package's on the same script
(tests/test_torch_tune.py).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core import memo
from ..device import DeviceLike, resolve_device
from .measure import interleaved_medians
from .space import (Candidate, TunedConfig, baseline_candidate,
                    enumerate_space, shortlist)

#: The sources whose kernels a plan can launch (sdk layers, matmul
#: layers and their attention stage); built before a search on the card
#: so no measured step waits for ``nvcc``.
PLAN_SOURCES = ("sdk_conv.cu", "matmul.cu", "flash_attention.cu")


@dataclass(frozen=True)
class TuneBudget:
    """Measurement budget of one search.  ``shortlist`` candidates are
    promoted from the analytical seeding; stage 0 gives each ``rounds``
    interleaved rounds; every later stage keeps the best
    ``ceil(pool/eta)`` (plus the baseline) and multiplies rounds by
    ``eta``, capped at ``max_rounds`` per candidate per stage — so one
    candidate costs at most ``warmup + rounds + ... + max_rounds``
    measured steps, and the whole search is bounded up front."""

    shortlist: int = 8
    rounds: int = 3
    eta: int = 2
    max_rounds: int = 12
    warmup: int = 1

    def __post_init__(self):
        if self.shortlist < 1 or self.rounds < 1 or self.eta < 2 \
                or self.max_rounds < self.rounds or self.warmup < 0:
            raise ValueError(f"malformed budget {self}")


#: The small budget of smoke runs (the CPU tests, the card's ragged and
#: layer-set searches).
SMOKE_BUDGET = TuneBudget(shortlist=4, rounds=2, eta=2, max_rounds=4,
                          warmup=1)


@dataclass(frozen=True)
class Trial:
    """One candidate's median at one halving stage."""

    candidate: Candidate
    rounds: int
    median_s: float


@dataclass(frozen=True)
class TuneResult:
    """What `autotune` returns: the (possibly cached) winner plus the
    full measured trajectory for reporting (tune/report.py)."""

    config: TunedConfig
    trials: Tuple[Trial, ...]
    cached: bool                # loaded from the persistent cache —
    measurements: int           # ... then this is 0
    key: Tuple

    def describe(self) -> str:
        src = "cache" if self.cached else \
            f"search ({self.measurements} measured steps)"
        return f"{self.config.describe()} [{src}]"


def fleet_signature(device: DeviceLike = None,
                    devices=None) -> Tuple[str, int]:
    """(platform, device count) the tuning is valid for — part of the
    persistence key: ``("cuda", torch.cuda.device_count())`` for a plan
    on the card, ``("cpu", 1)`` for one on the CPU, or the count of
    ``devices`` where the search's meshes build over an explicit list.
    It comes from the device asked for, never from whichever card is
    present, so a winner tuned on the card does not leak onto a CPU
    plan."""
    dev = resolve_device(device)
    if devices is not None:
        return (dev.type, len(devices))
    if dev.type == "cuda":
        return ("cuda", torch.cuda.device_count())
    return ("cpu", 1)


def tuning_key(net, fleet: Tuple[str, int], batch: Optional[int],
               ragged: Optional[Tuple[int, ...]] = None) -> Tuple:
    """The persistence key: (net mapping, device fleet, batch profile).
    ``ragged`` distinguishes a dynamic-serving profile (the request-size
    stream tuned against) from the fixed-batch one."""
    return (net, fleet, batch, ragged)


def tuned_config(net, *, batch: Optional[int] = None,
                 device: DeviceLike = None, devices=None,
                 ragged: Optional[Tuple[int, ...]] = None
                 ) -> Optional[TunedConfig]:
    """Peek the persisted winner for this (net, fleet of ``device``,
    batch) — exact batch first, then the generic slot a search also
    stores under — or ``None`` when nothing was ever tuned (callers fall
    back to ``"auto"``; `compile_plan(executor_policy="tuned")` does
    exactly that)."""
    fleet = fleet_signature(device, devices)
    slots = (batch, None) if batch is not None else (None,)
    for b in slots:
        cfg = memo.load_tuning(tuning_key(net, fleet, b, ragged))
        if cfg is not None:
            return cfg
    return None


def _chains(net) -> bool:
    """Whether the net compiles as a chain (execute_plan) or only as a
    layer set (execute_layerwise) — inception's spec list is a
    representative set, not a chain."""
    from ..exec.glue import resolve_chain
    carry = net.layers[0].layer.ic
    try:
        for a, b in zip(net.layers, net.layers[1:]):
            resolve_chain(a.layer.name, a.layer.oc, carry,
                          b.layer.name, b.layer.ic)
            carry = b.layer.ic
        return True
    except ValueError:
        return False


def resolve_tiers(cand: Candidate, max_batch: int, mesh=None):
    """The candidate's tier ladder made valid for ITS mesh: every tier
    padded to the data axis (tiers were proposed mesh-agnostically) and
    the top tier covering ``max_batch``."""
    from ..launch import batching, mesh as meshlib
    meshlib.check_mesh(mesh)
    if cand.tiers is None:
        return batching.batch_tiers(max_batch, mesh)
    tiers = sorted({meshlib.pad_to_data_axis(int(t), mesh)
                    for t in cand.tiers})
    top = meshlib.pad_to_data_axis(max_batch, mesh)
    if not tiers or tiers[-1] < top:
        tiers.append(top)
    return tuple(tiers)


def default_runner(net, *, batch: int, device: DeviceLike = None,
                   devices=None,
                   ragged: Optional[Tuple[int, ...]] = None,
                   max_delay_ms: float = 0.5,
                   seed: int = 0) -> Callable[[Candidate], Callable]:
    """Build the measured step for a candidate, on ``device`` (default:
    the card).

    Fixed profile (``ragged=None``): one steady-state `execute_plan`
    forward at the candidate's plan batch, padded to its mesh's data axis
    (`execute_layerwise` for nets that do not chain); each candidate runs
    over its split rebuilt on ``devices`` (`tune.space.mesh_devices`).  Ragged profile: one backlogged `serve_dynamic`
    drain of the ``ragged`` request sizes through the candidate's tier
    ladder — the coalescer/ladder policy is then part of what is
    measured.  Every step ends in a device synchronize.  Kernels and
    inputs are drawn as `serve_cnn._serving_kernels` draws them; the
    plan compiles here and the kernels are built before the first step,
    so the warmup call the measurement harness issues only steadies the
    caches."""
    import numpy as np
    from ..device import synchronize
    from ..exec import compile_plan, execute_layerwise, execute_plan
    from ..launch import mesh as meshlib, serve_cnn
    from .space import mesh_devices

    dev = resolve_device(device)
    devices = mesh_devices(devices, dev)
    if dev.type == "cuda":
        from ..kernels import _build
        _build.build_all(PLAN_SOURCES)
    chained = _chains(net)
    rng, ks = serve_cnn._serving_kernels(net, seed, dev)
    first = net.layers[0].layer

    def upload(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev)

    def build(cand: Candidate) -> Callable[[], None]:
        mesh = meshlib.mesh_from_split(cand.mesh_split, devices)
        if ragged is not None and chained:
            reqs = tuple((0.0, int(r)) for r in ragged)
            tiers = resolve_tiers(cand, batch, mesh)

            def step():
                serve_cnn.serve_dynamic(
                    net, reqs, max_batch=batch,
                    max_delay_ms=max_delay_ms, mesh=mesh, tiers=tiers,
                    policy=cand.policy, warmup=0, seed=seed,
                    lookahead=cand.lookahead, block=cand.block,
                    vmem_budget=cand.vmem_budget, device=dev)
            return step

        plan_batch = meshlib.pad_to_data_axis(batch, mesh)
        plan = compile_plan(net, executor_policy=cand.policy, mesh=mesh,
                            batch=plan_batch, chained=chained,
                            lookahead=cand.lookahead, block=cand.block,
                            vmem_budget=cand.vmem_budget,
                            remat=cand.remat, device=dev)
        if chained:
            x = upload(plan_batch, first.ic, first.i_h, first.i_w)

            def step():
                execute_plan(plan, ks, x, mesh=mesh)
                synchronize(dev)
            return step

        xs = tuple(upload(plan_batch, m.layer.ic, m.layer.i_h, m.layer.i_w)
                   for m in net.layers)

        def step():
            execute_layerwise(plan, ks, xs, mesh=mesh)
            synchronize(dev)
        return step

    return build


def autotune(net, *, batch: int, device: DeviceLike = None,
             devices=None,
             space: Optional[Sequence[Candidate]] = None,
             baseline: Optional[Candidate] = None,
             budget: Optional[TuneBudget] = None,
             clock: Callable[[], float] = time.perf_counter,
             runner: Optional[Callable[[Candidate], Callable]] = None,
             ragged: Optional[Tuple[int, ...]] = None,
             max_delay_ms: float = 0.5, seed: int = 0,
             force: bool = False, store: bool = True) -> TuneResult:
    """Find (or load) the fastest measured configuration of ``net`` for
    the fleet of ``device`` (default: the card) and this batch profile —
    see the module docstring for the search shape.  ``devices`` is the
    device list the candidates' mesh splits build over (default: every
    visible card, or the one CPU for ``device="cpu"``).  ``force=True``
    re-measures even with a persisted winner; ``store=False`` skips
    persisting (exploratory sweeps)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    budget = budget or TuneBudget()
    fleet = fleet_signature(device, devices)
    ragged = tuple(int(r) for r in ragged) if ragged is not None else None
    key = tuning_key(net, fleet, batch, ragged)
    if not force:
        cfg = memo.load_tuning(key)
        if cfg is not None:
            return TuneResult(config=cfg, trials=(), cached=True,
                              measurements=0, key=key)

    if baseline is None:
        baseline = baseline_candidate(net, batch=batch, device=device,
                                      devices=devices)
    if space is None:
        tiers_options = ((None, (batch,)) if ragged is not None
                         else (None,))
        space = enumerate_space(net, batch=batch, device=device,
                                devices=devices,
                                tiers_options=tiers_options)
    short = shortlist(net, space, budget.shortlist, baseline=baseline)

    if runner is None:
        runner = default_runner(net, batch=batch, device=device,
                                devices=devices, ragged=ragged,
                                max_delay_ms=max_delay_ms, seed=seed)
    measured = 0

    def counted(step):
        def run():
            nonlocal measured
            measured += 1
            step()
        return run

    steps = {c: counted(runner(c)) for c in short}

    pool = list(short)
    rounds = budget.rounds
    trials = []
    while True:
        meds = interleaved_medians([steps[c] for c in pool],
                                   rounds=rounds, clock=clock,
                                   warmup=budget.warmup)
        trials.extend(Trial(c, rounds, m) for c, m in zip(pool, meds))
        if len(pool) <= 2 or rounds >= budget.max_rounds:
            break
        keep = max(1, math.ceil(len(pool) / budget.eta))
        order = sorted(range(len(pool)), key=meds.__getitem__)
        pool = [pool[i] for i in order[:keep]]
        if baseline not in pool:        # the champion survives every cut
            pool.append(baseline)
        rounds = min(rounds * budget.eta, budget.max_rounds)

    win_i = min(range(len(pool)), key=meds.__getitem__)
    cfg = TunedConfig(candidate=pool[win_i], median_s=meds[win_i],
                      baseline_s=meds[pool.index(baseline)],
                      rounds=rounds, measurements=measured, fleet=fleet,
                      batch=batch)
    if store:
        memo.store_tuning(key, cfg)
        # the generic slot: ladder tiers compiled at other batches (and
        # `tuned_config(batch=None)` callers) inherit the newest tuning
        memo.store_tuning(tuning_key(net, fleet, None, ragged), cfg)
    return TuneResult(config=cfg, trials=tuple(trials), cached=False,
                      measurements=measured, key=key)
