"""Multi-model fleet serving: tagged request streams over shared plans
(port of ``repro/launch/fleet.py``).

A :class:`FleetScheduler` routes a *tagged* request stream (model name
on every `batching.Request`) across several compiled `NetworkPlan`
ladders sharing one device and one serving mesh (:func:`fleet_mesh_for`)
—

* **per-model queues** — each model owns a max-delay
  :class:`batching.Coalescer` and a :class:`batching.PlanLadder`; the
  single-model latency contract (FIFO, never split, max-delay bound) is
  preserved per model.
* **cross-model drain policy** — weighted-fair by queued rows with a
  deadline override: a model whose oldest request has *expired* (now ≥
  arrival + max_delay) drains first, nearest deadline breaking ties;
  otherwise the model with the largest ``queued_rows x weight`` drains
  (keeping the arrays full), ties resolved by config order.
* **plan-constant sharing** — the tiers of one network reuse one
  prepared shifted-weight handle (`exec.constants.prepare_constants`
  through ``memo.cached_constants``) instead of preparing the blocks in
  every forward.

Determinism invariant (DESIGN.md §10): the scheduler core — routing,
fairness, deadline override, tier selection — is pure Python over
explicit ``now`` timestamps and touches no device (the module imports
torch only inside :func:`serve_fleet`).  Given the same
:class:`FleetConfig` (or any pickle round-trip of it), the same arrival
trace, and the same clock/sleep pair, :func:`run_fleet` emits a
bit-identical :class:`LaunchRecord` sequence on every run — and the
same sequence as the JAX package's ``run_fleet``: no wall clock, no
randomness, no dict-iteration order.  Device execution happens strictly
*after* each decision and feeds back only through the injected clock.

    python -m repro_torch.launch.serve_cnn --policy auto \
        --fleet cnn8,inception,densenet40 --max-delay-ms 2 \
        --arrival-rate 200 --requests 48
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Callable, Dict, List, Mapping,
                    Optional, Sequence, Tuple, Union)

import numpy as np

from . import batching
from . import mesh as meshlib

if TYPE_CHECKING:
    from ..device import DeviceLike


# ---------------------------------------------------------------------------
# Configuration — frozen, hashable, picklable (the determinism test
# round-trips it through pickle)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelSpec:
    """Per-model serving contract: queueing (``max_batch`` /
    ``max_delay_s`` feed the model's coalescer), fairness ``weight``
    (drain priority scales with queued rows x weight), and the
    reporting SLO ``slo_ms`` (a queue-delay target; attainment = the
    fraction of requests launched within it — None reports 1.0)."""

    name: str
    max_batch: int
    max_delay_s: float
    weight: float = 1.0
    slo_ms: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("model name must be non-empty")
        if self.max_batch < 1:
            raise ValueError(
                f"{self.name}: max_batch must be >= 1, got {self.max_batch}")
        if self.max_delay_s < 0:
            raise ValueError(f"{self.name}: max_delay_s must be >= 0, "
                             f"got {self.max_delay_s}")
        if not self.weight > 0:
            raise ValueError(
                f"{self.name}: weight must be > 0, got {self.weight}")
        if self.slo_ms is not None and not self.slo_ms > 0:
            raise ValueError(
                f"{self.name}: slo_ms must be > 0, got {self.slo_ms}")


@dataclass(frozen=True)
class FleetConfig:
    """The fleet: an ordered tuple of :class:`ModelSpec`.  The ORDER is
    semantic — every scheduler tie-break (equal deadlines, equal
    weighted backlogs) resolves to the earliest model in it, which is
    what makes the drain sequence reproducible."""

    models: Tuple[ModelSpec, ...]

    def __post_init__(self):
        if not self.models:
            raise ValueError("fleet needs at least one model")
        names = [m.name for m in self.models]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names in fleet: {names}")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(m.name for m in self.models)

    def spec(self, name: str) -> ModelSpec:
        for m in self.models:
            if m.name == name:
                return m
        raise KeyError(f"model {name!r} not in fleet {self.names}")


# ---------------------------------------------------------------------------
# Scheduler core — pure Python, explicit `now`, fake-clock testable
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Launch:
    """One drain decision: ``requests`` (a FIFO prefix of one model's
    queue, whole requests, arrival order) to serve on ``tier``."""

    model: str
    tier: int
    requests: Tuple[batching.Request, ...]

    @property
    def rows(self) -> int:
        return sum(r.rows for r in self.requests)


@dataclass(frozen=True)
class LaunchRecord:
    """The comparable trace row of one launch — what the determinism
    regression asserts bit-identical across runs: when, which model,
    which tier, and exactly which requests (rows + arrival stamps, in
    served order)."""

    launch_s: float
    model: str
    tier: int
    rows: Tuple[int, ...]
    arrivals_s: Tuple[float, ...]

    @staticmethod
    def of(launch: "Launch", launch_s: float) -> "LaunchRecord":
        return LaunchRecord(
            launch_s=launch_s, model=launch.model, tier=launch.tier,
            rows=tuple(r.rows for r in launch.requests),
            arrivals_s=tuple(r.arrival_s for r in launch.requests))


class FleetScheduler:
    """Route a tagged request stream across per-model coalescers.

    All methods take ``now`` explicitly (the caller owns the clock);
    nothing here touches devices, wall time, or randomness — see the
    module docstring's determinism invariant.  ``tiers`` maps each
    model to its plan-batch ladder (default:
    ``batching.batch_tiers(spec.max_batch, mesh)``), so :meth:`pop` can
    stamp every launch with the tier it will pad to.
    """

    def __init__(self, config: FleetConfig, *, mesh=None,
                 tiers: Optional[Mapping[str, Sequence[int]]] = None):
        self.config = config
        self.tiers: Dict[str, Tuple[int, ...]] = {}
        self._co: Dict[str, batching.Coalescer] = {}
        for spec in config.models:
            self._co[spec.name] = batching.Coalescer(
                spec.max_batch, spec.max_delay_s)
            t = batching.batch_tiers(spec.max_batch, mesh) \
                if tiers is None or spec.name not in tiers \
                else tuple(sorted(set(int(x) for x in tiers[spec.name])))
            if t[-1] < spec.max_batch:
                raise ValueError(
                    f"{spec.name}: tiers {t} do not cover max_batch="
                    f"{spec.max_batch}")
            self.tiers[spec.name] = t

    def __len__(self) -> int:
        """Total queued images across all models."""
        return sum(len(c) for c in self._co.values())

    def queued_rows(self, model: str) -> int:
        return len(self._co[model])

    def push(self, model: str, rows: int, now: float,
             payload: object = None) -> None:
        if model not in self._co:
            raise KeyError(
                f"model {model!r} not in fleet {self.config.names}")
        self._co[model].push(rows, now, payload, model)

    def next_deadline(self) -> Optional[float]:
        """Earliest max-delay expiry across the fleet (None when every
        queue is empty) — the latest moment the server may sleep to."""
        ds = [d for d in (c.next_deadline() for c in self._co.values())
              if d is not None]
        return min(ds) if ds else None

    def ready(self, now: float) -> bool:
        return any(c.ready(now) for c in self._co.values())

    def pop(self, now: float, force: bool = False) -> Optional[Launch]:
        """Drain ONE model per the cross-model policy, or None when no
        model is ready (callers loop until None to drain everything due
        at ``now``).

        Policy, in order (all ties resolve by config order):

        1. **deadline override** — among models whose oldest request has
           expired (``now >= arrival + max_delay``), the nearest (i.e.
           most overdue) deadline drains first: the max-delay latency
           bound outranks fill.
        2. **forced flush** (``force=True``, no future arrival can grow
           any batch) — drain in deadline order, oldest obligation
           first.
        3. **weighted fair** — the model with the largest
           ``queued_rows x weight`` drains: among models that are ready
           anyway, prefer the fullest batch (array fill is throughput).
        """
        order = {m.name: i for i, m in enumerate(self.config.models)}
        cand = [m.name for m in self.config.models
                if len(self._co[m.name])
                and (force or self._co[m.name].ready(now))]
        if not cand:
            return None
        expired = [n for n in cand
                   if now >= self._co[n].next_deadline()]
        if expired:
            name = min(expired, key=lambda n: (self._co[n].next_deadline(),
                                               order[n]))
        elif force:
            name = min(cand, key=lambda n: (self._co[n].next_deadline(),
                                            order[n]))
        else:
            name = max(cand, key=lambda n: (
                len(self._co[n]) * self.config.spec(n).weight, -order[n]))
        batch = self._co[name].pop(now, force=force)
        if not batch:               # not reachable for a ready/forced
            return None             # candidate; kept as a guard
        rows = sum(r.rows for r in batch)
        return Launch(model=name,
                      tier=batching.tier_for(rows, self.tiers[name]),
                      requests=tuple(batch))


TraceEvent = Tuple[float, str, int]     # (arrival_s, model, rows)


def run_fleet(sched: FleetScheduler, trace: Sequence[TraceEvent], *,
              clock: Callable[[], float] = time.perf_counter,
              sleep: Callable[[float], None] = time.sleep,
              execute: Optional[Callable[[Launch, float], None]] = None,
              ) -> List[LaunchRecord]:
    """Replay a tagged arrival trace through the scheduler.

    The loop shape of `serve_cnn.serve_dynamic`, fleet-wide: push each
    arrival as its time comes, drain one launch per pass (``execute``
    runs the device forward and feeds back only through ``clock``),
    sleep to the earliest of next-arrival / earliest-deadline when
    nothing is ready, and force-drain once no future arrival remains.
    Returns the full launch schedule — the determinism regression's
    comparison object."""
    for t, model, rows in trace:
        spec = sched.config.spec(model)     # KeyError -> unknown model
        if rows > spec.max_batch:           # fail before serving
            raise ValueError(
                f"request of {rows} rows exceeds {model}'s max_batch="
                f"{spec.max_batch} — requests are never split")
        if rows < 1:
            raise ValueError(f"request must carry >= 1 row, got {rows}")
        del t
    # stable sort on TIME ONLY (see serve_dynamic): ordering tied
    # timestamps by payload would reorder the FIFO each model expects
    pending = deque(sorted(trace, key=lambda e: e[0]))
    records: List[LaunchRecord] = []
    t0 = clock()
    while pending or len(sched):
        now = clock() - t0
        while pending and pending[0][0] <= now:
            arrival, model, rows = pending.popleft()
            # delay is measured from the SCHEDULED arrival time
            sched.push(model, rows, arrival)
        launch = sched.pop(now, force=not pending)
        if launch is None:
            deadline = sched.next_deadline()
            horizon = min(
                pending[0][0] if pending else float("inf"),
                deadline if deadline is not None else float("inf"))
            if horizon > now:
                sleep(horizon - now)
            continue
        launch_s = clock() - t0
        if execute is not None:
            execute(launch, launch_s)
        records.append(LaunchRecord.of(launch, launch_s))
    return records


# ---------------------------------------------------------------------------
# Synthetic mixed traffic + layer-set prefixes
# ---------------------------------------------------------------------------


def mixed_poisson_trace(models: Sequence[str], n: int, rate_per_s: float,
                        max_rows: Union[int, Mapping[str, int]],
                        seed: int = 0,
                        weights: Optional[Sequence[float]] = None,
                        ) -> Tuple[TraceEvent, ...]:
    """A tagged Poisson arrival schedule: ``n`` requests with
    exponential inter-arrival gaps at ``rate_per_s`` (0 → fully
    backlogged, everything at t=0), each tagged with a model drawn from
    ``models`` (uniform, or per ``weights``) and a uniform ragged size
    in ``[1, max_rows[model]]`` (``max_rows`` may be one int for
    all)."""
    if n < 1:
        raise ValueError(f"need >= 1 request, got {n}")
    models = list(models)
    if not models:
        raise ValueError("need >= 1 model")
    caps = {m: (max_rows if isinstance(max_rows, int)
                else int(max_rows[m])) for m in models}
    for m, cap in caps.items():
        if cap < 1:
            raise ValueError(f"{m}: max_rows must be >= 1, got {cap}")
    if weights is not None:
        if len(weights) != len(models):
            raise ValueError(f"{len(weights)} weights for "
                             f"{len(models)} models")
        p = np.asarray(weights, dtype=float)
        p = p / p.sum()
    else:
        p = None
    rng = np.random.RandomState(seed)
    if rate_per_s > 0:
        gaps = rng.exponential(1.0 / rate_per_s, size=n)
        times = np.cumsum(gaps) - gaps[0]       # first request at t=0
    else:
        times = np.zeros(n)
    picks = rng.choice(len(models), size=n, p=p)
    out = []
    for t, mi in zip(times, picks):
        m = models[int(mi)]
        out.append((float(t), m, int(rng.randint(1, caps[m] + 1))))
    return tuple(out)


def chainable_prefix(net_mapping):
    """Longest chainable PREFIX of a network mapping, as a mapping.

    Some bench networks are representative layer *sets*, not chains
    (inception's two disjoint blocks) — `exec.compile_plan` refuses to
    chain them.  Fleet serving drives whole-forward plans, so such a
    net serves as its longest chainable prefix; the glue arithmetic is
    the same pure channel check `exec.glue.resolve_chain` applies at
    compile time (next ic == oc, or == ic + oc for concat).  Returns
    the mapping unchanged when it already chains end to end; callers
    report the slice as ``ModelStats.dropped_layers``
    (`serve_cnn._main_fleet`, benchmarks/fleet_bench).

    Mappings carrying EXPLICIT glue (transformer lowerings) return
    unchanged: their chaining — residual save/pop stacks, attention
    channel folds — is validated by ``compile_plan`` against the glue
    itself, and the pure oc/ic arithmetic below would mis-slice them
    (a fused qkv's oc never equals the o projection's ic).
    """
    import dataclasses
    if getattr(net_mapping, "glue", None) is not None:
        return net_mapping
    layers = [m.layer for m in net_mapping.layers]
    n = 1
    for a, b in zip(layers, layers[1:]):
        if b.ic not in (a.oc, a.ic + a.oc):
            break
        n += 1
    if n == len(layers):
        return net_mapping
    return dataclasses.replace(net_mapping,
                               layers=net_mapping.layers[:n])


# ---------------------------------------------------------------------------
# Stats + device-serving loop
# ---------------------------------------------------------------------------


@dataclass
class ModelStats:
    """One model's slice of a fleet run: per-tier effective vs padded
    accounting plus SLO attainment against the model's queue-delay
    target.

    ``tokens_per_row`` is set for transformer models (the lowered
    sequence length, `launch.transformer.tokens_per_row`) so tokens/s
    reports next to images/s; ``dropped_layers`` surfaces how many
    trailing layers `chainable_prefix` cut from the served mapping
    (0 for an end-to-end chain) — a stats/CSV field, not just a CLI
    print."""

    name: str
    slo_ms: Optional[float]
    tiers: Dict[int, batching.TierStats] = field(default_factory=dict)
    tokens_per_row: Optional[int] = None
    dropped_layers: int = 0

    def record(self, launch: Launch, launch_s: float,
               exec_s: float = 0.0) -> None:
        ts = self.tiers.get(launch.tier)
        if ts is None:
            ts = self.tiers[launch.tier] = batching.TierStats(
                plan_batch=launch.tier)
        ts.record(launch.requests, launch_s, exec_s=exec_s)

    @property
    def request_images(self) -> int:
        return sum(t.request_images for t in self.tiers.values())

    @property
    def request_tokens(self) -> Optional[int]:
        """Tokens served (rows x lowered seq) — None for conv models."""
        if self.tokens_per_row is None:
            return None
        return self.request_images * self.tokens_per_row

    @property
    def padded_images(self) -> int:
        return sum(t.padded_images for t in self.tiers.values())

    @property
    def batches(self) -> int:
        return sum(t.batches for t in self.tiers.values())

    @property
    def delays_s(self) -> List[float]:
        return [d for t in self.tiers.values() for d in t.delays_s]

    @property
    def slo_attainment(self) -> float:
        """Fraction of requests launched within ``slo_ms`` of arrival
        (1.0 with no SLO set, or before anything was served)."""
        ds = self.delays_s
        if self.slo_ms is None or not ds:
            return 1.0
        bound = self.slo_ms / 1e3
        return sum(1 for d in ds if d <= bound) / len(ds)


@dataclass
class FleetStats:
    """One mixed-traffic fleet run: per-model breakdown plus aggregate
    effective / padded rates over the shared wall time."""

    models: Dict[str, ModelStats]
    wall_s: float
    warmup_steps: int
    shared_constants: bool

    @property
    def request_images(self) -> int:
        return sum(m.request_images for m in self.models.values())

    @property
    def padded_images(self) -> int:
        return sum(m.padded_images for m in self.models.values())

    @property
    def images_per_s(self) -> float:
        return self.request_images / max(self.wall_s, 1e-12)

    @property
    def padded_images_per_s(self) -> float:
        return self.padded_images / max(self.wall_s, 1e-12)

    @property
    def delays_s(self) -> List[float]:
        return [d for m in self.models.values() for d in m.delays_s]

    def delay_ms(self, q: float) -> float:
        """Fleet-wide queue-delay percentile over the POOLED per-model
        samples.  Never computed by averaging per-model percentiles —
        that is not a percentile of anything (a model serving 90% of
        the traffic must dominate the fleet tail, not count as one
        vote); the pooled nearest-rank value matches
        ``numpy.percentile(pooled, q, method="inverted_cdf")``."""
        return batching.percentile(self.delays_s, q) * 1e3

    @property
    def slo_attainment(self) -> float:
        """Request-weighted attainment across models with an SLO set
        (1.0 when none is)."""
        num = den = 0
        for m in self.models.values():
            if m.slo_ms is None:
                continue
            ds = m.delays_s
            den += len(ds)
            num += sum(1 for d in ds if d <= m.slo_ms / 1e3)
        return num / den if den else 1.0

    def describe(self) -> str:
        lines = [f"fleet: {self.request_images} request images "
                 f"({self.padded_images} padded) in {self.wall_s*1e3:.1f}ms"
                 f" = {self.images_per_s:.1f} images/s "
                 f"({self.padded_images_per_s:.1f} padded), "
                 f"slo_attainment={self.slo_attainment:.3f}, "
                 f"warmup_steps={self.warmup_steps}, "
                 f"shared_constants={self.shared_constants}"]
        if self.delays_s:
            lines.append(
                f"  all models pooled: queue-delay "
                f"p50={self.delay_ms(50):.2f}ms "
                f"p95={self.delay_ms(95):.2f}ms "
                f"p99={self.delay_ms(99):.2f}ms")
        for name, m in self.models.items():
            if not m.batches:
                continue
            ds = m.delays_s
            toks = ""
            if m.tokens_per_row is not None:
                tps = m.request_tokens / max(self.wall_s, 1e-12)
                toks = (f"{m.request_tokens} tokens "
                        f"({tps:.1f} tokens/s), ")
            dropped = (f"dropped_layers={m.dropped_layers}, "
                       if m.dropped_layers else "")
            lines.append(
                f"  {name}: {m.batches} batches, "
                f"{m.request_images}/{m.padded_images} images, {toks}"
                f"{dropped}"
                f"queue-delay p50={batching.percentile(ds, 50)*1e3:.2f}ms "
                f"p95={batching.percentile(ds, 95)*1e3:.2f}ms, "
                f"slo_attainment={m.slo_attainment:.3f}")
        return "\n".join(lines)


def fleet_mesh_for(mappings: Mapping[str, object], max_batch: int,
                   devices=None):
    """Largest serving mesh EVERY network in the fleet can shard onto:
    the gcd of the per-network macro sub-grids (`mesh.net_macro_grid`),
    leftover devices stacked along "data" — one shared mesh, so every
    model's ladder plans against the same device split
    (``devices=None``: every visible card)."""
    import math
    gr = gc = 0
    for nm in mappings.values():
        r, c = meshlib.net_macro_grid(nm)
        gr, gc = math.gcd(gr, r), math.gcd(gc, c)
    return meshlib.make_serving_mesh(max(gr, 1), max(gc, 1), max_batch,
                                     devices=devices)


def serve_fleet(mappings: Mapping[str, object], config: FleetConfig,
                trace: Sequence[TraceEvent], *, mesh=None,
                policy="mapped", warmup: int = 1, seed: int = 0,
                share_constants: bool = True,
                dropped_layers: Optional[Mapping[str, int]] = None,
                device: DeviceLike = None,
                clock: Callable[[], float] = time.perf_counter,
                sleep: Callable[[float], None] = time.sleep,
                ) -> Tuple[FleetStats, List[LaunchRecord]]:
    """Serve a tagged trace across the fleet's plan ladders on one
    device (default: the card) and ONE shared ``mesh`` (None: none).

    ``mappings`` maps each config model name to its `NetworkMapping` —
    conv nets and transformer lowerings
    (`launch.transformer.transformer_mapping`) mix freely; transformer
    models additionally report tokens/s (their `ModelStats` carry
    ``tokens_per_row``).  ``dropped_layers`` records, per model, how
    many layers `chainable_prefix` cut before serving.  Per model: a
    `batching.PlanLadder` (every tier compiled against the shared
    ``mesh``) plus — with ``share_constants`` (default) —
    one `exec.constants.PlanConstants` handle feeding every tier its
    pre-materialized shifted-weight blocks
    (`exec.constants.constant_counts` shows one materialization per
    network, not per tier).  ``warmup`` forwards per tier run before
    the clock starts; scheduling itself is :func:`run_fleet` on a
    :class:`FleetScheduler` (see the determinism invariant above).
    Each launch uploads its zero-padded host batch and ends in a device
    synchronize, so ``exec_s`` holds the device's work."""
    from ..device import resolve_device
    from ..exec import prepare_constants
    from .serve_cnn import serving_inputs
    from .transformer import tokens_per_row

    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    missing = [m.name for m in config.models if m.name not in mappings]
    if missing:
        raise KeyError(f"no mapping for fleet models {missing}")
    dev = resolve_device(device)

    sched = FleetScheduler(config, mesh=mesh)
    ladders: Dict[str, batching.PlanLadder] = {}
    kernels: Dict[str, list] = {}
    consts: Dict[str, object] = {}
    pools: Dict[str, np.ndarray] = {}
    for spec in config.models:
        nm = mappings[spec.name]
        ladder = batching.PlanLadder(nm, sched.tiers[spec.name], mesh=mesh,
                                     policy=policy, device=dev)
        ladders[spec.name] = ladder
        ks, pools[spec.name] = serving_inputs(nm, ladder.max_batch, seed,
                                              dev)
        kernels[spec.name] = ks
        if share_constants:
            # keyed on (net mapping, executors, kernel token): every
            # tier of this network fetches the SAME handle out of
            # memo.cached_constants
            consts[spec.name] = prepare_constants(
                ladder.plans[ladder.tiers[0]], ks,
                token=("serve_fleet", seed, str(dev)))

    def run_tier(name: str, tier: int, x_np):
        ladders[name].run(tier, kernels[name], x_np,
                          constants=consts.get(name))

    warmup_steps = 0
    for _ in range(warmup):
        for spec in config.models:       # load every tier up front
            for t in ladders[spec.name].tiers:
                run_tier(spec.name, t, pools[spec.name][:t])
                warmup_steps += 1

    stats = {m.name: ModelStats(
                 name=m.name, slo_ms=m.slo_ms,
                 tokens_per_row=tokens_per_row(mappings[m.name]),
                 dropped_layers=(dropped_layers or {}).get(m.name, 0))
             for m in config.models}
    t0 = clock()

    def execute(launch: Launch, launch_s: float) -> None:
        rows = launch.rows
        pool = pools[launch.model]
        x_np = np.zeros((launch.tier,) + pool.shape[1:], np.float32)
        x_np[:rows] = pool[:rows]           # padded rows stay zero
        t_ex = clock()
        run_tier(launch.model, launch.tier, x_np)
        stats[launch.model].record(launch, launch_s,
                                   exec_s=clock() - t_ex)

    records = run_fleet(sched, trace, clock=clock, sleep=sleep,
                        execute=execute)
    wall = clock() - t0
    return (FleetStats(models=stats, wall_s=wall,
                       warmup_steps=warmup_steps,
                       shared_constants=share_constants),
            records)
