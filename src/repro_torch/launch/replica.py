"""Multi-replica serving front-end: process-level scale-out (port of
``repro/launch/replica.py``; DESIGN.md §12).

One Python process serving every request is bounded by its one
dispatch thread — and the port's forward is host-bound.  This module
runs N worker processes, each with its own serving mesh, plan ladder and
CUDA context on the card, behind one load-aware router.

* **Workers** (:func:`_worker_main`) — one spawned process per replica
  (never forked: a forked child cannot use a CUDA context its parent
  made).  Each maps the network (the shared ``REPRO_MAPPING_CACHE``
  disk cache makes a warm cold-start skip the window search AND the
  plan compiles), builds a `batching.PlanLadder`, warms every tier (the
  kernels load from ``build/kernels``; build them before spawning, so
  start-up measures mapping and loading, not ``nvcc``), and then serves
  a max-delay coalescer fed by its private task queue.  Only host data
  crosses the queues (`batching.WorkItem`, tuples), never a tensor.  A
  worker whose device or kernel load fails reports ``MSG_DYING`` and
  the run raises; it never serves on another device.
* **Router** (:class:`ReplicaRouter`) — pure-Python load tracking:
  per-replica outstanding rows/requests, least-loaded dispatch,
  exactly-once accounting on `batching.WorkItem.seq`.  Health rides
  `runtime/recovery.py`: idle heartbeats feed `HeartbeatMonitor.beat`,
  batch completions feed ``report``, and a worker that misses its
  deadline — or whose process died — is declared dead ONCE, its
  outstanding items re-queued to the survivors.
* **Transports** — the router speaks to workers only through a
  queue-transport object: :class:`MpTransport` (spawn-context
  processes + multiprocessing queues) in production, and the
  deterministic `batching.InMemoryTransport` fake in tests.

Exactly-once contract: a request is counted served when its first
completion arrives; a completion for an already-served seq increments
``duplicate_serves`` instead of double-counting.  Crash injection
(``CTRL_DIE``) makes the worker flush its acknowledged completions
(queue close + join) before ``os._exit``, so with in-tree kill paths
``duplicate_serves == 0``; an external SIGKILL can at worst lose the
flush and degrade to at-least-once, which the counter makes visible.

    python -m repro_torch.launch.serve_cnn --net cnn8 --policy auto \
        --replicas 2 --max-delay-ms 2 --max-batch 4 --requests 48 \
        --cache-dir /tmp/mapping-cache
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..runtime.recovery import HeartbeatMonitor, StragglerPolicy
from . import batching
from .batching import (CTRL_DIE, CTRL_GO, CTRL_STOP, MSG_DONE, MSG_DYING,
                       MSG_HEARTBEAT, MSG_READY, MSG_STATS, WorkItem)


class NoSurvivorsError(RuntimeError):
    """Every replica is dead — there is nobody to re-queue work to."""


@dataclass(frozen=True)
class WorkerConfig:
    """Everything a worker process needs to build its serving stack —
    frozen and picklable (it crosses the spawn boundary).  ``layers``
    optionally serves a prefix of the named net (tests keep CPU time
    small that way); ``device`` is where every worker serves (each
    worker makes its own CUDA context on the card).  ``use_mesh`` gives
    each worker its own serving mesh (`mesh.serving_mesh_for`) over its
    visible cards, or over ``worker_devices`` host entries on a CPU
    worker (:func:`worker_mesh_devices`)."""

    net: str = "cnn8"
    array: Tuple[int, int] = (512, 512)
    alg: str = "TetrisG-SDK"
    grid: Optional[Tuple[int, int]] = None
    p_max: Optional[int] = None
    layers: Optional[int] = None
    groups: Tuple[int, ...] = (1, 2, 4)
    max_batch: int = 8
    max_delay_ms: float = 2.0
    adaptive_delay: bool = False
    policy: str = "mapped"
    seed: int = 0
    cache_dir: Optional[str] = None
    warmup: int = 1
    heartbeat_s: float = 0.05
    device: str = "cuda"
    use_mesh: bool = True
    worker_devices: Optional[int] = None


def worker_mesh_devices(cfg: WorkerConfig) -> list:
    """The devices a worker's serving mesh builds over: every visible
    card for a card worker, the one CPU for a CPU worker — or, with
    ``worker_devices=N``, N entries of it (the counterpart of the JAX
    worker's forced host devices).  A card worker's mesh spans the cards
    it sees, so ``worker_devices`` raises there instead of being
    ignored."""
    import torch
    from .mesh import visible_devices
    devices = visible_devices(cfg.device)
    if cfg.worker_devices is None:
        return devices
    if cfg.worker_devices < 1:
        raise ValueError(f"worker_devices must be >= 1, got "
                         f"{cfg.worker_devices}")
    if devices[0].type != "cpu":
        raise ValueError(
            f"worker_devices={cfg.worker_devices} repeats host entries in a "
            f"CPU worker's mesh; a card worker's mesh spans the "
            f"{torch.cuda.device_count()} visible card(s)")
    return devices * cfg.worker_devices


# ---------------------------------------------------------------------------
# Router — pure Python, fake-clock testable
# ---------------------------------------------------------------------------


@dataclass
class WorkerView:
    """The router's ledger for one replica: load (outstanding work it
    shipped there), serving stats accumulated from completion messages,
    and the start-up cost the worker reported when it came up."""

    wid: int
    alive: bool = True
    startup_s: float = 0.0
    table_misses: int = 0
    disk_hits: int = 0
    outstanding: Dict[int, WorkItem] = field(default_factory=dict)
    outstanding_rows: int = 0
    served_requests: int = 0
    served_rows: int = 0
    padded_rows: int = 0
    batches: int = 0
    exec_s: float = 0.0
    delays_s: List[float] = field(default_factory=list)


class ReplicaRouter:
    """Least-loaded dispatch + exactly-once completion accounting.

    Pure Python over explicit state — no clocks, no devices, no
    queues — so unit tests drive every dispatch/death/re-queue path
    directly.  The optional ``monitor`` (`runtime.HeartbeatMonitor`)
    carries liveness deadlines and straggler medians; the router feeds
    it (`on_heartbeat` → ``beat``, `on_batch_done` → ``report``) and
    consults it (`deadline_dead`), but death is always declared through
    :meth:`mark_dead`, which retires the worker from the monitor and
    hands back its outstanding items exactly once."""

    def __init__(self, n_replicas: int, *,
                 monitor: Optional[HeartbeatMonitor] = None):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        self.views = {w: WorkerView(w) for w in range(n_replicas)}
        self.monitor = monitor
        self.served: Dict[int, int] = {}        # seq -> serving wid
        self._owner: Dict[int, int] = {}        # seq -> current assignee
        self._seen: set = set()                 # every seq ever dispatched
        self.dispatched = 0                     # distinct seqs (len _seen)
        self.requeued = 0
        self.duplicate_serves = 0
        self.deaths = 0

    def alive_ids(self) -> List[int]:
        return [w for w, v in self.views.items() if v.alive]

    def load(self, wid: int) -> int:
        """Outstanding rows shipped to ``wid`` (queued + in-flight from
        the router's view — the worker batches them on its own)."""
        return self.views[wid].outstanding_rows

    def dispatch(self, item: WorkItem) -> int:
        """Assign ``item`` to the least-loaded live replica (ties to
        fewer outstanding requests, then lowest wid — deterministic)."""
        alive = self.alive_ids()
        if not alive:
            raise NoSurvivorsError(
                f"request seq={item.seq} has no live replica to go to")
        wid = min(alive, key=lambda w: (self.views[w].outstanding_rows,
                                        len(self.views[w].outstanding), w))
        v = self.views[wid]
        if item.seq not in self._seen:      # re-queues don't count twice
            self._seen.add(item.seq)
            self.dispatched += 1
        v.outstanding[item.seq] = item
        v.outstanding_rows += item.rows
        self._owner[item.seq] = wid
        return wid

    def on_ready(self, wid: int, startup_s: float, table_misses: int = 0,
                 disk_hits: int = 0) -> None:
        v = self.views[wid]
        v.startup_s = startup_s
        v.table_misses, v.disk_hits = table_misses, disk_hits

    def on_heartbeat(self, wid: int) -> None:
        if self.monitor is not None and self.views[wid].alive:
            self.monitor.beat(wid)

    def on_batch_done(self, wid: int, tier: int,
                      entries: Sequence[Tuple[int, int, float]],
                      exec_s: float = 0.0) -> int:
        """Account one completed batch; returns how many of its
        requests were NEW (first completion).  A seq already served —
        possible only when a re-queued item's original owner turned out
        to have served it before dying — bumps ``duplicate_serves``
        and is not double-counted."""
        v = self.views[wid]
        v.batches += 1
        v.padded_rows += tier
        v.exec_s += exec_s
        new = 0
        for seq, rows, delay_s in entries:
            if seq in self.served:
                self.duplicate_serves += 1
                continue
            self.served[seq] = wid
            new += 1
            v.served_requests += 1
            v.served_rows += rows
            v.delays_s.append(delay_s)
            owner = self._owner.pop(seq, None)
            if owner is not None:
                o = self.views[owner]
                it = o.outstanding.pop(seq, None)
                if it is not None:
                    o.outstanding_rows -= it.rows
        if self.monitor is not None and v.alive:
            self.monitor.report(wid, exec_s)
        return new

    def mark_dead(self, wid: int) -> List[WorkItem]:
        """Declare ``wid`` dead (idempotent) and return its outstanding
        items in seq order — the caller re-dispatches them to
        survivors.  Already-served seqs never appear here: completions
        removed them from the ledger."""
        v = self.views[wid]
        if not v.alive:
            return []
        v.alive = False
        self.deaths += 1
        if self.monitor is not None:
            self.monitor.forget(wid)
        items = [v.outstanding[s] for s in sorted(v.outstanding)]
        v.outstanding.clear()
        v.outstanding_rows = 0
        for it in items:
            self._owner.pop(it.seq, None)
        self.requeued += len(items)
        return items

    def deadline_dead(self) -> List[int]:
        """Live workers whose heartbeat deadline has expired per the
        monitor (empty without one)."""
        if self.monitor is None:
            return []
        return [w for w in self.monitor.dead_workers()
                if w in self.views and self.views[w].alive]

    def incomplete(self) -> int:
        return self.dispatched - len(self.served)


# ---------------------------------------------------------------------------
# Aggregate stats
# ---------------------------------------------------------------------------


@dataclass
class ReplicaStats:
    """One multi-replica run: per-worker ledgers plus pooled aggregate
    rates and queue-delay percentiles over the shared wall time."""

    workers: Dict[int, WorkerView]
    wall_s: float
    requeued: int
    duplicate_serves: int
    deaths: int
    stragglers: Dict[int, str] = field(default_factory=dict)

    @property
    def request_images(self) -> int:
        return sum(v.served_rows for v in self.workers.values())

    @property
    def padded_images(self) -> int:
        return sum(v.padded_rows for v in self.workers.values())

    @property
    def images_per_s(self) -> float:
        return self.request_images / max(self.wall_s, 1e-12)

    @property
    def padded_images_per_s(self) -> float:
        return self.padded_images / max(self.wall_s, 1e-12)

    @property
    def delays_s(self) -> List[float]:
        return [d for v in self.workers.values() for d in v.delays_s]

    def delay_ms(self, q: float) -> float:
        """Aggregate queue-delay percentile over the POOLED per-replica
        samples — the same never-average-percentiles contract as
        `batching.DynamicServeStats.delay_ms`."""
        return batching.percentile(self.delays_s, q) * 1e3

    def describe(self) -> str:
        n = len(self.workers)
        lines = [f"replicas: {n} workers ({self.deaths} died), "
                 f"{self.request_images} request images "
                 f"({self.padded_images} padded) in {self.wall_s*1e3:.1f}ms"
                 f" = {self.images_per_s:.1f} images/s "
                 f"({self.padded_images_per_s:.1f} padded), "
                 f"requeued={self.requeued}, "
                 f"duplicate_serves={self.duplicate_serves}"]
        if self.delays_s:
            lines.append(f"  pooled queue-delay p50={self.delay_ms(50):.2f}ms"
                         f" p95={self.delay_ms(95):.2f}ms "
                         f"p99={self.delay_ms(99):.2f}ms")
        for wid in sorted(self.workers):
            v = self.workers[wid]
            state = "" if v.alive else " DEAD"
            strag = (f" straggler={self.stragglers[wid]}"
                     if wid in self.stragglers else "")
            lines.append(
                f"  w{wid}{state}{strag}: startup {v.startup_s*1e3:.0f}ms "
                f"(table_builds={v.table_misses} disk_hits={v.disk_hits}), "
                f"{v.served_requests} requests / {v.served_rows} images "
                f"in {v.batches} batches")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


def _build_mapping(cfg: WorkerConfig):
    """Map the configured net inside the worker (disk cache warm → no
    table builds); split out so tests can build the single-process
    baseline from the exact same mapping."""
    from ..core import (ArrayConfig, MacroGrid, grid_search, map_net,
                        networks)
    layers = networks.NETWORKS[cfg.net]()
    if cfg.layers is not None:
        layers = layers[:cfg.layers]
    kw = {"groups": tuple(cfg.groups)} if cfg.alg == "TetrisG-SDK" else {}
    array = ArrayConfig(*cfg.array)
    if cfg.p_max is not None:
        return grid_search(cfg.net, layers, array, cfg.p_max, cfg.alg,
                           **kw).best
    grid = MacroGrid(*cfg.grid) if cfg.grid is not None else MacroGrid()
    return map_net(cfg.net, layers, array, cfg.alg, grid, **kw)


def _worker_main(wid: int, cfg: WorkerConfig, task_q, result_q) -> None:
    """One replica process: build (measured), announce ready, wait for
    GO, serve until STOP.  Runs in a fresh spawn-context interpreter
    with its own CUDA context."""
    import os
    import queue as queue_mod
    t_start = time.perf_counter()
    try:
        from ..core import memo
        if cfg.cache_dir is not None:
            memo.set_disk_cache(cfg.cache_dir)
        import numpy as np
        from ..device import resolve_device
        from . import mesh as meshlib
        from .serve_cnn import serving_inputs

        dev = resolve_device(cfg.device)
        mapping = _build_mapping(cfg)
        mesh = (meshlib.serving_mesh_for(mapping, cfg.max_batch,
                                         worker_mesh_devices(cfg))
                if cfg.use_mesh else None)
        tiers = batching.batch_tiers(cfg.max_batch, mesh)
        ladder = batching.PlanLadder(mapping, tiers, mesh=mesh,
                                     policy=cfg.policy, device=dev)
        ks, pool = serving_inputs(mapping, ladder.max_batch, cfg.seed, dev)
        shape = pool.shape[1:]
        for _ in range(max(cfg.warmup, 0)):
            for t in ladder.tiers:
                ladder.run(t, ks, pool[:t])
        st = memo.snapshot()
        result_q.put((MSG_READY, wid, time.perf_counter() - t_start,
                      int(st["table_misses"]), int(st["disk_hits"])))
    except BaseException as e:          # startup failed: say so, then die
        result_q.put((MSG_DYING, wid, f"startup: {e!r}"))
        raise

    epoch = None                        # the router's shared clock zero
    while epoch is None:
        msg = task_q.get()
        if isinstance(msg, tuple) and msg[0] == CTRL_GO:
            epoch = float(msg[1])
        elif isinstance(msg, tuple) and msg[0] == CTRL_DIE:
            os._exit(1)

    def now_fn() -> float:
        # wall clock relative to the router's epoch: the one clock all
        # processes on this host share, so queue delays (launch minus
        # router-stamped arrival) are measured consistently
        return time.time() - epoch

    delay_policy = (batching.AdaptiveDelay(cfg.max_delay_ms / 1e3,
                                           cfg.max_batch)
                    if cfg.adaptive_delay else None)
    co = batching.Coalescer(cfg.max_batch, cfg.max_delay_ms / 1e3,
                            delay_policy=delay_policy)
    served_rows = padded_rows = batches = 0
    stopping = False
    try:
        while True:
            # how long may the first (blocking) get wait: until the
            # coalescer's deadline, capped by the heartbeat interval
            if len(co):
                dl = co.next_deadline()
                block_s = (0.0 if dl is None else
                           max(0.0, min(cfg.heartbeat_s, dl - now_fn())))
            elif stopping:
                block_s = 0.0
            else:
                block_s = cfg.heartbeat_s
            first_wait = True
            while True:                 # drain everything available now
                try:
                    if first_wait and block_s > 0:
                        msg = task_q.get(timeout=block_s)
                    else:
                        msg = task_q.get_nowait()
                except queue_mod.Empty:
                    break
                first_wait = False
                if isinstance(msg, WorkItem):
                    co.push(msg.rows, msg.arrival_s, payload=msg)
                elif msg[0] == CTRL_STOP:
                    stopping = True
                elif msg[0] == CTRL_DIE:
                    # crash injection: flush acknowledged completions
                    # (so finished work is not replayed), then vanish
                    # WITHOUT draining the coalescer or the task queue
                    result_q.put((MSG_DYING, wid, "killed"))
                    result_q.close()
                    result_q.join_thread()
                    os._exit(1)
            now = now_fn()
            result_q.put((MSG_HEARTBEAT, wid, now))
            batch = co.pop(now, force=stopping)
            if batch:
                rows = sum(r.rows for r in batch)
                tier, _ = ladder.plan_for(rows)
                x_np = np.zeros((tier,) + shape, np.float32)
                x_np[:rows] = pool[:rows]   # padded rows stay zero
                launch = now_fn()
                ladder.run(tier, ks, x_np)
                exec_s = now_fn() - launch
                entries = tuple((r.payload.seq, r.rows,
                                 launch - r.arrival_s) for r in batch)
                result_q.put((MSG_DONE, wid, tier, entries, exec_s))
                served_rows += rows
                padded_rows += tier
                batches += 1
            elif stopping and not len(co):
                result_q.put((MSG_STATS, wid, served_rows, padded_rows,
                              batches))
                break
    except BaseException as e:
        result_q.put((MSG_DYING, wid, f"serve: {e!r}"))
        raise


class MpTransport:
    """Real process-level transport: one spawn-context ``Process`` +
    task ``Queue`` per worker, one shared result ``Queue`` back.  Spawn
    (never fork): the parent may have initialized CUDA, which a forked
    child cannot use; each worker comes up with its own CUDA context."""

    blocks = True

    def __init__(self):
        import multiprocessing as mp
        self._ctx = mp.get_context("spawn")
        self.result_q = self._ctx.Queue()
        self._procs: Dict[int, object] = {}
        self._task_qs: Dict[int, object] = {}

    def start_worker(self, wid: int, cfg: WorkerConfig) -> None:
        q = self._ctx.Queue()
        p = self._ctx.Process(target=_worker_main,
                              args=(wid, cfg, q, self.result_q),
                              daemon=True, name=f"replica-w{wid}")
        p.start()
        self._task_qs[wid] = q
        self._procs[wid] = p

    def send(self, wid: int, msg) -> None:
        self._task_qs[wid].put(msg)

    def poll(self, timeout: float = 0.0):
        import queue as queue_mod
        try:
            if timeout > 0:
                return self.result_q.get(True, timeout)
            return self.result_q.get_nowait()
        except queue_mod.Empty:
            return None

    def alive(self, wid: int) -> bool:
        return self._procs[wid].is_alive()

    def kill(self, wid: int) -> None:
        """Hard-kill a worker (SIGKILL) — the ungraceful death path."""
        self._procs[wid].kill()

    def join(self, timeout: float = 10.0) -> None:
        for p in self._procs.values():
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join(1.0)


# ---------------------------------------------------------------------------
# Serve loop
# ---------------------------------------------------------------------------


def serve_replicas(trace: Sequence[Tuple[float, int]], cfg: WorkerConfig,
                   n_replicas: int, *, transport=None,
                   dead_after_s: float = 5.0,
                   straggler: Optional[StragglerPolicy] = None,
                   kill_worker: Optional[int] = None,
                   kill_after_batches: int = 0,
                   clock=time.time, sleep=time.sleep,
                   tick_s: float = 0.02,
                   ready_timeout_s: float = 600.0) -> ReplicaStats:
    """Serve ``trace`` (``(arrival_s, rows)`` pairs, relative seconds —
    e.g. `serve_cnn.poisson_arrivals`) across ``n_replicas`` workers.

    Phases: spawn every worker and wait until all report READY (their
    measured start-up cost lands in the stats — this is where a warm
    disk cache pays); stamp ``t0`` and broadcast GO with the shared
    epoch; then the dispatch loop pushes each arrival to the
    least-loaded live replica as its time comes, folds completion /
    heartbeat messages into the router, and re-queues the outstanding
    work of any replica that died (process gone, DYING received, or
    heartbeat deadline missed).  ``kill_worker`` injects a crash: once
    that worker has ``kill_after_batches`` batches done and work
    outstanding, it is told to die — the lossless-recovery test path.

    ``transport`` defaults to real processes (:class:`MpTransport`);
    tests pass a `batching.InMemoryTransport` plus fake ``clock`` /
    ``sleep`` and the whole loop runs deterministically in-process."""
    if n_replicas < 1:
        raise ValueError(f"need >= 1 replica, got {n_replicas}")
    trace = tuple(trace)
    big = max((r for _, r in trace), default=0)
    if big > cfg.max_batch:
        raise ValueError(f"request of {big} rows exceeds max_batch="
                         f"{cfg.max_batch} — requests are never split")
    if kill_worker is not None and not 0 <= kill_worker < n_replicas:
        raise ValueError(f"kill_worker={kill_worker} not in "
                         f"[0, {n_replicas})")
    if cfg.use_mesh and cfg.worker_devices is not None:
        worker_mesh_devices(cfg)    # refuse here, before any spawn
    transport = MpTransport() if transport is None else transport

    def _run() -> ReplicaStats:
        # --- phase 1: wait for every worker's READY (startup measured) ---
        ready: Dict[int, Tuple[float, int, int]] = {}
        t_limit = clock() + ready_timeout_s
        while len(ready) < n_replicas:
            msg = transport.poll(tick_s)
            if msg is None:
                if not transport.blocks:
                    sleep(tick_s)
                gone = [w for w in range(n_replicas)
                        if w not in ready and not transport.alive(w)]
                if gone:        # exited before it could say DYING
                    raise RuntimeError(
                        f"replica {gone[0]} died during startup")
                if clock() > t_limit:
                    raise RuntimeError(
                        f"only {len(ready)}/{n_replicas} replicas became "
                        f"ready within {ready_timeout_s}s")
                continue
            if msg[0] == MSG_READY:
                ready[msg[1]] = (msg[2], msg[3], msg[4])
            elif msg[0] == MSG_DYING:
                raise RuntimeError(
                    f"replica {msg[1]} died during startup: {msg[2]}")

        # --- phase 2: GO — one shared epoch, then dispatch the trace ---
        t0 = clock()
        monitor = HeartbeatMonitor(n_replicas, dead_after_s=dead_after_s,
                                   policy=straggler,
                                   clock=lambda: clock() - t0)
        router = ReplicaRouter(n_replicas, monitor=monitor)
        for wid, (s, misses, hits) in ready.items():
            router.on_ready(wid, s, misses, hits)
        for wid in range(n_replicas):
            transport.send(wid, (CTRL_GO, t0))

        def requeue(wid: int) -> None:
            for it in router.mark_dead(wid):
                transport.send(router.dispatch(it), it)

        pending = deque(sorted(trace, key=lambda e: e[0]))
        seq = 0
        killed = False
        while pending or router.incomplete():
            now = clock() - t0
            while pending and pending[0][0] <= now:
                arrival, rows = pending.popleft()
                item = WorkItem(seq, rows, arrival)
                seq += 1
                transport.send(router.dispatch(item), item)
            if (kill_worker is not None and not killed
                    and router.views[kill_worker].alive
                    and router.load(kill_worker) > 0
                    and router.views[kill_worker].batches
                    >= kill_after_batches):
                transport.send(kill_worker, (CTRL_DIE,))
                killed = True
            timeout = tick_s
            if pending:
                timeout = min(tick_s, max(0.0, pending[0][0] - now))
            progressed = False
            msg = transport.poll(timeout)
            while msg is not None:
                head = msg[0]
                if head == MSG_HEARTBEAT:
                    router.on_heartbeat(msg[1])
                elif head == MSG_DONE:
                    router.on_batch_done(msg[1], msg[2], msg[3], msg[4])
                    progressed = True
                elif head == MSG_DYING:
                    # FIFO per producer: all its earlier DONEs are already
                    # folded in, so the re-queue set is exact
                    requeue(msg[1])
                    progressed = True
                elif head == MSG_STATS:
                    progressed = True       # late stats from a stopper
                msg = transport.poll(0.0)
            for wid in router.alive_ids():
                if not transport.alive(wid):
                    requeue(wid)
                    progressed = True
            for wid in router.deadline_dead():
                requeue(wid)
                progressed = True
            if not progressed and not transport.blocks:
                # fake transports never wait in poll: idle time must pass
                # through the injected sleep (advancing the fake clock)
                sleep(timeout if timeout > 0 else tick_s)
        wall = clock() - t0

        # --- phase 3: drain worker-side stats, shut down ---
        stragglers = dict(monitor.stragglers())
        expecting = set(router.alive_ids())
        for wid in expecting:
            transport.send(wid, (CTRL_STOP,))
        t_limit = clock() + ready_timeout_s
        while expecting and clock() <= t_limit:
            msg = transport.poll(tick_s)
            if msg is None:
                if not transport.blocks:
                    sleep(tick_s)
                expecting = {w for w in expecting if transport.alive(w)}
                continue
            if msg[0] == MSG_STATS:
                expecting.discard(msg[1])
            elif msg[0] == MSG_DYING:
                expecting.discard(msg[1])
        transport.join()
        return ReplicaStats(workers=router.views, wall_s=wall,
                            requeued=router.requeued,
                            duplicate_serves=router.duplicate_serves,
                            deaths=router.deaths, stragglers=stragglers)

    started = []
    try:
        for wid in range(n_replicas):
            transport.start_worker(wid, cfg)
            started.append(wid)
        return _run()
    except BaseException:
        # a failed run stops every worker it started
        for wid in started:
            transport.kill(wid)
        transport.join()
        raise
