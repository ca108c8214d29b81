"""Dynamic batching for the compiled-plan serve path (port of
``repro/launch/batching.py``; DESIGN.md §7).

Arrival-driven serving keeps the forward path one compiled plan per
batch size:

* :class:`Coalescer` — a FIFO request queue with **max-delay
  coalescing**: arrivals accumulate until either the queued rows reach
  ``max_batch`` or the *oldest* request has waited ``max_delay_s``; the
  drain then releases the longest FIFO prefix of whole requests that
  fits ``max_batch`` (never split, never reordered — arrival order is
  the latency contract).  The API takes explicit ``now`` timestamps so
  tests drive it with a fake clock.
* :class:`AdaptiveDelay` — a load-proportional max-delay policy: the
  effective coalescing delay shrinks as the queue deepens, plugged into
  the coalescer as ``delay_policy``.
* :class:`VClock` — fake time for the serving loops: one trace replays
  to one schedule.
* :func:`batch_tiers` / :class:`PlanLadder` — a small **power-of-two
  ladder of plan batches**, each compiled once via
  `repro_torch.exec.compile_plan` (memoized through
  ``memo.cached_plan``).  A coalesced batch pads to the smallest tier
  that fits instead of one fixed plan batch; every tier is padded to the
  serving mesh's "data" axis (`mesh.pad_to_data_axis`).
* :class:`TierStats` / :class:`DynamicServeStats` — per-tier effective
  vs padded images plus queue-delay percentiles, the report
  `launch/serve_cnn.serve_dynamic` prints per tier.
* :class:`InputRing` — feeds the fixed-batch loop one device input.
* :class:`WorkItem` + :class:`InMemoryTransport` — the queue-transport
  abstraction behind the multi-replica tier (`launch/replica.py`): the
  router ships :class:`WorkItem` objects to worker queues and reads tuple
  messages (``MSG_*`` heads) off one shared result channel.  The
  in-memory transport is the injectable fake of `replica.MpTransport`:
  workers are caller-supplied objects stepped synchronously inside
  :meth:`InMemoryTransport.poll`, so a fake clock drives the whole
  multi-replica loop deterministically.

Queue, tier and stats logic is pure Python and touches no device (this
module imports torch only inside :class:`InputRing` and
:class:`PlanLadder`): it is tested under a fake clock, and gives the JAX
package's schedules on the same trace.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Callable, Deque, Dict, List, Optional,
                    Sequence, Tuple)

import numpy as np

from . import mesh as meshlib

if TYPE_CHECKING:
    import torch

    from ..device import DeviceLike


@dataclass(frozen=True)
class Request:
    """One queued arrival: ``rows`` images that arrived at ``arrival_s``
    (seconds on the caller's clock).  ``payload`` is opaque to the
    coalescer (a serving loop stores host-side image rows there).
    ``model`` tags the request with its target network for fleet serving
    (`launch/fleet.FleetScheduler`); single-model serving leaves it
    None."""

    rows: int
    arrival_s: float
    payload: object = None
    model: Optional[str] = None


@dataclass(frozen=True)
class AdaptiveDelay:
    """Load-proportional coalescing delay.

    A fixed ``max_delay_s`` trades the head request's latency for fill
    regardless of load; under a deep backlog that wait buys nothing —
    the next tier is already full — while at idle it is exactly the
    bound that lets a second request share the batch.  This policy
    scales the effective delay linearly DOWN with observed queue depth:

        delay(queued_rows) = max_delay_s * max(0, 1 - queued_rows/ref_rows)

    so an empty-ish queue waits up to the cap and a queue at
    ``ref_rows`` (typically ``max_batch``) drains immediately.  Pure
    and stateless: the coalescer consults it with its current depth
    inside :meth:`Coalescer.next_deadline`, so the same explicit-``now``
    fake-clock tests cover it."""

    max_delay_s: float
    ref_rows: int

    def __post_init__(self):
        if self.max_delay_s < 0:
            raise ValueError(
                f"max_delay_s must be >= 0, got {self.max_delay_s}")
        if self.ref_rows < 1:
            raise ValueError(f"ref_rows must be >= 1, got {self.ref_rows}")

    def __call__(self, queued_rows: int) -> float:
        return self.max_delay_s * max(0.0, 1.0 - queued_rows / self.ref_rows)


class Coalescer:
    """Max-delay request coalescer: drain arrivals into ready batches.

    A batch becomes ready when the queued rows reach ``max_batch``
    (max-batch trigger) or the oldest queued request is ``max_delay_s``
    old (max-delay expiry — bounded worst-case queueing latency).
    Requests are whole units and stay in arrival order: :meth:`pop`
    releases the longest FIFO *prefix* that fits ``max_batch`` — it
    never splits a request, and never skips past a non-fitting request
    to a smaller one behind it (reordering would trade the head
    request's latency bound away for fill).  A request larger than
    ``max_batch`` is refused at :meth:`push`.  All methods take ``now``
    explicitly — the caller owns the clock, which makes the expiry
    logic exactly testable.

    ``delay_policy`` (e.g. :class:`AdaptiveDelay`) makes the delay
    load-proportional: it is called with the current queued rows and
    returns the effective delay, clamped to ``[0, max_delay_s]`` —
    ``max_delay_s`` stays the worst-case latency bound either way.
    """

    def __init__(self, max_batch: int, max_delay_s: float, *,
                 delay_policy: Optional[Callable[[int], float]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(
                f"max_delay_s must be >= 0, got {max_delay_s}")
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.delay_policy = delay_policy
        self._q: Deque[Request] = deque()
        self._rows = 0

    def effective_delay_s(self) -> float:
        """The delay in force at the current queue depth: the policy's
        answer clamped to ``[0, max_delay_s]``, or ``max_delay_s``
        without a policy."""
        if self.delay_policy is None:
            return self.max_delay_s
        return min(max(float(self.delay_policy(self._rows)), 0.0),
                   self.max_delay_s)

    def __len__(self) -> int:
        """Queued images (rows, not requests)."""
        return self._rows

    @property
    def requests(self) -> int:
        return len(self._q)

    def push(self, rows: int, now: float, payload: object = None,
             model: Optional[str] = None) -> None:
        if rows < 1:
            raise ValueError(f"request must carry >= 1 row, got {rows}")
        if rows > self.max_batch:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch="
                f"{self.max_batch} — requests are never split")
        self._q.append(Request(rows, now, payload, model))
        self._rows += rows

    def next_deadline(self) -> Optional[float]:
        """When the oldest queued request expires (max-delay), or None
        on an empty queue — the latest moment the server may sleep to.
        With a ``delay_policy`` the deadline moves EARLIER as the queue
        deepens (it is re-derived from the live depth on every call, so
        a push can only shrink it — callers that sleep to a stale
        deadline wake late but never starve: the policy is clamped by
        ``max_delay_s``)."""
        if not self._q:
            return None
        return self._q[0].arrival_s + self.effective_delay_s()

    def ready(self, now: float) -> bool:
        if not self._q:
            return False
        return self._rows >= self.max_batch or now >= self.next_deadline()

    def pop(self, now: float, force: bool = False) -> List[Request]:
        """The longest ready FIFO prefix (whole requests, ``<=
        max_batch`` rows, arrival order preserved), or ``[]`` when
        nothing is ready yet.  ``force=True`` drains regardless of the
        delay deadline (the final flush once no further arrival can grow
        the batch); an empty queue drains to ``[]`` either way."""
        if not self._q or not (force or self.ready(now)):
            return []
        batch: List[Request] = []
        rows = 0
        while self._q and rows + self._q[0].rows <= self.max_batch:
            r = self._q.popleft()
            batch.append(r)
            rows += r.rows
        self._rows -= rows
        return batch


class VClock:
    """Fake time for the serving loops' ``clock``/``sleep`` arguments:
    only ``sleep`` advances it, so one trace replays to one schedule."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        # a loop sleeping no time on a fake clock would spin forever
        assert dt > 0, dt
        self.t += dt


def batch_tiers(max_batch: int, mesh=None) -> Tuple[int, ...]:
    """The plan-batch ladder: powers of two up to ``max_batch`` (the top
    tier covers it exactly), each padded to the serving mesh's "data"
    axis and deduplicated — e.g. ``(1, 2, 4, 6)`` for ``max_batch=6``
    without a mesh, ``(2, 4, 8)`` for ``max_batch=8`` on a data=2 mesh.
    Ascending, so :func:`tier_for` is a linear scan."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    tiers: List[int] = []
    b = 1
    while True:
        t = meshlib.pad_to_data_axis(min(b, max_batch), mesh)
        if not tiers or t > tiers[-1]:
            tiers.append(t)
        if b >= max_batch:
            break
        b *= 2
    return tuple(tiers)


def tier_for(rows: int, tiers: Sequence[int]) -> int:
    """Smallest tier that fits ``rows`` (the batch then pads to it)."""
    for t in tiers:
        if rows <= t:
            return t
    raise ValueError(f"{rows} rows exceed the largest tier {max(tiers)}")


class PlanLadder:
    """``compile_plan`` at every tier of the ladder, all on one device and
    one serving mesh (None: no mesh): a coalesced batch pads to
    ``tier_for(rows)`` instead of one fixed plan batch.  Tier plans come
    out of ``memo.cached_plan`` (exec/plan.py), so each tier compiles
    once per process — or never, with a warm disk cache;
    `repro_torch.exec.plan.compile_counts` gives the per-key evidence."""

    def __init__(self, net_mapping, tiers: Sequence[int], *, mesh=None,
                 policy="mapped", lookahead: Optional[int] = None,
                 block: Optional[str] = None,
                 vmem_budget: Optional[int] = None,
                 device: DeviceLike = None):
        from ..device import resolve_device
        from ..exec import compile_plan
        self.tiers = tuple(sorted(set(int(t) for t in tiers)))
        if not self.tiers:
            raise ValueError("ladder needs at least one tier")
        for t in self.tiers:
            if meshlib.pad_to_data_axis(t, mesh) != t:
                raise ValueError(
                    f"tier {t} does not divide the mesh data axis "
                    f"{meshlib.data_axis_size(mesh)} — build tiers with "
                    f"batch_tiers(max_batch, mesh)")
        self.mesh = mesh
        self.device = resolve_device(device)
        # policy is any compile_plan PolicyLike (a name, "auto"/"tuned",
        # a per-layer tuple); lookahead / block / vmem_budget pass
        # through unset (None) so "tuned" can fill them per plan
        self.plans = {t: compile_plan(net_mapping, executor_policy=policy,
                                      mesh=mesh, batch=t,
                                      lookahead=lookahead,
                                      block=block, vmem_budget=vmem_budget,
                                      device=self.device)
                      for t in self.tiers}

    @property
    def max_batch(self) -> int:
        return self.tiers[-1]

    def plan_for(self, rows: int):
        """``(tier, plan)`` serving a ``rows``-image coalesced batch."""
        t = tier_for(rows, self.tiers)
        return t, self.plans[t]

    def run(self, tier: int, kernels, x_host, constants=None):
        """One served batch: upload the host batch (its spare rows zero)
        to the ladder's device, run the tier's plan and wait for the
        device, so a clock around the call holds the device's work."""
        import torch
        from ..device import synchronize
        from ..exec import execute_plan
        y = execute_plan(self.plans[tier], kernels,
                         torch.as_tensor(x_host, device=self.device),
                         mesh=self.mesh, constants=constants)
        synchronize(self.device)
        return y


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty sequence —
    enough for latency reporting without pulling numpy into the queue
    layer."""
    if not xs:
        raise ValueError("percentile of an empty sequence")
    if not 0 <= q <= 100:
        raise ValueError(f"q must be in [0, 100], got {q}")
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q / 100 * len(s)) - 1))]


@dataclass
class TierStats:
    """Served-batch accounting for ONE tier of the ladder: effective
    (request) vs padded (plan) images, plus per-request queue delays
    (batch launch minus arrival)."""

    plan_batch: int
    batches: int = 0
    request_images: int = 0
    padded_images: int = 0
    exec_s: float = 0.0
    delays_s: List[float] = field(default_factory=list)

    def record(self, batch: Sequence[Request], launch_s: float,
               exec_s: float = 0.0) -> None:
        self.batches += 1
        rows = sum(r.rows for r in batch)
        self.request_images += rows
        self.padded_images += self.plan_batch
        self.exec_s += exec_s
        self.delays_s.extend(launch_s - r.arrival_s for r in batch)

    def delay_ms(self, q: float) -> float:
        return percentile(self.delays_s, q) * 1e3


@dataclass
class DynamicServeStats:
    """One arrival-driven serving run: per-tier breakdown plus the
    aggregate effective / padded rates over the measured wall time."""

    tiers: Dict[int, TierStats]
    request_images: int
    padded_images: int
    wall_s: float
    warmup_steps: int           # actual warmup executions (0 honored)

    @property
    def images_per_s(self) -> float:
        return self.request_images / max(self.wall_s, 1e-12)

    @property
    def padded_images_per_s(self) -> float:
        return self.padded_images / max(self.wall_s, 1e-12)

    @property
    def delays_s(self) -> List[float]:
        return [d for t in self.tiers.values() for d in t.delays_s]

    def delay_ms(self, q: float) -> float:
        """Aggregate queue-delay percentile over the POOLED per-tier
        delay samples — never an average of per-tier percentiles, which
        is not a percentile of anything (a tier with 3 fast batches
        would weigh as much as one with 300 slow ones)."""
        return percentile(self.delays_s, q) * 1e3

    def describe(self) -> str:
        lines = [f"dynamic: {self.request_images} request images "
                 f"({self.padded_images} padded) in {self.wall_s*1e3:.1f}ms"
                 f" = {self.images_per_s:.1f} images/s "
                 f"({self.padded_images_per_s:.1f} padded), "
                 f"warmup_steps={self.warmup_steps}"]
        if self.delays_s:
            lines.append(
                f"  all tiers pooled: queue-delay "
                f"p50={self.delay_ms(50):.2f}ms "
                f"p95={self.delay_ms(95):.2f}ms "
                f"p99={self.delay_ms(99):.2f}ms")
        for t in sorted(self.tiers):
            ts = self.tiers[t]
            if not ts.batches:
                continue
            lines.append(
                f"  tier {t}: {ts.batches} batches, "
                f"{ts.request_images}/{ts.padded_images} images, "
                f"queue-delay p50={ts.delay_ms(50):.2f}ms "
                f"p95={ts.delay_ms(95):.2f}ms p99={ts.delay_ms(99):.2f}ms")
        return "\n".join(lines)


class InputRing:
    """Device-input feeder for the steady-state serve loop.

    The JAX package re-uploads a fresh buffer per step when the program
    consumes (donates) its input.  Torch has no donation, so the one
    buffer uploaded at construction is fed to every step and
    :meth:`next` is free; ``donated`` is always False."""

    def __init__(self, x_host, *, device: torch.device):
        import torch
        self.donated = False
        self._dev = torch.as_tensor(np.asarray(x_host, np.float32),
                                    device=device)

    def next(self) -> torch.Tensor:
        """The device buffer to feed this step."""
        return self._dev


# ---------------------------------------------------------------------------
# Queue transport — the multi-replica tier's wire format (launch/replica.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkItem:
    """One routed request in the multi-replica tier: what the router
    ships to a worker's task queue.  ``seq`` is the router-assigned
    request id — the exactly-once accounting key: completions dedupe on
    it, and a dead worker's outstanding seqs are re-queued to survivors
    (`launch/replica.ReplicaRouter`).  ``rows``/``arrival_s`` mean what
    they do on :class:`Request`; the payload stays synthetic worker-side
    (no arrays cross the queue)."""

    seq: int
    rows: int
    arrival_s: float
    model: Optional[str] = None


# Message heads on the shared worker->router result channel.  Tuples,
# not classes: they must pickle cheaply across process boundaries and
# stay greppable in both transports.
MSG_READY = "ready"        # (MSG_READY, wid, startup_s, table_misses, disk_hits)
MSG_HEARTBEAT = "hb"       # (MSG_HEARTBEAT, wid, now_s)
MSG_DONE = "done"          # (MSG_DONE, wid, tier, ((seq, rows, delay_s), ...), exec_s)
MSG_DYING = "dying"        # (MSG_DYING, wid, reason) — flushed before death
MSG_STATS = "stats"        # (MSG_STATS, wid, served_rows, padded_rows, batches)

# Router->worker control messages (WorkItems ride the same task queue).
CTRL_GO = "go"             # (CTRL_GO, epoch_s): start serving, shared clock zero
CTRL_STOP = "stop"         # (CTRL_STOP,): drain, report stats, exit
CTRL_DIE = "die"           # (CTRL_DIE,): crash injection — exit WITHOUT draining


class InMemoryTransport:
    """Injectable in-memory fake of the multi-replica queue transport.

    Duck-type twin of `launch/replica.MpTransport` (``start_worker`` /
    ``send`` / ``poll`` / ``alive`` / ``kill`` / ``join``) with nothing
    crossing a process boundary: ``factory(wid, cfg, inbox, emit)``
    builds a caller-supplied worker object whose ``step()`` is run
    synchronously inside :meth:`poll` (return ``False`` to die), so a
    fake clock drives the whole replica serve loop deterministically —
    the kill-a-worker recovery test needs no real processes.
    ``blocks=False`` tells the serve loop that :meth:`poll` never
    waits, so idle time must pass through its injected ``sleep``."""

    blocks = False

    def __init__(self, factory):
        self._factory = factory
        self._inbox: Dict[int, Deque] = {}
        self._results: Deque = deque()
        self._workers: Dict[int, object] = {}
        self._alive: Dict[int, bool] = {}

    def start_worker(self, wid: int, cfg) -> None:
        self._inbox[wid] = deque()
        self._alive[wid] = True
        self._workers[wid] = self._factory(wid, cfg, self._inbox[wid],
                                           self._results.append)

    def send(self, wid: int, msg) -> None:
        # a send to a dead worker vanishes, like a socket to a dead peer
        if self._alive.get(wid):
            self._inbox[wid].append(msg)

    def poll(self, timeout: float = 0.0):
        """Step every live worker once, then pop one result (or None).
        ``timeout`` is ignored — this transport never blocks."""
        for wid in sorted(self._workers):
            if self._alive[wid] and self._workers[wid].step() is False:
                self._alive[wid] = False
                self._inbox[wid].clear()
        return self._results.popleft() if self._results else None

    def alive(self, wid: int) -> bool:
        return self._alive.get(wid, False)

    def kill(self, wid: int) -> None:
        """Simulate an abrupt worker death: it is never stepped again
        and its queued work is lost (the router must re-queue)."""
        self._alive[wid] = False
        self._inbox[wid].clear()

    def join(self, timeout: Optional[float] = None) -> None:
        pass
