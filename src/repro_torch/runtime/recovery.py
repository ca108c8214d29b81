"""Fault-tolerance runtime (a copy of ``repro/runtime/recovery.py``):
heartbeats, straggler mitigation, elastic
re-meshing, supervised train loop with checkpoint/restart.

On a real multi-host deployment the heartbeat source is the coordination
service (jax.distributed / GCS liveness); here the transport is an
injectable callable so the logic is fully testable on one host.  The
design targets 1000+ nodes: O(1) state per worker, deadline-based
detection, and restart decisions that only depend on the surviving
device count.

Recovery model (standard TPU-pod practice):
  * worker misses `dead_after` heartbeats      -> declared dead
  * any dead worker                            -> stop, re-mesh on the
    surviving hosts (derive_elastic_mesh), restore latest checkpoint
    (checkpoint.store reshards onto the new mesh), replay the data
    cursor (pipeline.skip_to) — sample-exact resume
  * straggler (slow but alive)                 -> policy: warn (log),
    or demote (treat as dead at the next re-mesh window)
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class StragglerPolicy:
    warn_factor: float = 1.5       # step slower than median x this -> warn
    demote_factor: float = 3.0     # -> treat as failed at next window
    window: int = 20               # steps of history


class HeartbeatMonitor:
    """Deadline-based liveness + straggler detection over step reports.

    Two kinds of signal: :meth:`beat` is liveness only (the serving
    tier's idle heartbeats — they must not dilute the straggler step
    statistics with zero-length samples), :meth:`report` is a completed
    step with its duration (feeds both liveness and the straggler
    medians).  :meth:`forget` retires a worker that was declared dead
    so it stops being re-reported — the replica router
    (`launch/replica.py`) re-queues its work exactly once."""

    def __init__(self, n_workers: int, *, dead_after_s: float = 60.0,
                 policy: Optional[StragglerPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.n = n_workers
        self.dead_after = dead_after_s
        self.policy = policy or StragglerPolicy()
        self.clock = clock
        self.last_seen = {w: clock() for w in range(n_workers)}
        self.durations: Dict[int, List[float]] = {w: []
                                                  for w in range(n_workers)}

    def beat(self, worker: int) -> None:
        """Liveness-only heartbeat: refresh the deadline, record no
        step duration."""
        self.last_seen[worker] = self.clock()

    def report(self, worker: int, step_duration_s: float) -> None:
        self.last_seen[worker] = self.clock()
        d = self.durations.setdefault(worker, [])
        d.append(step_duration_s)
        if len(d) > self.policy.window:
            d.pop(0)

    def forget(self, worker: int) -> None:
        """Retire a worker (declared dead and handled): it no longer
        appears in :meth:`dead_workers` or the straggler scan."""
        self.last_seen.pop(worker, None)
        self.durations.pop(worker, None)

    def dead_workers(self) -> List[int]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t > self.dead_after]

    def stragglers(self) -> Dict[int, str]:
        med = self._median_all()
        if med is None:
            return {}
        out = {}
        for w, d in self.durations.items():
            if not d:
                continue
            mine = sorted(d)[len(d) // 2]
            if mine > self.policy.demote_factor * med:
                out[w] = "demote"
            elif mine > self.policy.warn_factor * med:
                out[w] = "warn"
        return out

    def _median_all(self) -> Optional[float]:
        alld = [x for d in self.durations.values() for x in d]
        if not alld:
            return None
        return sorted(alld)[len(alld) // 2]


@dataclass(frozen=True)
class ElasticPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped: int


def derive_elastic_mesh(n_alive: int, *, model_parallel: int,
                        prefer_pods: bool = True) -> ElasticPlan:
    """Largest coherent (data, model) mesh on the surviving devices.

    Model parallel size is preserved (params are sharded that way);
    the data axis shrinks to floor(n_alive / model_parallel).  With
    prefer_pods, whole multiples of a pod's data extent are kept so the
    slow-link topology stays clean."""
    if n_alive < model_parallel:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with "
            f"{n_alive} devices")
    data = n_alive // model_parallel
    # keep the data extent a power of two (collective-friendly)
    data = 2 ** int(math.log2(data))
    used = data * model_parallel
    return ElasticPlan(shape=(data, model_parallel),
                       axes=("data", "model"),
                       dropped=n_alive - used)


class TrainSupervisor:
    """Orchestrates the train loop: periodic checkpoints, heartbeat
    scanning, restart-from-checkpoint on failure.  Deliberately
    framework-thin so tests can drive it with fake steps/clocks."""

    def __init__(self, *, store, pipeline, monitor: HeartbeatMonitor,
                 save_every: int = 100):
        self.store = store
        self.pipeline = pipeline
        self.monitor = monitor
        self.save_every = save_every
        self.events: List[str] = []

    def run(self, state, step_fn, *, start_step: int = 0, steps: int = 100,
            inject_failure_at: Optional[int] = None):
        """Returns (state, last_step).  ``inject_failure_at`` simulates a
        worker loss mid-run (used by tests and the fault-tolerance
        example)."""
        step = start_step
        self.pipeline.skip_to(step)
        while step < steps:
            if inject_failure_at is not None and step == inject_failure_at:
                self.events.append(f"FAILURE injected at step {step}")
                raise WorkerLost(step)
            t0 = time.monotonic()
            batch = self.pipeline.next()
            state, metrics = step_fn(state, batch)
            self.monitor.report(0, time.monotonic() - t0)
            step += 1
            if step % self.save_every == 0 or step == steps:
                self.store.save(step, state,
                                extra={"data_step": self.pipeline.step})
                self.events.append(f"checkpoint at {step}")
            for w, action in self.monitor.stragglers().items():
                self.events.append(f"straggler worker={w} action={action}")
        return state, step

    def resume(self, like, step_fn, *, steps: int, shardings=None):
        state, step, extra = self.store.restore_latest(like, shardings)
        self.pipeline.skip_to(extra.get("data_step", step))
        self.events.append(f"resumed from step {step}")
        return self.run(state, step_fn, start_step=step, steps=steps)


class WorkerLost(RuntimeError):
    def __init__(self, step: int):
        super().__init__(f"worker lost at step {step}")
        self.step = step
