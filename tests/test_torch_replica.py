"""The port's multi-replica serving (repro_torch.launch.replica) against
the JAX package's: the router's dispatch, completion and death
accounting give identical ledgers on seeded event sequences; the serve
loop over the in-memory transport and one fake clock (healthy, a killed
worker, a hung worker) reports the same stats in both packages; a
worker that dies at start-up raises; and one real run of two spawned
CPU workers, one of them killed, serves every request exactly once."""
import random

import numpy as np
import pytest

from _torch_parity import csv_rows
from repro.launch import batching as j_batching
from repro.launch import replica as j_replica
from repro.runtime import recovery as j_recovery
from repro_torch.launch import batching as t_batching
from repro_torch.launch import replica as t_replica
from repro_torch.runtime import recovery as t_recovery

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

PACKAGES = {"jax": (j_batching, j_replica, j_recovery),
            "port": (t_batching, t_replica, t_recovery)}
BOTH = pytest.mark.parametrize("pkg", sorted(PACKAGES))


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _ledger(router):
    return ({w: (v.alive, v.outstanding_rows, sorted(v.outstanding),
                 v.served_requests, v.served_rows, v.padded_rows,
                 v.batches, v.delays_s) for w, v in router.views.items()},
            router.dispatched, router.requeued, router.duplicate_serves,
            router.deaths, router.incomplete(), dict(router.served))


def _route(pkg, n, ops):
    """Replay dispatch / done / dead events through ``pkg``'s router;
    every answer and the final ledger are the comparison object."""
    bt, rp, _ = PACKAGES[pkg]
    router = rp.ReplicaRouter(n)
    seen, seq = [], 0
    for op, a, b in ops:
        try:
            if op == "dispatch":
                seen.append(router.dispatch(bt.WorkItem(seq, a, 0.0)))
                seq += 1
            elif op == "done":
                owned = sorted(router.views[a % n].outstanding)[:b]
                seen.append(router.on_batch_done(
                    a % n, 4, [(s, 1, 0.001 * s) for s in owned]))
            else:
                items = router.mark_dead(a % n)
                seen.append([it.seq for it in items])
                for it in items:
                    seen.append(router.dispatch(it))
        except rp.NoSurvivorsError as e:
            seen.append(str(e))
    return seen, _ledger(router)


def _random_ops(rng: random.Random):
    return [(rng.choice(["dispatch", "dispatch", "done", "dead"]),
             rng.randint(1, 4), rng.randint(1, 3))
            for _ in range(rng.randint(1, 40))]


@pytest.mark.parametrize("seed", range(2))
def test_router_same_ledger_seeded(seed):
    """Seeded dispatch / completion / death sequences give the same
    assignments, re-queues and ledgers in both packages (the fallback of
    the property test below, always runnable)."""
    rng = random.Random(seed)
    for _ in range(50):
        n, ops = rng.randint(1, 3), _random_ops(rng)
        assert _route("port", n, ops) == _route("jax", n, ops)


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(n=st.integers(1, 3), ops=st.lists(st.tuples(
        st.sampled_from(["dispatch", "done", "dead"]), st.integers(1, 4),
        st.integers(1, 3)), max_size=40))
    def test_router_same_ledger_property(n, ops):
        assert _route("port", n, ops) == _route("jax", n, ops)


class FakeWorker:
    """Synchronous stand-in for `_worker_main` over one package's
    batching module: one coalescer pop per step, the fake clock,
    heartbeats every ``heartbeat_s``."""

    def __init__(self, bt, wid, cfg, inbox, emit, clock, hang=False):
        self.bt, self.wid, self.cfg = bt, wid, cfg
        self.inbox, self.emit, self.clock = inbox, emit, clock
        self.hang = hang
        self.epoch = self.last_hb = None
        self.co = bt.Coalescer(cfg.max_batch, cfg.max_delay_ms / 1e3)
        self.stopping = False
        self.served = self.padded = self.batches = 0
        emit((bt.MSG_READY, wid, 0.1 + wid, 1, 0))

    def step(self):
        bt = self.bt
        if self.hang and self.batches >= 1:
            return True                 # alive, silent, holding its work
        while self.inbox:
            msg = self.inbox.popleft()
            if isinstance(msg, bt.WorkItem):
                self.co.push(msg.rows, msg.arrival_s, payload=msg)
            elif msg[0] == bt.CTRL_GO:
                self.epoch = float(msg[1])
            elif msg[0] == bt.CTRL_STOP:
                self.stopping = True
            elif msg[0] == bt.CTRL_DIE:
                self.emit((bt.MSG_DYING, self.wid, "killed"))
                return False
        if self.epoch is None:
            return True
        now = self.clock() - self.epoch
        if self.last_hb is None or now - self.last_hb >= self.cfg.heartbeat_s:
            self.last_hb = now
            self.emit((bt.MSG_HEARTBEAT, self.wid, now))
        batch = self.co.pop(now, force=self.stopping)
        if batch:
            rows = sum(r.rows for r in batch)
            tier = bt.tier_for(rows, bt.batch_tiers(self.cfg.max_batch))
            self.served += rows
            self.padded += tier
            self.batches += 1
            self.emit((bt.MSG_DONE, self.wid, tier,
                       tuple((r.payload.seq, r.rows, now - r.arrival_s)
                             for r in batch), 0.001))
        elif self.stopping and not len(self.co):
            self.emit((bt.MSG_STATS, self.wid, self.served, self.padded,
                       self.batches))
            return False
        return True


def _fake_serve(pkg, trace, n, hang=None, **kw):
    bt, rp, _ = PACKAGES[pkg]
    clk = FakeClock()
    cfg = rp.WorkerConfig(max_batch=4, max_delay_ms=2.0, heartbeat_s=0.05)
    transport = bt.InMemoryTransport(
        lambda wid, c, inbox, emit: FakeWorker(bt, wid, c, inbox, emit,
                                               clk, hang=wid == hang))
    return rp.serve_replicas(trace, cfg, n, transport=transport,
                             clock=clk, sleep=clk.advance, **kw)


def _stats_view(rs):
    return ({w: (v.alive, v.startup_s, v.served_requests, v.served_rows,
                 v.padded_rows, v.batches, v.delays_s)
             for w, v in rs.workers.items()},
            rs.request_images, rs.padded_images, rs.wall_s, rs.requeued,
            rs.duplicate_serves, rs.deaths)


@pytest.mark.parametrize("case", ["healthy", "timed", "kill", "hang"])
def test_fake_transport_same_stats(case):
    """The serve loop over the in-memory transport and one fake clock:
    every request served exactly once, and the port's stats and report
    equal the JAX package's — healthy, with timed arrivals, with worker
    1 killed once it holds work, and with worker 1 hung after its first
    batch (caught by the heartbeat deadline)."""
    from repro_torch.launch.serve_cnn import poisson_arrivals
    trace = poisson_arrivals(20, 300.0 if case == "timed" else 0.0, 4,
                             seed=2)
    kw = {"kill": dict(kill_worker=1, kill_after_batches=0),
          "hang": dict(hang=1, dead_after_s=0.5)}.get(case, {})
    got = {pkg: _fake_serve(pkg, trace, 2, **kw) for pkg in PACKAGES}
    assert _stats_view(got["port"]) == _stats_view(got["jax"])
    assert got["port"].describe() == got["jax"].describe()
    rs = got["port"]
    assert rs.request_images == sum(r for _, r in trace)
    assert sum(v.served_requests for v in rs.workers.values()) == 20
    assert rs.duplicate_serves == 0
    assert rs.deaths == (case in ("kill", "hang"))
    assert (rs.requeued > 0) == (case in ("kill", "hang"))


class _Stillborn:
    def __init__(self, bt, wid, emit):
        emit((bt.MSG_DYING, wid, "startup: no CUDA device"))

    def step(self):
        return False


@BOTH
def test_startup_death_raises(pkg):
    """A worker that reports DYING at start-up fails the run (the port
    never serves on another device instead)."""
    bt, rp, _ = PACKAGES[pkg]
    transport = bt.InMemoryTransport(
        lambda wid, c, inbox, emit: _Stillborn(bt, wid, emit))
    with pytest.raises(RuntimeError, match="died during startup"):
        rp.serve_replicas([(0.0, 1)], rp.WorkerConfig(max_batch=2), 1,
                          transport=transport)


def test_worker_config_has_a_device_and_no_mesh(monkeypatch):
    """A worker serves on its device with its own mesh: over the one CPU
    (no mesh), over ``worker_devices`` host entries, or over the visible
    cards, where ``worker_devices`` raises naming their count."""
    import dataclasses
    import torch
    cfg = t_replica.WorkerConfig()
    assert cfg.device == "cuda" and cfg.use_mesh
    assert cfg.worker_devices is None
    assert not hasattr(cfg, "xla_host_devices")
    cpu = dataclasses.replace(cfg, device="cpu")
    assert t_replica.worker_mesh_devices(cpu) == [torch.device("cpu")]
    four = dataclasses.replace(cpu, worker_devices=4)
    assert t_replica.worker_mesh_devices(four) == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match=">= 1"):
        t_replica.worker_mesh_devices(
            dataclasses.replace(cpu, worker_devices=0))
    card = dataclasses.replace(cfg, worker_devices=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_replica.worker_mesh_devices(card)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 visible card"):
        t_replica.worker_mesh_devices(card)
    with pytest.raises(ValueError, match="1 visible card"):
        t_replica.serve_replicas([(0.0, 1)], card, 1)


def test_spawned_cpu_workers_kill_lossless(capsys, tmp_path, monkeypatch):
    """Two real spawned workers on the CPU, worker 1 killed once it holds
    work: every request is served exactly once by the survivor's re-queue,
    and the CLI prints the JAX package's replica rows.  Bounded by
    serve_replicas' own start-up and join timeouts; the workers inherit
    one intra-op thread each, so they do not crowd the other tests."""
    from repro_torch.core import memo
    from repro_torch.launch import serve_cnn
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    try:            # main points the process-wide disk cache at tmp_path
        rs = serve_cnn.main(["--net", "cnn8", "--ar", "64", "--ac", "64",
                             "--grid", "2x2", "--replicas", "2",
                             "--kill-worker", "1", "--max-batch", "4",
                             "--max-delay-ms", "2", "--requests", "12",
                             "--warmup", "1", "--device", "cpu",
                             "--cache-dir", str(tmp_path / "cache")])
    finally:
        memo.set_disk_cache(None)
    out = capsys.readouterr().out
    trace = serve_cnn.poisson_arrivals(12, 0.0, 4, seed=0)
    assert rs.deaths == 1 and not rs.workers[1].alive
    assert rs.requeued > 0 and rs.duplicate_serves == 0
    assert sum(v.served_requests for v in rs.workers.values()) == 12
    assert rs.request_images == sum(r for _, r in trace)
    rows = csv_rows(out)
    assert set(rows) == {"serve_replica/cnn8/wN", "serve_replica/cnn8/all"}
    assert rows["serve_replica/cnn8/all"] == [
        "images_per_s", "padded_images_per_s", "p50_ms", "p95_ms", "p99_ms",
        "replicas", "deaths", "requeued", "duplicate_serves", "max_batch",
        "max_delay_ms"]
    assert np.isfinite(rs.images_per_s)
