"""The port's copy of the fault-tolerance runtime (repro_torch.runtime)
against the JAX package's: heartbeat deadlines, liveness beats vs step
reports, straggler thresholds, retirement, elastic re-meshing and the
supervised loop give identical answers on the same seeded event
sequences, driven by a fake clock."""
import random

import pytest

from repro.runtime import recovery as j_recovery
from repro_torch.runtime import recovery as t_recovery

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

BOTH = pytest.mark.parametrize("rec", [j_recovery, t_recovery],
                               ids=["jax", "port"])


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _replay(rec, n_workers, ops, policy=None):
    """Run one event sequence through ``rec``'s HeartbeatMonitor; the
    observations after every event are the comparison object."""
    clk = FakeClock()
    pol = None if policy is None else rec.StragglerPolicy(*policy)
    mon = rec.HeartbeatMonitor(n_workers, dead_after_s=1.0, policy=pol,
                               clock=clk)
    seen = []
    for op, w, x in ops:
        if op == "advance":
            clk.t += x
        elif op == "beat":
            mon.beat(w)
        elif op == "report":
            mon.report(w, x)
        else:
            mon.forget(w)
        seen.append((mon.dead_workers(), mon.stragglers(),
                     sorted(mon.last_seen), dict(mon.durations)))
    return seen


def _random_ops(rng: random.Random, n_workers: int):
    ops = []
    for _ in range(rng.randint(1, 40)):
        op = rng.choice(["advance", "beat", "report", "report", "forget"])
        ops.append((op, rng.randrange(n_workers),
                    rng.choice([0.05, 0.1, 0.3, 0.7, 1.5])))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_monitor_same_observations_seeded(seed):
    """Seeded event sequences (advance / beat / report / forget) give the
    same dead workers, stragglers and histories in both packages; the
    seeded fallback of the property test below, always runnable."""
    rng = random.Random(seed)
    for _ in range(25):
        n = rng.randint(1, 4)
        ops = _random_ops(rng, n)
        policy = rng.choice([None, (1.2, 2.0, 3), (1.5, 3.0, 20)])
        assert _replay(j_recovery, n, ops, policy) == \
            _replay(t_recovery, n, ops, policy)


if HAVE_HYPOTHESIS:
    @settings(max_examples=50, deadline=None)
    @given(n=st.integers(1, 4), data=st.data())
    def test_monitor_same_observations_property(n, data):
        ops = data.draw(st.lists(st.tuples(
            st.sampled_from(["advance", "beat", "report", "forget"]),
            st.integers(0, n - 1),
            st.floats(0.0, 2.0, allow_nan=False, allow_infinity=False)),
            max_size=40))
        assert _replay(j_recovery, n, ops) == _replay(t_recovery, n, ops)


@BOTH
def test_dead_after_and_forget(rec):
    clk = FakeClock()
    mon = rec.HeartbeatMonitor(3, dead_after_s=1.0, clock=clk)
    clk.t = 0.9
    mon.beat(1)
    clk.t = 1.1
    assert mon.dead_workers() == [0, 2]
    mon.forget(0)
    assert mon.dead_workers() == [2]
    mon.report(2, 0.25)
    assert mon.dead_workers() == [] and mon.durations[1] == []


@BOTH
def test_straggler_thresholds(rec):
    clk = FakeClock()
    mon = rec.HeartbeatMonitor(5, clock=clk,
                               policy=rec.StragglerPolicy(1.5, 3.0, 20))
    assert mon.stragglers() == {}
    for _ in range(5):                  # fleet median 1.0
        for w, d in enumerate((1.0, 1.0, 1.0, 2.0, 4.0)):
            mon.report(w, d)
    assert mon.stragglers() == {3: "warn", 4: "demote"}


@pytest.mark.parametrize("n_alive,mp", [(1, 1), (7, 1), (8, 2), (13, 4),
                                        (512, 8), (3, 4)])
def test_derive_elastic_mesh_same(n_alive, mp):
    got = []
    for rec in (j_recovery, t_recovery):
        try:
            plan = rec.derive_elastic_mesh(n_alive, model_parallel=mp)
            got.append((plan.shape, plan.axes, plan.dropped))
        except RuntimeError as e:
            got.append(str(e))
    assert got[0] == got[1]


class _Store:
    def __init__(self):
        self.saved = []

    def save(self, step, state, extra):
        self.saved.append((step, state, dict(extra)))

    def restore_latest(self, like, shardings=None):
        step, state, extra = self.saved[-1]
        return state, step, extra


class _Pipeline:
    def __init__(self):
        self.step = 0

    def skip_to(self, step):
        self.step = step

    def next(self):
        self.step += 1
        return self.step


@BOTH
def test_supervisor_checkpoint_failure_resume(rec):
    """TrainSupervisor (no caller in the port yet) keeps the JAX
    package's loop: checkpoints, an injected WorkerLost, and a resume
    from the latest checkpoint that replays the data cursor."""
    sup = rec.TrainSupervisor(store=_Store(), pipeline=_Pipeline(),
                              monitor=rec.HeartbeatMonitor(1),
                              save_every=2)

    def step_fn(state, batch):
        return state + batch, {}

    with pytest.raises(rec.WorkerLost, match="worker lost at step 3"):
        sup.run(0, step_fn, steps=6, inject_failure_at=3)
    state, step = sup.resume(None, step_fn, steps=6)
    assert (state, step) == (21, 6)
    assert sup.events == ["checkpoint at 2", "FAILURE injected at step 3",
                          "resumed from step 2", "checkpoint at 4",
                          "checkpoint at 6"]
