"""The port's dynamic batching (repro_torch.launch.batching and
serve_cnn.serve_dynamic) against the JAX package's: the coalescer (with
and without AdaptiveDelay), the tier ladder, percentiles and Poisson
arrivals give identical outputs on seeded traces; serve_dynamic on one
trace and one fake clock gives identical per-tier stats in both
packages; the ladder compiles each tier once; a zero-padded tier
forward keeps its request rows (pad-and-mask); and the dynamic CLI
prints the JAX package's rows and keys."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (RTOL_NET, VClock, assert_close,     # noqa: E402
                           csv_rows, small_net_both, t)
from repro.launch import batching as j_batching                # noqa: E402
from repro.launch import serve_cnn as j_serve                  # noqa: E402
from repro_torch.core import memo                              # noqa: E402
from repro_torch.exec import (compile_counts, execute_oracle,   # noqa: E402
                              execute_plan)
from repro_torch.launch import batching as t_batching          # noqa: E402
from repro_torch.launch import serve_cnn as t_serve            # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

BOTH = pytest.mark.parametrize("bt", [j_batching, t_batching],
                               ids=["jax", "port"])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (several test
    workers share a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coalesce(bt, max_batch, max_delay_s, adaptive, ops):
    """Replay push / pop / force events through ``bt``'s Coalescer; what
    it answers after every event is the comparison object."""
    policy = bt.AdaptiveDelay(max_delay_s, max_batch) if adaptive else None
    co = bt.Coalescer(max_batch, max_delay_s, delay_policy=policy)
    seen = []
    for op, now, rows in ops:
        if op == "push":
            co.push(rows, now, payload=len(seen))
            out = None
        else:
            out = [(r.rows, r.arrival_s, r.payload)
                   for r in co.pop(now, force=op == "force")]
        seen.append((out, len(co), co.requests, co.next_deadline(),
                     co.ready(now), co.effective_delay_s()))
    return seen


def _random_ops(rng: random.Random, max_batch: int):
    now, ops = 0.0, []
    for _ in range(rng.randint(1, 40)):
        now += rng.choice([0.0, 0.0005, 0.002, 0.01])
        op = rng.choice(["push", "push", "pop", "force"])
        ops.append((op, now, rng.randint(1, max_batch)))
    return ops


@pytest.mark.parametrize("adaptive", [False, True])
def test_coalescer_same_drains_seeded(adaptive):
    """100 seeded event sequences drain identically in both packages,
    with the fixed delay and with AdaptiveDelay; the fallback of the
    property test below, always runnable."""
    rng = random.Random(11 + adaptive)
    for _ in range(100):
        mb = rng.randint(1, 8)
        delay = rng.choice([0.0, 0.001, 0.005])
        ops = _random_ops(rng, mb)
        assert _coalesce(j_batching, mb, delay, adaptive, ops) == \
            _coalesce(t_batching, mb, delay, adaptive, ops)


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(mb=st.integers(1, 8), adaptive=st.booleans(),
           delay=st.floats(0, 0.02, allow_nan=False, allow_infinity=False),
           data=st.data())
    def test_coalescer_same_drains_property(mb, adaptive, delay, data):
        n = data.draw(st.integers(1, 30))
        gaps = data.draw(st.lists(st.floats(0, 0.01, allow_nan=False),
                                  min_size=n, max_size=n))
        kinds = data.draw(st.lists(st.sampled_from(["push", "pop",
                                                    "force"]),
                                   min_size=n, max_size=n))
        rows = data.draw(st.lists(st.integers(1, mb), min_size=n,
                                  max_size=n))
        ops, now = [], 0.0
        for g, k, r in zip(gaps, kinds, rows):
            now += g
            ops.append((k, now, r))
        assert _coalesce(j_batching, mb, delay, adaptive, ops) == \
            _coalesce(t_batching, mb, delay, adaptive, ops)


@BOTH
def test_coalescer_refuses_bad_input(bt):
    co = bt.Coalescer(4, 0.001)
    with pytest.raises(ValueError, match="never split"):
        co.push(5, 0.0)
    with pytest.raises(ValueError, match=">= 1 row"):
        co.push(0, 0.0)
    with pytest.raises(ValueError, match="max_batch"):
        bt.Coalescer(0, 0.001)
    with pytest.raises(ValueError, match="ref_rows"):
        bt.AdaptiveDelay(0.001, 0)


def test_batch_tiers_and_tier_for_same():
    for mb in range(1, 65):
        tiers = t_batching.batch_tiers(mb)
        assert tiers == j_batching.batch_tiers(mb)
        for rows in range(1, mb + 1):
            assert t_batching.tier_for(rows, tiers) == \
                j_batching.tier_for(rows, tiers)
    with pytest.raises(ValueError, match="exceed"):
        t_batching.tier_for(9, (1, 2, 4, 8))


@pytest.mark.parametrize("seed", range(3))
def test_percentile_and_poisson_arrivals_same(seed):
    rng = np.random.RandomState(seed)
    xs = list(rng.exponential(0.01, size=rng.randint(1, 60)))
    for q in (0, 1, 50, 95, 99, 100):
        assert t_batching.percentile(xs, q) == j_batching.percentile(xs, q)
    for rate in (0.0, 50.0, 500.0):
        assert t_serve.poisson_arrivals(24, rate, 4, seed=seed) == \
            j_serve.poisson_arrivals(24, rate, 4, seed=seed)


def _tier_view(s):
    return {t: (ts.plan_batch, ts.batches, ts.request_images,
                ts.padded_images, ts.delays_s)
            for t, ts in s.tiers.items()}


@pytest.mark.parametrize("adaptive,rate", [(False, 0.0), (False, 400.0),
                                           (True, 400.0)])
def test_serve_dynamic_same_schedule(adaptive, rate):
    """Both packages' serve_dynamic on one Poisson trace and one fake
    clock: identical per-tier batches, rows and queue delays, and the
    same report."""
    jnet, tnet = small_net_both()
    reqs = t_serve.poisson_arrivals(16, rate, 3, seed=4)
    runs = []
    for serve, net, kw in ((j_serve.serve_dynamic, jnet, {}),
                           (t_serve.serve_dynamic, tnet, {"device": "cpu"})):
        clk = VClock()
        runs.append(serve(net, reqs, max_batch=4, max_delay_ms=2.0,
                          warmup=1, adaptive_delay=adaptive, clock=clk,
                          sleep=clk.sleep, **kw))
    js, ts = runs
    assert _tier_view(ts) == _tier_view(js)
    assert (ts.request_images, ts.padded_images, ts.wall_s,
            ts.warmup_steps) == (js.request_images, js.padded_images,
                                 js.wall_s, js.warmup_steps)
    assert ts.request_images == sum(r for _, r in reqs)
    assert ts.describe() == js.describe()


def test_serve_dynamic_validates_like_jax():
    _, net = small_net_both()
    with pytest.raises(ValueError, match="warmup"):
        t_serve.serve_dynamic(net, [(0.0, 1)], max_batch=2,
                              max_delay_ms=1.0, warmup=-1, device="cpu")
    with pytest.raises(ValueError, match="never split"):
        t_serve.serve_dynamic(net, [(0.0, 5)], max_batch=2,
                              max_delay_ms=1.0, device="cpu")
    with pytest.raises(ValueError, match="do not cover"):
        t_serve.serve_dynamic(net, [(0.0, 1)], max_batch=4,
                              max_delay_ms=1.0, tiers=(1, 2), device="cpu")


def test_plan_ladder_compiles_each_tier_once():
    """Every tier compiles once per process (compile_counts), a second
    ladder over the same net compiles nothing, and each tier's plan has
    the JAX package's executors and batch."""
    jnet, tnet = small_net_both(3)
    memo.clear()
    lad = t_batching.PlanLadder(tnet, (4, 1, 2, 2), device="cpu")
    assert lad.tiers == (1, 2, 4) and lad.max_batch == 4
    again = t_batching.PlanLadder(tnet, (1, 2, 4), device="cpu")
    counts = compile_counts(net=tnet)
    assert sorted(k[2] for k in counts) == [1, 2, 4]
    assert set(counts.values()) == {1}
    assert compile_counts(net=tnet, batch=2) == {
        k: 1 for k in counts if k[2] == 2}
    jlad = j_batching.PlanLadder(jnet, (1, 2, 4))
    for tier in lad.tiers:
        assert again.plans[tier] is lad.plans[tier]
        assert lad.plans[tier].batch == tier
        assert lad.plans[tier].executors == jlad.plans[tier].executors
    assert lad.plan_for(3) == (4, lad.plans[4])
    with pytest.raises(ValueError, match="at least one"):
        t_batching.PlanLadder(tnet, (), device="cpu")
    memo.clear()
    assert compile_counts(net=tnet) == {}


@pytest.mark.parametrize("policy", ["mapped", "reference"])
def test_padded_tier_keeps_request_rows(policy):
    """Pad-and-mask: the first ``rows`` rows of a forward at tier 4 on a
    zero-padded input equal the plain oracle on those rows alone."""
    from repro_torch.exec import compile_plan
    _, tnet = small_net_both()
    lad = t_batching.PlanLadder(tnet, (1, 2, 4), policy=policy,
                                device="cpu")
    any_batch = compile_plan(tnet, executor_policy=policy, device="cpu")
    ks, pool = t_serve.serving_inputs(tnet, 4, 0, "cpu")
    for rows in (1, 3):
        x = np.zeros_like(pool)
        x[:rows] = pool[:rows]
        y = execute_plan(lad.plans[4], ks, t(x))[:rows]
        ref = execute_oracle(any_batch, ks, t(pool[:rows]))
        assert_close(y, ref.numpy(), RTOL_NET)


def test_dynamic_cli_prints_the_jax_rows(capsys):
    """``--max-delay-ms`` on the CPU prints the JAX package's row names
    and derived keys (the JAX rows come from its own printer over its
    own fake-clock run)."""
    jnet, _ = small_net_both()
    reqs = j_serve.poisson_arrivals(8, 0.0, 4, seed=0)
    clk = VClock()
    js = j_serve.serve_dynamic(jnet, reqs, max_batch=4, max_delay_ms=2.0,
                               clock=clk, sleep=clk.sleep)
    st = {"table_misses": 0, "disk_hits": 0}
    j_serve._print_dynamic("cnn8", js, tag="vmap", max_batch=4,
                           max_delay_ms=2.0, compiles=3, st=st)
    want = csv_rows(capsys.readouterr().out)
    s = t_serve.main(["--net", "cnn8", "--ar", "64", "--ac", "64",
                      "--grid", "2x2", "--alg", "Tetris-SDK",
                      "--max-delay-ms", "2", "--max-batch", "4",
                      "--requests", "8", "--warmup", "1",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert csv_rows(out) == want
    assert "serve_dyn/cnn8/all," in out and "queue-delay p50=" in out
    assert s.request_images == sum(
        r for _, r in t_serve.poisson_arrivals(8, 0.0, 4, seed=0))
