"""The port's fleet serving (repro_torch.launch.fleet) and shared plan
constants (repro_torch.exec.constants) against the JAX package's: the
scheduler gives identical launch schedules on seeded traces (and after
a pickle round-trip of the port's FleetConfig), mixed traces and
chainable prefixes are the same, serve_fleet on one trace and one fake
clock reports the same schedule and stats, constants feed a bitwise
equal forward (within 1e-5 of the JAX package's), and the fleet CLI
prints the JAX package's rows and keys."""
import dataclasses
import pickle
import random
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (RTOL_LAYER, VClock, assert_close,   # noqa: E402
                           csv_rows, small_net_both, t)
from repro.exec import constants as j_constants                # noqa: E402
from repro.exec import execute_plan as j_execute               # noqa: E402
from repro.launch import batching as j_batching                # noqa: E402
from repro.launch import fleet as j_fleet                      # noqa: E402
from repro.launch import serve_cnn as j_serve                  # noqa: E402
from repro.launch import transformer as j_transformer          # noqa: E402
from repro_torch.core import memo                              # noqa: E402
from repro_torch.exec import (compile_plan, constant_counts,    # noqa: E402
                              execute_plan, prepare_constants)
from repro_torch.launch import batching as t_batching          # noqa: E402
from repro_torch.launch import fleet as t_fleet                # noqa: E402
from repro_torch.launch import serve_cnn as t_serve            # noqa: E402
from repro_torch.launch import transformer as t_transformer    # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (several test
    workers share a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(fl, specs):
    return fl.FleetConfig(models=tuple(fl.ModelSpec(*s) for s in specs))


def _replay(fl, specs, trace):
    clk = VClock()
    recs = fl.run_fleet(fl.FleetScheduler(_config(fl, specs)), trace,
                        clock=clk, sleep=clk.sleep)
    return [dataclasses.astuple(r) for r in recs]


def _random_case(rng: random.Random):
    specs = tuple((f"m{i}", rng.randint(1, 8),
                   rng.choice([0.0, 0.001, 0.005, 0.02]),
                   rng.choice([0.5, 1.0, 2.0]))
                  for i in range(rng.randint(1, 3)))
    trace, now = [], 0.0
    for _ in range(rng.randint(1, 30)):
        now += rng.choice([0.0, 0.0005, 0.002, 0.01])
        name, mb = rng.choice(specs)[:2]
        trace.append((now, name, rng.randint(1, mb)))
    return specs, tuple(trace)


@pytest.mark.parametrize("seed", range(2))
def test_schedule_same_seeded(seed):
    """50 seeded traces per case give the JAX package's LaunchRecord
    schedule, also after a pickle round-trip of the port's config; the
    fallback of the property test below, always runnable."""
    rng = random.Random(seed)
    for _ in range(50):
        specs, trace = _random_case(rng)
        want = _replay(j_fleet, specs, trace)
        assert _replay(t_fleet, specs, trace) == want
        cfg = pickle.loads(pickle.dumps(_config(t_fleet, specs)))
        clk = VClock()
        got = t_fleet.run_fleet(t_fleet.FleetScheduler(cfg), trace,
                                clock=clk, sleep=clk.sleep)
        assert [dataclasses.astuple(r) for r in got] == want


if HAVE_HYPOTHESIS:
    @st.composite
    def fleet_cases(draw):
        specs = tuple(
            (f"m{i}", draw(st.integers(1, 8)),
             draw(st.floats(0, 0.02, allow_nan=False)),
             draw(st.floats(0.1, 4.0, allow_nan=False)))
            for i in range(draw(st.integers(1, 3))))
        n = draw(st.integers(1, 30))
        trace, now = [], 0.0
        for _ in range(n):
            now += draw(st.floats(0, 0.01, allow_nan=False))
            name, mb = specs[draw(st.integers(0, len(specs) - 1))][:2]
            trace.append((now, name, draw(st.integers(1, mb))))
        return specs, tuple(trace)

    @settings(max_examples=60, deadline=None)
    @given(case=fleet_cases())
    def test_schedule_same_property(case):
        specs, trace = case
        assert _replay(t_fleet, specs, trace) == \
            _replay(j_fleet, specs, trace)


@pytest.mark.parametrize("fl", [j_fleet, t_fleet], ids=["jax", "port"])
def test_scheduler_validates(fl):
    cfg = _config(fl, [("a", 4, 0.0)])
    s = fl.FleetScheduler(cfg)
    with pytest.raises(KeyError, match="not in fleet"):
        s.push("nope", 1, now=0.0)
    with pytest.raises(ValueError, match="duplicate"):
        _config(fl, [("x", 1, 0.0), ("x", 1, 0.0)])
    with pytest.raises(ValueError, match="weight"):
        fl.ModelSpec("x", 1, 0.0, weight=0.0)
    with pytest.raises(ValueError, match="do not cover"):
        fl.FleetScheduler(cfg, tiers={"a": (1, 2)})
    clk = VClock()
    with pytest.raises(ValueError, match="never split"):
        fl.run_fleet(s, [(0.0, "a", 5)], clock=clk, sleep=clk.sleep)


@pytest.mark.parametrize("rate,weights", [(0.0, None), (200.0, None),
                                          (700.0, [3.0, 1.0])])
def test_mixed_poisson_trace_same(rate, weights):
    for seed in range(3):
        args = (["a", "b"], 32, rate, {"a": 3, "b": 1})
        assert t_fleet.mixed_poisson_trace(*args, seed=seed,
                                           weights=weights) == \
            j_fleet.mixed_poisson_trace(*args, seed=seed, weights=weights)


def test_chainable_prefix_same():
    """Inception (a layer set) is cut to the JAX package's prefix; a
    chain and a transformer lowering (explicit glue) pass unchanged."""
    from repro import core as jcore
    from repro_torch import core as tcore
    cut = []
    for core, fl in ((jcore, j_fleet), (tcore, t_fleet)):
        incep = core.map_net("inception", core.networks.inception(),
                             core.ArrayConfig(64, 64), "Tetris-SDK")
        pre = fl.chainable_prefix(incep)
        cut.append([m.layer.name for m in pre.layers])
        assert 1 <= len(pre.layers) < len(incep.layers)
    assert cut[0] == cut[1]
    _, net = small_net_both()
    assert t_fleet.chainable_prefix(net) is net
    tm = t_transformer.transformer_mapping("whisper_smoke")
    assert t_fleet.chainable_prefix(tm) is tm


def test_scheduler_imports_no_torch():
    """The scheduler core touches no device: importing the fleet, the
    batching core and the router loads no torch."""
    code = ("import sys\n"
            "import repro_torch.launch.fleet, repro_torch.launch.replica\n"
            "assert 'torch' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})


FLEET = (("cnn8", 2, 0.001, 1.0, 100.0), ("whisper_smoke", 2, 0.001, 1.0,
                                           100.0))


def _fleet_maps(core, transformer):
    net = core.map_net("cnn8", core.networks.cnn8()[:2],
                       core.ArrayConfig(64, 64), "Tetris-SDK",
                       core.MacroGrid(2, 2))
    return {"cnn8": net,
            "whisper_smoke": transformer.transformer_mapping(
                "whisper_smoke")}


def _model_view(stats):
    return {n: (m.batches, m.request_images, m.padded_images,
                m.request_tokens, m.delays_s, sorted(m.tiers))
            for n, m in stats.models.items()}


def test_serve_fleet_same_as_jax():
    """Both packages' serve_fleet (cnn8's first two layers and
    whisper_smoke) on one mixed trace and one fake clock: the same
    launch schedule, per-model batches and request/padded images, and
    the same report; the port's schedule does not change without shared
    constants or after a pickle round-trip of its config."""
    from repro import core as jcore
    from repro_torch import core as tcore
    trace = t_fleet.mixed_poisson_trace(["cnn8", "whisper_smoke"], 10,
                                        300.0, 2, seed=5)
    clk = VClock()
    js, jr = j_fleet.serve_fleet(_fleet_maps(jcore, j_transformer),
                                 _config(j_fleet, FLEET), trace,
                                 clock=clk, sleep=clk.sleep)
    runs = []
    for share, cfg in ((True, _config(t_fleet, FLEET)),
                       (False, pickle.loads(pickle.dumps(
                           _config(t_fleet, FLEET))))):
        clk = VClock()
        runs.append(t_fleet.serve_fleet(
            _fleet_maps(tcore, t_transformer), cfg, trace,
            share_constants=share, device="cpu", clock=clk,
            sleep=clk.sleep))
    for (ts, tr), share in zip(runs, (True, False)):
        assert [dataclasses.astuple(r) for r in tr] == \
            [dataclasses.astuple(r) for r in jr]
        assert _model_view(ts) == _model_view(js)
        assert ts.request_images == sum(r for _, _, r in trace)
        assert ts.shared_constants is share
    assert runs[0][0].describe() == js.describe()


def test_constants_bitwise_and_match_jax():
    """A three-tier ladder under the mapped executor: one PlanConstants
    handle for every tier (one materialization), a forward with it
    bitwise the forward without it, and within 1e-5 of max|y| of the JAX
    package's constants-fed forward on the same kernels and inputs."""
    jnet, tnet = small_net_both(3)
    memo.clear()
    lad = t_batching.PlanLadder(tnet, (1, 2, 4), device="cpu")
    jlad = j_batching.PlanLadder(jnet, (1, 2, 4))
    rng, ks = t_serve._serving_kernels(tnet, 0, torch.device("cpu"))
    _, jks = j_serve._serving_kernels(jnet, 0)
    handles = [prepare_constants(lad.plans[tier], ks, token=("fleet", 0))
               for tier in lad.tiers]
    assert all(h is handles[0] for h in handles)
    counts = constant_counts(net=tnet)
    assert list(counts.values()) == [1]
    assert all(w is not None for w in handles[0].weights)   # all mapped
    jc = j_constants.prepare_constants(jlad.plans[1], jks)
    first = tnet.layers[0].layer
    for tier in lad.tiers:
        x = rng.randn(tier, first.ic, first.i_h, first.i_w).astype(
            np.float32)
        y_off = execute_plan(lad.plans[tier], ks, t(x))
        y_on = execute_plan(lad.plans[tier], ks, t(x),
                            constants=handles[0])
        assert torch.equal(y_on, y_off)
        want = j_execute(jlad.plans[tier], jks, jnp.asarray(x),
                         constants=jc)
        assert_close(y_on, np.asarray(want), RTOL_LAYER)
    assert prepare_constants(lad.plans[1], ks) is not handles[0]
    assert list(constant_counts(net=tnet).values()) == [1]


def test_constants_refuse_another_net_or_executors():
    _, tnet = small_net_both(3)
    _, other = small_net_both(2)
    _, ks = t_serve._serving_kernels(tnet, 0, torch.device("cpu"))
    _, ks_o = t_serve._serving_kernels(other, 0, torch.device("cpu"))
    mapped = compile_plan(tnet, executor_policy="mapped", batch=1,
                          device="cpu")
    ref = compile_plan(tnet, executor_policy="reference", batch=1,
                       device="cpu")
    c = prepare_constants(mapped, ks)
    first = tnet.layers[0].layer
    x = torch.zeros(1, first.ic, first.i_h, first.i_w)
    with pytest.raises(ValueError, match="different network"):
        execute_plan(compile_plan(other, executor_policy="mapped", batch=1,
                                  device="cpu"), ks_o, x, constants=c)
    with pytest.raises(ValueError, match="executors"):
        execute_plan(ref, ks, x, constants=c)
    with pytest.raises(ValueError, match="kernels for"):
        prepare_constants(mapped, ks[:1])


@pytest.mark.parametrize("block", ["whole", "window"])
def test_plan_predicts_its_launches(block):
    """`NetworkPlan.launches_per_forward`, which the card's serving
    checks hold the wrappers' counters to: one launch of the block's sdk
    kernel per tile and group, one tetris_matmul per matmul layer of a
    G = 1 transformer and one flash_attention per encoder block."""
    from repro_torch import core as tc
    from repro_torch.configs import get_config
    net = tc.map_net("cnn8", tc.networks.cnn8()[:3], tc.ArrayConfig(64, 64),
                     "Tetris-SDK", tc.MacroGrid(1, 1))
    plan = compile_plan(net, executor_policy="sdk", batch=2, device="cpu",
                        block=block)
    want = dict.fromkeys(("sdk_whole", "sdk_window", "sdk_placed",
                          "tetris_matmul", "grouped_matmul",
                          "flash_attention"), 0)
    want["sdk_" + block] = sum(len(m.tiles) * m.group for m in net.layers)
    assert want["sdk_" + block] >= 3
    assert plan.launches_per_forward() == want
    wm = t_transformer.transformer_mapping("whisper_smoke")
    plan = compile_plan(wm, executor_policy="matmul", batch=2, device="cpu",
                        block=block)
    want = dict.fromkeys(want, 0)
    want["tetris_matmul"] = len(wm.layers)
    want["flash_attention"] = get_config("whisper_base",
                                         smoke=True).n_enc_layers
    assert plan.launches_per_forward() == want


def test_fleet_cli_prints_the_jax_rows(capsys):
    """``--fleet cnn8,whisper_smoke --device cpu`` prints the JAX
    package's row names and derived keys (the JAX rows from its own
    printer over its own fake-clock run) and serves every request."""
    from repro import core as jcore
    trace = j_fleet.mixed_poisson_trace(["cnn8", "whisper_smoke"], 8,
                                        200.0, 2, seed=0)
    clk = VClock()
    js, _ = j_fleet.serve_fleet(_fleet_maps(jcore, j_transformer),
                                _config(j_fleet, FLEET), trace,
                                clock=clk, sleep=clk.sleep)
    st = {"table_misses": 0, "disk_hits": 0}
    j_serve._print_fleet(js, tag="vmap", max_batch=2, max_delay_ms=2.0,
                         st=st)
    want = csv_rows(capsys.readouterr().out)
    s = t_serve.main(["--fleet", "cnn8,whisper_smoke", "--device", "cpu",
                      "--ar", "64", "--ac", "64", "--grid", "2x2",
                      "--batch", "2",
                      "--requests", "8", "--arrival-rate", "200",
                      "--warmup", "1", "--slo-ms", "500"])
    out = capsys.readouterr().out
    assert csv_rows(out) == want
    assert s.request_images == sum(r for _, _, r in trace)
    assert s.shared_constants
