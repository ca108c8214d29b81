"""The port's measured-feedback autotuner (repro_torch.tune) against the
JAX package's (repro.tune): the same space, seeds and shortlist on the
CPU branch and on the card's branch (the JAX package's "tpu" one); every
fake-timer case of tests/test_tune.py run through both packages on the
same scripted costs, giving equal trials, winner and measured-step
count; persistence (a cold process with a warm cache measures nothing,
fleets and packages never load each other's winners); the "tuned"
policy through compile_plan, the plan ladder, the fleet and a replica
worker; real CPU searches whose winners match the oracle; and the
report's CSV / JSON equal to the JAX package's."""
import dataclasses
import json
import os
import queue
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.core import memo as jmemo
from repro_torch import tune as ttune
from repro_torch.core import memo as tmemo
from repro_torch.exec import (compile_counts, compile_plan, execute_oracle,
                              execute_plan)

from _torch_parity import RTOL_NET, assert_close, map_net_both

ROOT = Path(__file__).resolve().parents[1]
NETS = ("cnn8", "inception", "densenet40")
#: (array, grid): tests/test_tune.py's net, and the paper's served array
#: on one macro, where the card's branch seeds sdk layers
SHAPES = (((64, 64), (2, 2)), ((512, 512), (1, 1)))
PKGS = {"jax": (jtune, jmemo), "port": (ttune, tmemo)}


def _net_both(name="cnn8", array=(64, 64), grid=(2, 2), groups=(1, 2)):
    """(jax, port) mapping of tests/test_tune.py::_net."""
    return map_net_both(name, lambda core: core.networks.NETWORKS[name](),
                        array, "TetrisG-SDK", grid, groups=groups)


def _fake(costs, *, default=1.0):
    """tests/test_tune.py's fixture: a virtual clock plus a runner whose
    per-candidate step advances it by a scripted cost."""
    t = [0.0]

    def clock():
        return t[0]

    def runner(cand):
        def step():
            c = costs(cand) if callable(costs) else costs.get(cand, default)
            t[0] += c
        return step

    return clock, runner


def _astuples(cands):
    return [dataclasses.astuple(c) for c in cands]


def _trials(res):
    return [(dataclasses.astuple(t.candidate), t.rounds, t.median_s)
            for t in res.trials]


def _same_result(j, t):
    """Equal trials (fields, rounds, medians exactly), winner and
    measured-step count — the cross-package contract of a search."""
    assert _trials(j) == _trials(t)
    assert dataclasses.astuple(j.config.candidate) == \
        dataclasses.astuple(t.config.candidate)
    jc, tc = dataclasses.asdict(j.config), dataclasses.asdict(t.config)
    assert jc == tc
    assert (j.measurements, j.cached) == (t.measurements, t.cached)


def _autotune_both(net_pair, costs_of, *, budget="SMOKE_BUDGET", **kw):
    """One search per package on the same scripted costs; ``costs_of``
    gets its package's baseline and returns the cost function; ``budget``
    names a budget of each package's own (None: the default)."""
    out = []
    for (name, (tn, _)), net in zip(sorted(PKGS.items()), net_pair):
        extra = {} if name == "jax" else {"device": "cpu"}
        base = tn.baseline_candidate(net, batch=kw["batch"], **extra)
        clock, runner = _fake(costs_of(base))
        out.append(tn.autotune(
            net, clock=clock, runner=runner,
            budget=getattr(tn, budget) if budget else None, **extra, **kw))
    return out


def _jax_one_device():
    import jax
    return jax.devices()[:1]


@pytest.fixture
def clean():
    jmemo.clear()
    tmemo.clear()
    yield
    for m in (jmemo, tmemo):
        m.set_disk_cache(None)
        m.clear()


# ----------------------------------------------------------------- space


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("shape", SHAPES, ids=["64x64g2x2", "512x512g1x1"])
@pytest.mark.parametrize("backends", [("cpu", "cpu"), ("tpu", "cuda")],
                         ids=["cpu", "card"])
def test_space_equals_jax(name, shape, backends):
    """enumerate_space, policy_candidates, baseline_candidate,
    analytic_cost and shortlist agree field for field; the port's card
    branch ("cuda") is the JAX package's "tpu" one."""
    jb, tb = backends
    jnet, tnet = _net_both(name, *shape)
    assert jtune.policy_candidates(jnet, backend=jb) == \
        ttune.policy_candidates(tnet, backend=tb)
    assert jtune.auto_policy(jnet, backend=jb) == \
        ttune.auto_policy(tnet, backend=tb)
    for kw in ({}, {"lookaheads": (1,), "blocks": ("auto", "whole",
                                                    "window")},
               {"tiers_options": (None, (4,)), "remats": (None, "auto"),
                "vmem_budgets": (None, 1 << 20)}):
        js = jtune.enumerate_space(jnet, batch=4, backend=jb,
                                   mesh_splits=(None,), **kw)
        ts = ttune.enumerate_space(tnet, batch=4, backend=tb,
                                   mesh_splits=(None,), **kw)
        assert _astuples(js) == _astuples(ts)
        assert [jtune.analytic_cost(jnet, c) for c in js] == \
            [ttune.analytic_cost(tnet, c) for c in ts]
        jbase = jtune.baseline_candidate(jnet, batch=4, backend=jb,
                                         devices=_jax_one_device())
        tbase = ttune.baseline_candidate(tnet, batch=4, backend=tb,
                                         devices=[torch.device("cpu")])
        assert dataclasses.astuple(jbase) == dataclasses.astuple(tbase)
        for k in (1, 3, 5, 8):
            assert _astuples(jtune.shortlist(jnet, js, k)) == \
                _astuples(ttune.shortlist(tnet, ts, k))
            assert _astuples(jtune.shortlist(jnet, js, k, baseline=jbase)) \
                == _astuples(ttune.shortlist(tnet, ts, k, baseline=tbase))
    if jb == "tpu" and shape[0] == (512, 512) and name == "cnn8":
        # the served cnn8 mapping: the card seeds sdk (whole / window)
        assert "sdk" in ttune.auto_policy(tnet, backend=tb)
    with pytest.raises(ValueError, match="k >= 1"):
        ttune.shortlist(tnet, ts, 0)


def test_space_defaults_to_the_plan_device():
    """Without ``backend`` the port resolves the device (default: the
    card, which raises here); ``device="cpu"`` is the CPU branch, whose
    one device gives the one split None — as one card does — while a
    mesh over ``[cpu] * 4`` gives the JAX package's splits of four
    devices, with the baseline on `serving_mesh_for`'s."""
    _, tnet = _net_both()
    assert ttune.enumerate_space(tnet, batch=4, device="cpu") == \
        ttune.enumerate_space(tnet, batch=4, backend="cpu")
    assert {c.mesh_split for c in ttune.enumerate_space(
        tnet, batch=4, device="cpu")} == {None}
    one_card = [torch.device("cuda", 0)]
    assert ttune.space.mesh_split_candidates(tnet, 4, one_card) == (None,)
    cpu4 = [torch.device("cpu")] * 4
    splits = ttune.space.mesh_split_candidates(tnet, 4, cpu4)
    assert splits[0] is None and len(splits) > 1
    assert {c.mesh_split for c in ttune.enumerate_space(
        tnet, batch=4, device="cpu", devices=cpu4)} == set(splits)
    base = ttune.baseline_candidate(tnet, batch=4, device="cpu",
                                    devices=cpu4)
    from repro_torch.launch import mesh as t_mesh
    assert base.mesh_split is not None
    assert base.mesh_split == t_mesh.mesh_split(
        t_mesh.serving_mesh_for(tnet, 4, cpu4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttune.enumerate_space(tnet, batch=4)


# ---------------------------------------------------------------- measure


def test_median_and_interleaving_order():
    for tn in (jtune, ttune):
        assert tn.median([3.0, 1.0, 2.0]) == 2.0
        assert tn.median([4.0, 1.0, 3.0, 2.0]) == 3.0   # upper median
        with pytest.raises(ValueError):
            tn.median([])
    seen = []
    for tn in (jtune, ttune):
        calls = []
        outs = tn.interleaved_rounds(
            [lambda: calls.append("a") or 1, lambda: calls.append("b") or 2],
            rounds=2, warmup=1)
        assert calls == ["a", "b", "a", "b", "a", "b"]
        seen.append((calls, outs))
        with pytest.raises(ValueError, match="round"):
            tn.interleaved_rounds([], rounds=0)
        with pytest.raises(ValueError, match="warmup"):
            tn.interleaved_rounds([], rounds=1, warmup=-1)
    assert seen[0] == seen[1]


def test_interleaved_medians_fake_clock():
    meds = []
    for tn in (jtune, ttune):
        t = [0.0]
        costs = iter([5.0, 3.0, 4.0])

        def slow():
            t[0] += next(costs)

        def fast():
            pass
        meds.append(tn.interleaved_medians([slow, fast], rounds=3,
                                           clock=lambda: t[0], warmup=0))
    assert meds[0] == meds[1] == [4.0, 0.0]


# ----------------------------------------------------------------- search


def test_autotune_deterministic_fake_timer(clean):
    """The full driver under one scripted runner in both packages: the
    cheapest candidate wins, the baseline survives to the final rounds,
    the measured-step count honors the budget — and the two packages'
    trials, winner and count are equal."""
    pair = _net_both()
    n = len(pair[1].layers)
    budget = {name: tn.TuneBudget(shortlist=4, rounds=2, eta=2,
                                  max_rounds=4)
              for name, (tn, _) in PKGS.items()}

    def costs(c):                   # reference wins big, lookahead=2 best
        s = 1.0 if c.policy == ("reference",) * n else 4.0
        return s - 0.1 * c.lookahead

    res = []
    for (name, (tn, _)), net in zip(sorted(PKGS.items()), pair):
        extra = {} if name == "jax" else {"device": "cpu"}
        clock, runner = _fake(costs)
        res.append(tn.autotune(net, batch=4, budget=budget[name],
                               clock=clock, runner=runner, store=False,
                               **extra))
    j, t = res
    _same_result(j, t)
    win = t.config.candidate
    assert win.policy == ("reference",) * n and win.lookahead == 2
    assert t.config.median_s == pytest.approx(0.8)
    base = ttune.baseline_candidate(pair[1], batch=4, device="cpu")
    assert t.config.baseline_s == pytest.approx(
        (1.0 if base.policy == ("reference",) * n else 4.0) - 0.1)
    final = [x for x in t.trials if x.rounds == t.config.rounds]
    assert any(x.candidate == base for x in final)
    assert t.measurements == sum(x.rounds + 1 for x in t.trials)
    assert sorted({x.rounds for x in t.trials}) == [2, 4]
    assert ttune.tuned_config(pair[1], batch=4, device="cpu") is None


def test_autotune_winner_never_slower_than_baseline_by_construction(clean):
    """Every challenger worse than the default: both packages keep the
    default, on equal evidence."""
    j, t = _autotune_both(
        _net_both(), lambda base: (lambda c: 1.0 if c == base else 9.0),
        batch=4, store=False)
    _same_result(j, t)
    assert t.config.candidate == ttune.baseline_candidate(
        _net_both()[1], batch=4, device="cpu")
    assert t.config.median_s <= t.config.baseline_s


def test_autotune_smoke_budget_same_trials(clean):
    """SMOKE_BUDGET with a cost that separates every knob: equal trials
    in both packages."""
    res = _autotune_both(
        _net_both(), lambda base: (lambda c: (
            len(set(c.policy)) + 0.25 * c.lookahead
            + 0.5 * c.policy.count("mapped") - 0.125 * (c.tiers is None))),
        batch=2, store=False, ragged=(1, 2, 2))
    _same_result(*res)
    assert {x.candidate.tiers for x in res[1].trials} == {None, (2,)}


def test_autotune_persists_and_cold_process_loads(tmp_path, clean):
    """Winners survive a process restart in both packages, with equal
    results: a cold cache adopts the tuned config with zero measurements
    (memo counters asserted), and the port's `compile_plan(
    executor_policy="tuned", device="cpu")` serves it — falling back to
    the auto executors before anything was tuned."""
    pair = _net_both()
    n = len(pair[1].layers)
    res, res2 = [], []
    for (name, (tn, memo)), net in zip(sorted(PKGS.items()), pair):
        extra = {} if name == "jax" else {"device": "cpu"}
        memo.set_disk_cache(tmp_path / name)
        clock, runner = _fake(
            lambda c: 0.5 if c.policy == ("reference",) * n else 2.0)
        res.append(tn.autotune(net, batch=4, budget=tn.SMOKE_BUDGET,
                               clock=clock, runner=runner, **extra))
        memo.clear()
        st0 = dict(memo.stats)

        def exploding(_cand):
            raise AssertionError("cold process must not measure")
        res2.append(tn.autotune(net, batch=4, clock=clock,
                                runner=exploding, **extra))
        assert res2[-1].cached and res2[-1].measurements == 0
        assert res2[-1].config == res[-1].config
        assert memo.stats["disk_hits"] >= st0.get("disk_hits", 0) + 1
        assert tn.tuned_config(net, batch=16, **extra) == res[-1].config
    _same_result(*res)
    _same_result(*res2)

    tnet = pair[1]
    win = res[1].config.candidate
    plan = compile_plan(tnet, executor_policy="tuned", batch=4, device="cpu")
    assert plan.executors == win.policy
    assert plan.lookahead == win.lookahead
    # the generic slot: other batches inherit the tuning
    assert compile_plan(tnet, executor_policy="tuned", batch=16,
                        device="cpu").executors == win.policy


def test_tuned_policy_falls_back_then_takes_the_winner(clean):
    """Untuned, "tuned" is "auto"; tuned, the plan takes the winner's
    policy, lookahead, block and budget where the caller left them unset
    — and the caller's own values where given."""
    _, tnet = _net_both()
    n = len(tnet.layers)
    auto = compile_plan(tnet, executor_policy="auto", batch=4, device="cpu")
    untuned = compile_plan(tnet, executor_policy="tuned", batch=4,
                           device="cpu")
    assert untuned.executors == auto.executors
    base = ttune.baseline_candidate(tnet, batch=4, device="cpu")
    pick = ttune.Candidate(policy=("reference",) * n, lookahead=2,
                           block="window", vmem_budget=1 << 20)
    clock, runner = _fake(lambda c: 1.0 if c == pick else 3.0)
    res = ttune.autotune(tnet, batch=4, device="cpu", space=(base, pick),
                         budget=ttune.SMOKE_BUDGET, clock=clock,
                         runner=runner)
    assert res.config.candidate == pick
    plan = compile_plan(tnet, executor_policy="tuned", batch=4, device="cpu")
    assert plan.executors == pick.policy and plan.lookahead == 2
    assert {(lp.block, lp.vmem_budget) for lp in plan.layers} == \
        {("window", 1 << 20)}
    own = compile_plan(tnet, executor_policy="tuned", batch=4, device="cpu",
                       lookahead=0, block="whole")
    assert own.lookahead == 0 and {lp.block for lp in own.layers} == \
        {"whole"}


def test_fleets_do_not_share_winners(clean, monkeypatch):
    """A winner tuned for the card's fleet is not found by a cpu plan,
    and a cpu winner is not found by a cuda plan; the key's fleet comes
    from the plan's device, not from the card that is present."""
    _, tnet = _net_both()
    n = len(tnet.layers)
    assert ttune.fleet_signature("cpu") == ("cpu", 1)
    card = ttune.TunedConfig(
        candidate=ttune.Candidate(policy=("reference",) * n, lookahead=2),
        median_s=1.0, baseline_s=2.0, rounds=4, measurements=9,
        fleet=("cuda", 1), batch=4)
    tmemo.store_tuning(ttune.tuning_key(tnet, ("cuda", 1), 4), card)
    tmemo.store_tuning(ttune.tuning_key(tnet, ("cuda", 1), None), card)
    assert ttune.tuned_config(tnet, batch=4, device="cpu") is None
    plan = compile_plan(tnet, executor_policy="tuned", batch=4, device="cpu")
    assert plan.executors == compile_plan(
        tnet, executor_policy="auto", batch=4, device="cpu").executors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ttune.fleet_signature("cuda") == ("cuda", 1)
    assert ttune.tuned_config(tnet, batch=4, device="cuda") == card
    tmemo.clear()
    clock, runner = _fake(lambda c: 1.0)
    ttune.autotune(tnet, batch=4, device="cpu", budget=ttune.SMOKE_BUDGET,
                   clock=clock, runner=runner)
    assert ttune.tuned_config(tnet, batch=4, device="cpu") is not None
    assert ttune.tuned_config(tnet, batch=4, device="cuda") is None


def test_a_persisted_mesh_split_raises(clean):
    """A winner's mesh split is served as the JAX package serves it: the
    plan and the cache take it as it is, `mesh_from_split` realises it
    over enough devices and gives None (the single-device path) over too
    few, `resolve_tiers` pads the tiers to the realised mesh's data axis,
    and only a value that is not a mesh raises."""
    from repro_torch.launch import mesh as t_mesh
    _, tnet = _net_both()
    n = len(tnet.layers)
    split = ttune.TunedConfig(
        candidate=ttune.Candidate(policy=("reference",) * n,
                                  mesh_split=(2, 1, 1)),
        median_s=1.0, baseline_s=1.0, rounds=2, measurements=4,
        fleet=("cpu", 1), batch=4)
    tmemo.store_tuning(ttune.tuning_key(tnet, ("cpu", 1), 4), split)
    plan = compile_plan(tnet, executor_policy="tuned", batch=4, device="cpu")
    assert plan.executors == ("reference",) * n
    res = ttune.autotune(tnet, batch=4, device="cpu")
    assert res.cached and res.config.candidate.mesh_split == (2, 1, 1)
    cpu = torch.device("cpu")
    assert t_mesh.mesh_from_split((2, 1, 1), [cpu]) is None
    mesh = t_mesh.mesh_from_split((2, 1, 1), [cpu] * 4)
    assert mesh.shape == {"data": 2, "row": 1, "col": 1}
    assert ttune.resolve_tiers(split.candidate, 4) == (1, 2, 4)
    assert ttune.resolve_tiers(split.candidate, 4, mesh) == (2, 4)
    assert ttune.resolve_tiers(
        dataclasses.replace(split.candidate, tiers=(4, 1)), 6, mesh) == \
        (2, 4, 6)
    with pytest.raises(ValueError, match="invalid mesh"):
        ttune.resolve_tiers(ttune.Candidate(policy=("reference",)), 4,
                            mesh=object())
    one = dataclasses.replace(split.candidate, mesh_split=(1, 1, 1))
    assert t_mesh.mesh_from_split(one.mesh_split, [cpu] * 4) is None
    assert ttune.resolve_tiers(one, 4) == (1, 2, 4)
    assert ttune.resolve_tiers(
        dataclasses.replace(one, tiers=(4, 1)), 6) == (1, 4, 6)


def test_autotune_rejects_bad_inputs():
    jnet, tnet = _net_both()
    for tn, net, extra in ((jtune, jnet, {}),
                           (ttune, tnet, {"device": "cpu"})):
        with pytest.raises(ValueError, match="batch"):
            tn.autotune(net, batch=0, **extra)
        with pytest.raises(ValueError, match="malformed budget"):
            tn.TuneBudget(rounds=0)
        with pytest.raises(ValueError, match="malformed budget"):
            tn.TuneBudget(rounds=4, max_rounds=2)
        with pytest.raises(ValueError, match="malformed budget"):
            tn.TuneBudget(eta=1)
    assert dataclasses.astuple(jtune.SMOKE_BUDGET) == \
        dataclasses.astuple(ttune.SMOKE_BUDGET)
    assert dataclasses.astuple(jtune.TuneBudget()) == \
        dataclasses.astuple(ttune.TuneBudget())


# ------------------------------------------------------------ persistence


COLD = """
import json, sys
from repro_torch import tune
from repro_torch.core import ArrayConfig, MacroGrid, map_net, memo, networks
from repro_torch.exec import compile_plan
memo.set_disk_cache(sys.argv[1])
net = map_net("cnn8", networks.cnn8(), ArrayConfig(64, 64), "TetrisG-SDK",
              MacroGrid(2, 2), groups=(1, 2))
def exploding(_cand):
    raise AssertionError("a cold process must not measure")
res = tune.autotune(net, batch=4, device="cpu", runner=exploding)
plan = compile_plan(net, executor_policy="tuned", batch=4, device="cpu")
print(json.dumps({"cached": res.cached, "measurements": res.measurements,
                  "policy": list(res.config.candidate.policy),
                  "executors": list(plan.executors),
                  "lookahead": plan.lookahead,
                  "table_misses": memo.stats["table_misses"],
                  "jax": [m for m in sys.modules
                          if m.split(".")[0] in ("jax", "repro")]}))
"""


def test_cold_process_loads_with_zero_measurements(tmp_path, clean):
    """A fresh CPU process with the warm cache: the winner with zero
    measurements, zero table builds, and "tuned" plans serve it."""
    tmemo.set_disk_cache(tmp_path)
    tmemo.clear()
    _, tnet = _net_both()               # the mapping goes to disk too
    n = len(tnet.layers)
    clock, runner = _fake(
        lambda c: 0.5 - 0.1 * c.lookahead if c.policy == ("reference",) * n
        else 2.0)
    res = ttune.autotune(tnet, batch=4, device="cpu",
                         budget=ttune.SMOKE_BUDGET, clock=clock,
                         runner=runner)
    out = subprocess.run(
        [sys.executable, "-c", COLD, str(tmp_path)], check=True,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES="")).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got == {"cached": True, "measurements": 0,
                   "policy": list(res.config.candidate.policy),
                   "executors": list(res.config.candidate.policy),
                   "lookahead": res.config.candidate.lookahead,
                   "table_misses": 0, "jax": []}


def test_packages_sharing_one_cache_load_their_own(tmp_path, clean):
    """Both packages tune one net into ONE cache directory with different
    winners; after both in-memory caches are dropped each loads only its
    own winner, of its own classes (memo.NAMESPACE keys the port's
    files apart)."""
    jnet, tnet = _net_both()
    n = len(tnet.layers)
    for memo in (jmemo, tmemo):
        memo.set_disk_cache(tmp_path)
    wins = {"jax": ("reference",) * n, "port": ("mapped",) * n}
    for (name, (tn, _)), net in zip(sorted(PKGS.items()), (jnet, tnet)):
        extra = {} if name == "jax" else {"device": "cpu"}
        clock, runner = _fake(lambda c, w=wins[name]: 0.5 if c.policy == w
                              else 2.0)
        res = tn.autotune(net, batch=4, budget=tn.SMOKE_BUDGET, clock=clock,
                          runner=runner, **extra)
        assert res.config.candidate.policy == wins[name]
    assert len(list(tmp_path.glob("*.mapping.pkl"))) >= 4
    jmemo.clear()
    tmemo.clear()
    j = jtune.tuned_config(jnet, batch=4)
    t = ttune.tuned_config(tnet, batch=4, device="cpu")
    assert j.candidate.policy == wins["jax"]
    assert t.candidate.policy == wins["port"]
    assert type(j).__module__ == "repro.tune.space"
    assert type(t).__module__ == "repro_torch.tune.space"
    assert type(t.candidate).__module__ == "repro_torch.tune.space"


# ------------------------------------------------------ real measurement


def _oracle_check(net, plan, batch):
    from repro_torch.launch import serve_cnn
    ks, xh = serve_cnn.serving_inputs(net, batch, 1, "cpu")
    x = torch.as_tensor(xh)
    y = execute_plan(plan, ks, x)
    r = execute_oracle(plan, ks, x)
    assert torch.isfinite(y).all()
    assert_close(y, r.numpy(), RTOL_NET)


def test_autotune_cnn8_real_smoke_fixed(clean):
    """cnn8 (64x64) with SMOKE_BUDGET on the CPU, real wall-clock: the
    winner's final median is never above the default's from the same
    rounds, and its plan forward matches the oracle."""
    _, tnet = _net_both()
    res = ttune.autotune(tnet, batch=2, device="cpu",
                         budget=ttune.SMOKE_BUDGET)
    assert res.measurements > 0
    assert res.config.median_s <= res.config.baseline_s
    assert res.config.fleet == ("cpu", 1)
    plan = compile_plan(tnet, executor_policy="tuned", batch=2, device="cpu")
    assert plan.executors == res.config.candidate.policy
    _oracle_check(tnet, plan, 2)


def test_autotune_cnn8_real_smoke_ragged(clean):
    """The ragged profile: each measured step is one backlogged
    serve_dynamic drain through the candidate's tiers; the winner is
    stored under the ragged key only, and its plan matches the oracle."""
    _, tnet = _net_both()
    ragged = (1, 2, 1, 2, 2, 1)
    res = ttune.autotune(tnet, batch=4, device="cpu", ragged=ragged,
                         budget=ttune.SMOKE_BUDGET, max_delay_ms=2.0)
    assert res.measurements > 0 and not res.cached
    assert res.config.median_s <= res.config.baseline_s
    assert res.key == ttune.tuning_key(tnet, ("cpu", 1), 4, ragged)
    assert any(t.candidate.tiers == (4,) for t in res.trials)
    assert ttune.tuned_config(tnet, batch=4, device="cpu") is None
    cand = res.config.candidate
    assert ttune.tuned_config(tnet, batch=4, device="cpu",
                              ragged=ragged) == res.config
    plan = compile_plan(tnet, executor_policy=cand.policy, batch=4,
                        lookahead=cand.lookahead, block=cand.block,
                        vmem_budget=cand.vmem_budget, device="cpu")
    _oracle_check(tnet, plan, 4)


def test_autotune_layer_set_runs_layerwise(clean):
    """Inception's layer set does not chain: the runner measures
    execute_layerwise forwards of a layerwise plan."""
    _, tnet = map_net_both("inception",
                           lambda core: core.networks.inception()[:3],
                           (64, 64), "TetrisG-SDK", (2, 2), groups=(1, 2))
    assert not ttune.search._chains(tnet)
    res = ttune.autotune(tnet, batch=1, device="cpu",
                         budget=ttune.TuneBudget(shortlist=2, rounds=1,
                                                 eta=2, max_rounds=2),
                         store=False)
    assert res.measurements == sum(t.rounds + 1 for t in res.trials)
    assert res.config.median_s <= res.config.baseline_s


# -------------------------------------------------------- serving paths


def _tune_reference(tnet, batch=4):
    n = len(tnet.layers)
    clock, runner = _fake(
        lambda c: 0.5 if c.policy == ("reference",) * n else 2.0)
    res = ttune.autotune(tnet, batch=batch, device="cpu",
                         budget=ttune.SMOKE_BUDGET, clock=clock,
                         runner=runner)
    assert res.config.candidate.policy == ("reference",) * n
    return res.config.candidate


def test_plan_ladder_tuned_compiles_each_tier_once(clean):
    """A "tuned" ladder serves the winner at every tier (the generic
    slot) and compiles each tier once; a second ladder compiles
    nothing."""
    from repro_torch.launch import batching
    _, tnet = _net_both()
    win = _tune_reference(tnet)
    lad = batching.PlanLadder(tnet, (1, 2, 4), policy="tuned", device="cpu")
    again = batching.PlanLadder(tnet, (1, 2, 4), policy="tuned",
                                device="cpu")
    for tier in lad.tiers:
        assert lad.plans[tier].executors == win.policy
        assert lad.plans[tier].lookahead == win.lookahead
        assert again.plans[tier] is lad.plans[tier]
    counts = compile_counts(net=tnet)
    assert sorted(k[2] for k in counts if k[1] == win.policy) == [1, 2, 4]
    assert set(counts.values()) == {1}


def test_serve_and_fleet_take_the_tuned_policy(clean):
    """serve(policy="tuned"), serve_dynamic and serve_fleet compile the
    winner's executors."""
    from repro_torch.launch import batching, fleet, serve_cnn
    _, tnet = _net_both()
    win = _tune_reference(tnet)
    s = serve_cnn.serve(tnet, 2, 1, warmup=0, policy="tuned", device="cpu")
    assert s.plan.executors == win.policy
    clk = batching.VClock()
    serve_cnn.serve_dynamic(tnet, [(0.0, 1), (0.0, 3)], max_batch=4,
                            max_delay_ms=1.0, policy="tuned", warmup=0,
                            device="cpu", clock=clk, sleep=clk.sleep)
    config = fleet.FleetConfig(models=(fleet.ModelSpec(
        "cnn8", max_batch=4, max_delay_s=1e-3),))
    trace = fleet.mixed_poisson_trace(["cnn8"], 4, 0.0, 2, seed=0)
    clk = batching.VClock()
    stats, _ = fleet.serve_fleet({"cnn8": tnet}, config, trace,
                                 policy="tuned", warmup=0, device="cpu",
                                 clock=clk, sleep=clk.sleep)
    assert stats.request_images == sum(r for _, _, r in trace)
    assert {k[1] for k in compile_counts(net=tnet)} == {win.policy}


def test_replica_worker_serves_the_tuned_winner(tmp_path, clean):
    """A replica worker configured with policy "tuned" and the warm cache
    builds its ladder from the winner (run in-process over plain queues:
    ready, one request, stop) and measures nothing."""
    from repro_torch.launch import batching, replica
    tmemo.set_disk_cache(tmp_path)
    tmemo.clear()
    _, tnet = _net_both("cnn8")
    cfg = replica.WorkerConfig(net="cnn8", array=(64, 64), grid=(2, 2),
                               groups=(1, 2), max_batch=4, policy="tuned",
                               cache_dir=str(tmp_path), warmup=0,
                               device="cpu")
    assert replica._build_mapping(cfg) == tnet
    win = _tune_reference(tnet)
    tmemo.clear()
    task_q, result_q = queue.Queue(), queue.Queue()
    task_q.put((batching.CTRL_GO, time.time()))
    task_q.put(batching.WorkItem(0, 3, 0.0))
    task_q.put((batching.CTRL_STOP,))
    replica._worker_main(0, cfg, task_q, result_q)
    msgs = []
    while not result_q.empty():
        msgs.append(result_q.get())
    kinds = [m[0] for m in msgs]
    assert kinds[0] == batching.MSG_READY and batching.MSG_DYING not in kinds
    assert msgs[0][3] == 0                      # no table builds
    done = [m for m in msgs if m[0] == batching.MSG_DONE]
    assert [e[0] for m in done for e in m[3]] == [0]
    assert {k[1] for k in compile_counts(net=tnet)} == {win.policy}


def test_cli_autotune_then_cache_then_policy_tuned(capsys, tmp_path, clean):
    """``--autotune`` searches once and prints the measured steps; a
    second run finds the winner in the cache; ``--policy tuned`` then
    serves it; the dynamic mode tunes its ragged profile."""
    from repro_torch.launch import serve_cnn
    base = ["--net", "cnn8", "--ar", "64", "--ac", "64", "--grid", "2x2",
            "--batch", "2", "--steps", "1", "--warmup", "1", "--device",
            "cpu", "--cache-dir", str(tmp_path)]
    try:
        s1 = serve_cnn.main(base + ["--autotune"])
        first = capsys.readouterr().out
        s2 = serve_cnn.main(base + ["--autotune"])
        second = capsys.readouterr().out
        s3 = serve_cnn.main(base + ["--policy", "tuned"])
        third = capsys.readouterr().out
        d = serve_cnn.main(base + ["--autotune", "--max-delay-ms", "2",
                                   "--max-batch", "4", "--requests", "6"])
        dyn = capsys.readouterr().out
    finally:
        tmemo.set_disk_cache(None)
    assert "autotune: tuned[" in first and "measured steps)]" in first
    assert "[cache]" in second and "measured steps" not in second
    assert s1.plan.executors == s2.plan.executors == s3.plan.executors
    assert "executor=tuned:" in first and "executor=tuned" in third
    assert "autotune: tuned[" in dyn and "serve_dyn/cnn8/all," in dyn
    assert d.request_images == sum(
        r for _, r in serve_cnn.poisson_arrivals(6, 0.0, 4, seed=0))


# ---------------------------------------------------------------- report


def test_report_csv_json_trajectory_equal_jax(tmp_path, clean):
    """The report's CSV, JSON and trajectory entry equal the JAX
    package's for equal searches."""
    res = _autotune_both(_net_both(), lambda base: (lambda c: 1.0),
                         batch=4, store=False)
    texts = []
    for (name, (tn, _)), r in zip(sorted(PKGS.items()), res):
        results = {"cnn8": r}
        csv = tn.write_csv(results, str(tmp_path / f"{name}.csv"))
        assert (tmp_path / f"{name}.csv").read_text() == csv
        js = tn.write_json(results, str(tmp_path / f"{name}.json"))
        entry = tn.trajectory_entry(results, pr="x", note="test")
        ledger = tmp_path / f"{name}_ledger.json"
        tn.append_trajectory(str(ledger), entry)
        tn.append_trajectory(str(ledger), entry)
        texts.append((csv, json.loads(js), entry,
                      json.loads(ledger.read_text())))
    assert texts[0] == texts[1]
    csv = texts[1][0]
    assert csv.splitlines()[0] == "name,usec,extras"
    assert any(line.startswith("tune/cnn8,") for line in csv.splitlines())
    assert "speedup=" in csv and "baseline_us=" in csv
    assert len(texts[1][3]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(ValueError, match="JSON list"):
        ttune.append_trajectory(str(bad), texts[1][2])


def test_tune_imports_no_jax_and_no_kernel():
    """The tuner stands alone: importing it loads neither JAX nor the
    JAX package, and builds no kernel."""
    code = ("import sys\n"
            "import repro_torch.tune, repro_torch.core.simulator\n"
            "from repro_torch.configs import CNN_IDS, get_config\n"
            "[get_config(c) for c in CNN_IDS]\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._loaded\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert np.__name__ == "numpy"
