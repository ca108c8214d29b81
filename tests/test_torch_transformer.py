"""The port's transformer path against the JAX package's: the configs
and their lowering (layers, glue and mappings field for field, smoke and
full width), the compiled plans (executors, glue, carries, memory
estimates, allowed remat cuts), the forward through the "matmul"
executor and the attention stage (the JAX kernels in interpret mode),
the attention stage at a ragged M, explicit-glue guards,
and serving a lowered transformer on the CPU with the JAX package's
weights."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import RTOL_LAYER, RTOL_NET, assert_close, t  # noqa: E402
from repro import configs as j_configs                          # noqa: E402
from repro import core as jcore                                 # noqa: E402
from repro.exec import compile_plan as j_compile                # noqa: E402
from repro.exec import execute_plan as j_execute                # noqa: E402
from repro.exec import glue as j_glue                           # noqa: E402
from repro.exec import plan as j_plan                           # noqa: E402
from repro.exec import remat as j_remat                         # noqa: E402
from repro.launch import serve_cnn as j_serve                   # noqa: E402
from repro.launch import transformer as j_tf                    # noqa: E402
from repro_torch import configs                                 # noqa: E402
from repro_torch import core as tcore                           # noqa: E402
from repro_torch.cnn import kernels_from_numpy                 # noqa: E402
from repro_torch.exec import (EXECUTORS, allowed_cuts,          # noqa: E402
                              compile_plan, execute_oracle, execute_plan)
from repro_torch.exec import glue, run                          # noqa: E402
from repro_torch.exec.plan import _auto_executor                # noqa: E402
from repro_torch.kernels import flash_attention as fa           # noqa: E402
from repro_torch.launch import serve_cnn                        # noqa: E402
from repro_torch.launch import transformer as tf                # noqa: E402

#: (name, seq, array side, blocks): the smoke cases of the CPU tests
SMOKE = {"stablelm_g2": ("stablelm_smoke", 16, 64, 2),
         "stablelm_g1": ("stablelm_smoke", 16, 128, 2),
         "whisper": ("whisper_smoke", 16, 64, 2)}
#: the full-width models the card serves: (arch, seq)
FULL = {"stablelm-1.6b": ("stablelm_1_6b", 512),
        "whisper-base": ("whisper_base", 1024)}


def _lower(case):
    """(jax mapping, port mapping) of a SMOKE or FULL case."""
    if case in SMOKE:
        name, seq, side, blocks = SMOKE[case]
        cfgs = (name, name)
        kw = {"seq": seq, "blocks": blocks}
    else:
        arch, seq = FULL[case]
        cfgs = (j_configs.get_config(arch), configs.get_config(arch))
        side, kw = 512, {"seq": seq}
    out = [mod.transformer_mapping(cfg, array=core.ArrayConfig(side, side),
                                   **kw)
           for mod, core, cfg in ((j_tf, jcore, cfgs[0]),
                                  (tf, tcore, cfgs[1]))]
    assert dataclasses.astuple(out[0]) == dataclasses.astuple(out[1])
    return tuple(out)


def _data(net, seed, batch=2):
    """Seeded numpy kernels (1, 1, ic//G, oc) x 0.1 and (B, d, M, 1)
    input, drawn the way serving draws them."""
    rng = np.random.RandomState(seed)
    ks = [(rng.randn(1, 1, m.layer.ic // m.group, m.layer.oc) * 0.1)
          .astype(np.float32) for m in net.layers]
    first = net.layers[0].layer
    return ks, rng.randn(batch, first.ic, first.i_h, 1).astype(np.float32)


# --- configs and lowering -------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm_1_6b", "whisper_base"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match(arch, smoke):
    want = dataclasses.asdict(j_configs.get_config(arch, smoke))
    assert dataclasses.asdict(configs.get_config(arch, smoke)) == want
    assert configs.get_config(arch.replace("_", "-"), smoke).name == \
        want["name"]


def test_unported_configs_raise():
    """Every id of ``ARCH_IDS`` loads (``all_configs``, full and smoke,
    equal to the JAX package's); only an unknown id raises."""
    assert configs.ARCH_IDS == j_configs.ARCH_IDS
    for smoke in (False, True):
        got, want = configs.all_configs(smoke), j_configs.all_configs(smoke)
        assert list(got) == list(want)
        assert [dataclasses.asdict(c) for c in got.values()] == \
            [dataclasses.asdict(c) for c in want.values()]
    with pytest.raises(ValueError, match="unknown"):
        configs.get_config("no_such_model")


@pytest.mark.parametrize("case", list(SMOKE) + list(FULL))
def test_lowering_matches_jax(case):
    """Layers, glue and the searched mappings equal the JAX package's
    field for field (asserted in _lower); the full models lower to the
    groups the card serves them with."""
    jnet, tnet = _lower(case)
    assert [dataclasses.astuple(g) for g in tnet.glue] == \
        [dataclasses.astuple(g) for g in jnet.glue]
    assert len(tnet.glue) == len(tnet.layers)
    assert tf.tokens_per_row(tnet) == j_tf.tokens_per_row(jnet)
    assert set(tf.TRANSFORMERS) == set(j_tf.TRANSFORMERS)
    groups = {m.group for m in tnet.layers}
    if case == "stablelm-1.6b":
        assert len(tnet.layers) == 96 and groups == {4}
    if case == "whisper-base":
        assert len(tnet.layers) == 24 and groups == {1}
        assert not any(g.causal for g in tnet.glue
                       if g.post == "attention")


# --- plans ----------------------------------------------------------------

@pytest.mark.parametrize("case,remat", [
    ("stablelm_g2", None), ("stablelm_g2", "auto"), ("whisper", "auto"),
    ("stablelm-1.6b", None), ("whisper-base", "auto")])
def test_plan_parity(case, remat):
    """The card's executors (matmul on every layer, as a TPU picks),
    glue, carries, memory estimates, allowed cuts and remat segments
    equal the JAX package's plan."""
    jnet, tnet = _lower(case)
    jp = j_compile(jnet, executor_policy="matmul", batch=2, interpret=True,
                   remat=remat)
    tp = compile_plan(tnet, executor_policy="matmul", batch=2, device="cpu",
                      remat=remat)
    assert tp.executors == jp.executors == ("matmul",) * len(tnet.layers)
    assert [_auto_executor(m, backend="cuda") for m in tnet.layers] == \
        [j_plan._auto_executor(m, backend="tpu") for m in jnet.layers]
    assert tp.total_steps == jp.total_steps == tnet.total_cycles
    assert [dataclasses.astuple(lp.glue) for lp in tp.layers] == \
        [dataclasses.astuple(lp.glue) for lp in jp.layers]
    assert [lp.carry_c for lp in tp.layers] == \
        [lp.carry_c for lp in jp.layers]
    assert tp.describe_memory() == jp.describe_memory()
    assert tp.peak_bytes == jp.peak_bytes
    assert allowed_cuts(tuple(lp.glue for lp in tp.layers)) == \
        j_remat.allowed_cuts(tuple(lp.glue for lp in jp.layers))
    assert tp.segments == jp.segments


# --- forward --------------------------------------------------------------

@pytest.mark.parametrize("case", list(SMOKE))
def test_forward_matches_jax(case):
    """The slice end to end on the CPU: the port's plan (matmul executor
    -> the matmul plain versions, the attention stage -> the attention
    plain version) and its oracle against the JAX package's
    execute_plan, whose matmul executor and attention stage run the
    Pallas kernels in interpret mode.  stablelm_g2 maps to G = 2
    (grouped_matmul), the other two to G = 1 (tetris_matmul); whisper is
    bidirectional."""
    jnet, tnet = _lower(case)
    want_g = 2 if case == "stablelm_g2" else 1
    assert {m.group for m in tnet.layers} == {want_g}
    ks, x = _data(tnet, seed=51)
    jp = j_compile(jnet, executor_policy="matmul", batch=2, interpret=True)
    want = np.asarray(j_execute(jp, [jnp.asarray(k) for k in ks],
                                jnp.asarray(x)))
    tp = compile_plan(tnet, executor_policy="matmul", batch=2, device="cpu")
    tks = kernels_from_numpy(ks, device="cpu")
    assert_close(execute_plan(tp, tks, t(x)), want, RTOL_NET)
    assert_close(execute_oracle(tp, tks, t(x)), want, RTOL_NET)


def test_explicit_glue_ignores_global_activation():
    _, tnet = _lower("stablelm_g1")
    ks, x = _data(tnet, seed=52, batch=1)
    tp = compile_plan(tnet, executor_policy="matmul", batch=1, device="cpu")
    tks = [t(k) for k in ks]
    base = execute_plan(tp, tks, t(x))
    torch.testing.assert_close(
        execute_plan(tp, tks, t(x), activation=torch.relu), base,
        rtol=0, atol=0)


@pytest.mark.parametrize("m", [136, 128])
def test_attention_stage_matches_jax(monkeypatch, m):
    """M = 136 neither fits one 128 block nor tiles by 128: the JAX
    package takes its plain softmax branch there, the port still takes
    mha_flash (its CUDA kernel masks ragged tiles), and both agree.
    ``plain=True`` never reaches mha_flash."""
    hq, hkv, hd = 4, 2, 16
    rng = np.random.RandomState(53)
    y = rng.randn(2, (hq + 2 * hkv) * hd, m, 1).astype(np.float32)
    want = np.asarray(j_glue.attention_stage(jnp.asarray(y), (hq, hkv, hd),
                                             True, interpret=True))
    calls = []
    real = fa.mha_flash
    monkeypatch.setattr(fa, "mha_flash",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = glue.attention_stage(t(y), (hq, hkv, hd), True)
    assert_close(got, want, RTOL_LAYER)
    assert len(calls) == 1
    assert_close(glue.attention_stage(t(y), (hq, hkv, hd), True, plain=True),
                 want, RTOL_LAYER)
    assert len(calls) == 1


def test_layernorm_matches_jax():
    x = np.random.RandomState(54).randn(2, 24, 5, 1).astype(np.float32) * 3
    assert_close(glue.layernorm(t(x)), np.asarray(j_glue.layernorm(
        jnp.asarray(x))), RTOL_LAYER)


# --- the executor fault and the guards ------------------------------------

def test_matmul_executor_is_dispatched(monkeypatch):
    """On the card, "auto" names "matmul" for op="matmul" layers: that
    name is an executor the plan accepts, and execute_plan dispatches
    every such layer to matmul_layer (run here with the CPU's plain
    versions)."""
    _, tnet = _lower("stablelm_g1")
    names = [_auto_executor(m, backend="cuda") for m in tnet.layers]
    assert set(names) == {"matmul"} and "matmul" in EXECUTORS
    plan = compile_plan(tnet, executor_policy=names, batch=2, device="cpu")
    calls = []
    real = run.matmul_layer
    monkeypatch.setattr(run, "matmul_layer",
                        lambda *a: calls.append(a[0]) or real(*a))
    ks, x = _data(tnet, seed=55)
    y = execute_plan(plan, [t(k) for k in ks], t(x))
    assert calls == list(tnet.layers)
    assert tuple(y.shape) == (2, 128, 16, 1)


def test_compile_guards():
    """A matmul executor on a conv layer, a residual with nothing saved,
    a dangling save and a wrong attention width fail at compile time."""
    from repro_torch.core import ArrayConfig, MacroGrid, map_net, networks
    cnn = map_net("cnn8", networks.cnn8()[:2], ArrayConfig(64, 64),
                  "Tetris-SDK", MacroGrid(2, 2))
    with pytest.raises(ValueError, match="requires op='matmul'"):
        compile_plan(cnn, executor_policy="matmul", device="cpu")
    _, net = _lower("stablelm_g1")
    bad = dataclasses.replace(net, glue=(
        tcore.GlueSpec(kind="residual"),) + net.glue[1:])
    with pytest.raises(ValueError, match="no saved"):
        compile_plan(bad, executor_policy="matmul", device="cpu")
    dangling = dataclasses.replace(net, glue=net.glue[:-1] + (
        tcore.GlueSpec(kind="last", save=True),))
    with pytest.raises(ValueError, match="never consumed"):
        compile_plan(dangling, executor_policy="matmul", device="cpu")
    wide = dataclasses.replace(net, glue=(dataclasses.replace(
        net.glue[0], heads=(4, 4, 16)),) + net.glue[1:])
    with pytest.raises(ValueError, match="post='attention'"):
        compile_plan(wide, executor_policy="matmul", device="cpu")


# --- serving --------------------------------------------------------------

def test_serve_transformer_cpu_with_jax_weights():
    """serve() takes a lowered transformer: its kernels and input are the
    JAX package's draws bit for bit, kernels_from_numpy carries the JAX
    package's (1, 1, ic//G, oc) kernels across unchanged, and tokens/s
    counts batch x seq tokens."""
    jnet, tnet = _lower("stablelm_g2")
    rng, jks = j_serve._serving_kernels(jnet, 0)
    jx = rng.randn(2, 128, 16, 1).astype(np.float32)
    tks, tx = serve_cnn.serving_inputs(tnet, 2, 0, "cpu")
    np.testing.assert_array_equal(tx, jx)
    carried = kernels_from_numpy([np.asarray(k) for k in jks], device="cpu")
    for a, b, m in zip(tks, carried, tnet.layers):
        assert tuple(b.shape) == (1, 1, m.layer.ic // m.group, m.layer.oc)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    s = serve_cnn.serve(tnet, 2, steps=1, warmup=0, policy="matmul",
                        device="cpu", inputs=(tks, tx))
    assert s.plan.executors == ("matmul",) * len(tnet.layers)
    assert s.tokens_per_s == pytest.approx(2 * 16 / s.s_per_batch)
    cnn = serve_cnn.serve(tcore.map_net(
        "cnn8", tcore.networks.cnn8()[:2], tcore.ArrayConfig(64, 64),
        "Tetris-SDK"), 1, steps=1, warmup=0, device="cpu")
    assert cnn.tokens_per_s is None
