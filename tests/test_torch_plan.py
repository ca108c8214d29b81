"""The port's compiled plans (repro_torch.exec) against the JAX
package's: the same IR facts (executors, steps, memory estimates,
remat segments), the whole slice — cnn8 through compile_plan and
execute_plan with the executors a TPU or a card would pick — the
DenseNet40 concat chain, compile-time guards, and serving on the CPU
with the JAX package's kernels and inputs bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import (RTOL_NET, assert_close, map_net_both,  # noqa: E402
                           net_data, t)
from repro.exec import compile_plan as j_compile                # noqa: E402
from repro.exec import execute_plan as j_execute                # noqa: E402
from repro.launch import serve_cnn as j_serve                   # noqa: E402
from repro_torch.cnn import kernels_from_numpy                 # noqa: E402
from repro_torch.core import memo                               # noqa: E402
from repro_torch.exec import (compile_plan, execute_looped,     # noqa: E402
                              execute_oracle, execute_plan)
from repro_torch.exec.plan import _auto_executor                # noqa: E402
from repro_torch.launch import serve_cnn                        # noqa: E402

TETRISG = ((512, 512), "TetrisG-SDK", (1, 1), {"groups": (1, 2, 4)})


def _cnn8():
    arr, alg, grid, kw = TETRISG
    return map_net_both("cnn8", lambda core: core.networks.cnn8(), arr, alg,
                        grid, **kw)


def _densenet(n=None, arr=(64, 64), grid=(4, 1), groups=(1, 2)):
    return map_net_both("densenet40",
                        lambda core: core.networks.densenet40()[:n], arr,
                        "TetrisG-SDK", grid, groups=groups)


def _card_policy(net):
    """The executors the port picks on the card (== the JAX package's
    picks on a TPU) — pinned per layer so both packages run them here."""
    return [_auto_executor(m, backend="cuda") for m in net.layers]


@pytest.mark.parametrize("case,remat", [("cnn8", None), ("densenet40", None),
                                        ("densenet40", "auto"),
                                        ("densenet40", 4 * 1024 * 1024)])
def test_plan_parity(case, remat):
    jnet, tnet = _cnn8() if case == "cnn8" else _densenet()
    policy = _card_policy(tnet)
    jp = j_compile(jnet, executor_policy=policy, batch=2, interpret=True,
                   remat=remat)
    tp = compile_plan(tnet, executor_policy=policy, batch=2, device="cpu",
                      remat=remat)
    assert tp.executors == jp.executors == tuple(policy)
    assert tp.total_steps == jp.total_steps == tnet.total_cycles
    assert tp.segments == jp.segments
    assert tp.peak_bytes == jp.peak_bytes
    assert tp.unremat_peak_bytes == jp.unremat_peak_bytes
    assert tp.describe_memory() == jp.describe_memory()
    assert [dataclasses.astuple(lp.glue) for lp in tp.layers] == \
        [dataclasses.astuple(lp.glue) for lp in jp.layers]
    assert [(lp.carry_c, lp.block, lp.vmem_budget) for lp in tp.layers] \
        == [(lp.carry_c, lp.block, lp.vmem_budget) for lp in jp.layers]
    if case == "cnn8":
        assert tp.executors == ("reference",) + ("sdk",) * 5


def test_cnn8_slice_matches_jax():
    """The slice end to end: cnn8 mapped as serving maps it, planned with
    the card's executors (reference + five sdk layers), executed by both
    packages on the same kernels and batch-2 input."""
    jnet, tnet = _cnn8()
    policy = _card_policy(tnet)
    ks, x = net_data(tnet, np.random.RandomState(21), batch=2)
    jks = [jnp.asarray(k) for k in ks]
    jp = j_compile(jnet, executor_policy=policy, batch=2, interpret=True)
    want = np.asarray(j_execute(jp, jks, jnp.asarray(x)))
    tp = compile_plan(tnet, executor_policy=policy, batch=2, device="cpu")
    tks = kernels_from_numpy([np.asarray(k) for k in jks], "cpu")
    y = execute_plan(tp, tks, t(x))
    assert_close(y, want, RTOL_NET)
    assert torch.equal(y, execute_looped(tp, tks, t(x)))
    assert_close(execute_oracle(tp, tks, t(x)), want, RTOL_NET)


def test_densenet_concat_chain_reference():
    """DenseNet40's first block and transition: concat glue on the
    reference executor, against the JAX package's plan."""
    jnet, tnet = _densenet(13, arr=(512, 512), grid=(1, 1), groups=(1, 2, 4))
    ks, x = net_data(tnet, np.random.RandomState(22), batch=1)
    jp = j_compile(jnet, executor_policy="reference", batch=1)
    tp = compile_plan(tnet, executor_policy="reference", batch=1,
                      device="cpu")
    assert [lp.glue.kind for lp in tp.layers].count("concat") == 12
    want = np.asarray(j_execute(jp, [jnp.asarray(k) for k in ks],
                                jnp.asarray(x)))
    assert_close(execute_plan(tp, [t(k) for k in ks], t(x)), want, RTOL_NET)


def test_compile_plan_guards():
    """Compile-time errors: a non-chain, sdk on a mapping that owes a
    sub-grid, unknown policies, tensors on the wrong device or batch at
    execute time; "tuned" with nothing tuned is the auto policy."""
    _, inc = map_net_both("inception",
                          lambda core: core.networks.inception(), (64, 64),
                          "TetrisG-SDK", (2, 2), groups=(1, 2))
    with pytest.raises(ValueError, match="cannot chain"):
        compile_plan(inc, executor_policy="mapped", device="cpu")
    _, tnet = map_net_both("cnn8", lambda core: core.networks.cnn8(),
                           (64, 64), "TetrisG-SDK", (2, 2), groups=(1,))
    with pytest.raises(ValueError, match="cannot realize sub-grid"):
        compile_plan(tnet, executor_policy="sdk", device="cpu")
    for bad, msg in (("warp", "unknown executor"),
                     (["mapped"], "lists 1 executors")):
        with pytest.raises(ValueError, match=msg):
            compile_plan(tnet, executor_policy=bad, device="cpu")
    memo.clear()
    assert compile_plan(tnet, executor_policy="tuned", device="cpu"
                        ).executors == compile_plan(
        tnet, executor_policy="auto", device="cpu").executors
    plan = compile_plan(tnet, executor_policy="mapped", batch=2,
                        device="cpu")
    ks, x = net_data(tnet, np.random.RandomState(23), batch=2)
    with pytest.raises(ValueError, match="plan batch"):
        execute_plan(plan, [t(k) for k in ks], t(x[:1]))
    with pytest.raises(ValueError, match="compiled for cpu"):
        execute_plan(plan, [t(k).to("meta") for k in ks], t(x))


def test_serve_cpu_matches_jax_inputs(capsys):
    """serve(device="cpu") runs the fixed-mode loop; the CLI prints the
    serve/ CSV row; kernels and images are the JAX package's bit for
    bit."""
    jnet, tnet = _cnn8()
    s = serve_cnn.serve(tnet, 2, steps=1, warmup=1, policy="auto",
                        device="cpu")
    assert s.plan.executors == tuple(
        _auto_executor(m, backend="cpu") for m in tnet.layers)
    assert (s.request_batch, s.plan_batch, s.warmup_steps, s.donated) == \
        (2, 2, 1, False)
    assert s.images_per_s > 0
    rng, jks = j_serve._serving_kernels(jnet, 0)
    jx = rng.randn(2, 24, 18, 18).astype(np.float32)
    tks, tx = serve_cnn.serving_inputs(tnet, 2, 0, "cpu")
    for a, b in zip(tks, jks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tx, jx)
    serve_cnn.main(["--net", "cnn8", "--batch", "2", "--steps", "1",
                    "--warmup", "0", "--policy", "reference",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serve/cnn8/b2," in out and "images_per_s=" in out
