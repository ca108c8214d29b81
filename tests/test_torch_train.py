"""The port's trainers (repro_torch.cnn.train, optim, launch.train)
against the JAX package's, the cases of tests/test_train_plan.py: the
optimizer, pad-and-mask and accumulation, the guards, the
REPRO_TRAIN_MEM_BUDGET refusal, and per-step losses of `train_plan`
(cnn8 and the 14-layer densenet40 prefix; remat off, a cut list and
"auto"; accum 1 and 2) and `train_cnn` (G 2; the F.conv2d, cim and
mapped executors) on the JAX package's own initial parameters and data.

The JAX package draws them from ``jax.random``, which torch cannot
replay, so these tests split its keys exactly as ``repro.cnn.train``
does and hand the port the same numpy values in place of its
``_draws``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import map_net_both, t                       # noqa: E402
from repro.cnn import train as jtrain                           # noqa: E402
from repro.cnn.models import cnn8_config as j_cnn8_config       # noqa: E402
from repro.cnn.models import ensure_head as j_ensure_head       # noqa: E402
from repro.cnn.models import init_cnn as j_init_cnn             # noqa: E402
from repro.data.synthetic import image_task as j_image_task     # noqa: E402
from repro.exec import compile_plan as j_compile                # noqa: E402
from repro.optim import adamw as jadamw                         # noqa: E402
from repro_torch.cnn import params_from_numpy                   # noqa: E402
from repro_torch.cnn import train as ttrain                     # noqa: E402
from repro_torch.cnn.models import cnn8_config                  # noqa: E402
from repro_torch.optim import adamw as tadamw                   # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while this module runs: the suite
    runs several worker processes on a few cores, and each one's default
    of a thread per core oversubscribes them (one small test of this
    kind slowed from 3 s to almost 300 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.RandomState(3)

#: per-step losses, port vs JAX package, relative.  The first step's
#: loss is one f32 forward in another summation order; Adam turns
#: rounding-level differences of near-zero gradients into updates of up
#: to ``lr`` each, so later losses drift further.  Measured <= 2.4e-7
#: over these 2-3 step runs (lr 3e-3); the gate leaves 40x for other
#: CPUs' summation orders
RTOL_LOSS = 1e-5
#: one AdamW step on the same numpy, XLA vs torch: a few ulp
RTOL_ADAM = 1e-6


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ optimizer

def test_adamw_step_bitwise_matches_handrolled_adam():
    """With ADAM (decay and clipping off) `adamw_update` reproduces a
    hand-rolled Adam BIT FOR BIT over 50 steps."""
    lr = 3e-3
    params = {"w": t(RNG.randn(6, 6).astype(np.float32)),
              "b": [t(RNG.randn(6).astype(np.float32))]}
    p_old = p_new = params
    zeros = tadamw.tree_map(torch.zeros_like, params)
    o_old = {"m": zeros, "v": zeros, "t": torch.zeros((), dtype=torch.int32)}
    o_new = tadamw.adamw_init(params)
    for i in range(50):
        grads = tadamw.tree_map(
            lambda p: t(RNG.randn(*p.shape).astype(np.float32)), params)
        m = tadamw.tree_map(lambda m_, g: 0.9 * m_ + 0.1 * g, o_old["m"],
                            grads)
        v = tadamw.tree_map(lambda v_, g: 0.999 * v_ + 0.001 * g * g,
                            o_old["v"], grads)
        tt = o_old["t"] + 1

        def upd(p, m_, v_):
            mh = m_ / (1 - 0.9 ** tt)
            vh = v_ / (1 - 0.999 ** tt)
            return p - lr * mh / (torch.sqrt(vh) + 1e-8)
        p_old = tadamw.tree_map(upd, p_old, m, v)
        o_old = {"m": m, "v": v, "t": tt}
        p_new, o_new, _ = tadamw.adamw_update(p_new, grads, o_new, lr,
                                              ttrain.ADAM)
        for a, b in zip(tadamw.tree_leaves(p_old),
                        tadamw.tree_leaves(p_new)):
            assert torch.equal(a, b), f"step {i} diverged"


@pytest.mark.parametrize("cfg", ("adam", "adamw"))
def test_adamw_matches_jax(cfg):
    """Ten steps on the same numpy gradients, AdamW with decay and
    clipping (the module default) and with ADAM, against
    repro.optim.adamw: within RTOL_ADAM of max|p|."""
    conf = {"adam": (jtrain.ADAM, ttrain.ADAM),
            "adamw": (jadamw.AdamWConfig(), tadamw.AdamWConfig())}[cfg]
    rng = np.random.RandomState(5)
    p0 = {"w": rng.randn(6, 6).astype(np.float32),
          "b": [rng.randn(6).astype(np.float32)]}
    jp, tp = jax.tree.map(jnp.asarray, p0), tadamw.tree_map(t, p0)
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for _ in range(10):
        g = jax.tree.map(lambda p: (rng.randn(*p.shape) * 3).astype(
            np.float32), p0)
        jp, jo, jn = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                         jo, 1e-2, conf[0])
        tp, to, tn = tadamw.adamw_update(tp, tadamw.tree_map(t, g), to,
                                         1e-2, conf[1])
        assert abs(float(jn) - float(tn)) <= 1e-6 * float(jn)
    for a, b in ((jp["w"], tp["w"]), (jp["b"][0], tp["b"][0])):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= RTOL_ADAM * np.abs(a).max()


def test_cosine_schedule_matches_jax():
    from repro.optim.schedule import cosine_schedule as j_cos
    from repro_torch.optim import cosine_schedule as t_cos
    kw = dict(peak_lr=3e-3, warmup_steps=5, total_steps=40)
    for s in (0, 3, 5, 17, 40, 55):
        assert float(t_cos(s, **kw)) == pytest.approx(float(j_cos(s, **kw)),
                                                      rel=1e-6)


# --------------------------------------------------- accumulation + pad

def _toy_loss_sum(params, x, y, mask):
    per = (x @ params["w"] - y) ** 2
    return (per * mask).sum()


def _toy():
    params = {"w": t(RNG.randn(5).astype(np.float32)).requires_grad_(True)}
    return params


def test_pad_and_mask_grads_exact():
    """Padding a ragged tail to the step's shape does not change the
    gradient: the padded rows contribute exact zeros, whatever they hold
    (bit for bit), and the padded step equals the unpadded mean up to
    f32 summation order (torch reduces 8 rows in another order than 6,
    so unlike XLA's it is not bitwise there; 1e-6)."""
    rng = np.random.RandomState(4)
    params = {"w": t(rng.randn(5).astype(np.float32)).requires_grad_(True)}
    x = t(rng.randn(6, 5).astype(np.float32))
    y = t(rng.randn(6).astype(np.float32))
    sum_loss = ((x @ params["w"] - y) ** 2).sum()
    g_ref = torch.autograd.grad(sum_loss, [params["w"]])[0] / 6.0
    xp, yp, mask = ttrain._pad_and_mask(x, y, 8)
    assert xp.shape[0] == 8 and float(mask.sum()) == 6.0
    assert not xp[6:].any() and not yp[6:].any()
    loss, g = ttrain._accum_grads(_toy_loss_sum, params,
                                  *ttrain._microbatched(xp, yp, mask, 1))
    xg, yg = xp.clone(), yp.clone()
    xg[6:], yg[6:] = t(rng.randn(2, 5).astype(np.float32)), 7.0
    loss_g, g_g = ttrain._accum_grads(_toy_loss_sum, params,
                                      *ttrain._microbatched(xg, yg, mask, 1))
    assert torch.equal(g_g["w"], g["w"]) and torch.equal(loss_g, loss)
    torch.testing.assert_close(g["w"], g_ref, rtol=1e-6, atol=0)
    torch.testing.assert_close(loss, sum_loss.detach() / 6.0, rtol=1e-6,
                               atol=0)


def test_accumulation_matches_whole_batch():
    """K microbatches, summed then divided once == the whole-batch mean
    gradient (up to f32 summation order)."""
    params = _toy()
    x = t(RNG.randn(8, 5).astype(np.float32))
    y = t(RNG.randn(8).astype(np.float32))
    mask = torch.ones(8)
    _, g1 = ttrain._accum_grads(_toy_loss_sum, params,
                                *ttrain._microbatched(x, y, mask, 1))
    for accum in (2, 4):
        _, gk = ttrain._accum_grads(_toy_loss_sum, params,
                                    *ttrain._microbatched(x, y, mask, accum))
        torch.testing.assert_close(gk["w"], g1["w"], rtol=1e-6, atol=0)


def test_trainers_validate_accum_and_remat():
    with pytest.raises(ValueError, match="accum"):
        ttrain.train_cnn(cnn8_config(), steps=1, batch=8, accum=3,
                         device="cpu")
    with pytest.raises(ValueError, match="accum"):
        ttrain.train_plan(_densenet()[1], steps=1, batch=3, accum=2,
                          device="cpu")
    with pytest.raises(ValueError, match="remat"):
        ttrain.train_cnn(cnn8_config(), steps=1, batch=8, remat="auto",
                         executor="reference", n_train=16, n_test=8,
                         device="cpu")
    with pytest.raises(ValueError, match="invalid mesh"):
        ttrain.train_plan(_densenet()[1], steps=1, batch=2, mesh=object(),
                          device="cpu")


# ----------------------------------------------------------- plan scale

def _densenet():
    return map_net_both("densenet40_p",
                        lambda core: core.networks.densenet40()[:14],
                        (64, 64), "TetrisG-SDK", (2, 2), groups=(1, 2))


def _cnn8_net():
    return map_net_both("cnn8", lambda core: core.networks.cnn8(), (64, 64),
                        "TetrisG-SDK", (2, 2))


def _ref_plan_draws(jnet, seed, n_train, num_classes, out_c, net=None):
    """repro.cnn.train.train_plan's draws, as numpy."""
    k_init, k_head, k_data = jax.random.split(jax.random.PRNGKey(seed), 3)
    first = jnet.layers[0].layer
    xs, ys, _, _ = j_image_task(k_data, n_train=n_train, n_test=1,
                                size=max(4, first.i_w - 2),
                                channels=first.ic, num_classes=num_classes)
    params = {"kernels": jtrain.init_plan_kernels(jnet, k_init),
              "head": jax.random.normal(k_head, (out_c, num_classes),
                                        jnp.float32) * (1.0 / out_c) ** 0.5}
    return _tree_np(params), (np.asarray(xs), np.asarray(ys))


def _ref_cnn_draws(cfg, seed, n_train, n_test):
    """repro.cnn.train.train_cnn's draws, as numpy."""
    k_init, k_data = jax.random.split(jax.random.PRNGKey(seed))
    data = j_image_task(k_data, n_train=n_train, n_test=n_test,
                        size=cfg.convs[0].i_w - 2, channels=cfg.convs[0].ic,
                        num_classes=cfg.num_classes)
    params = j_ensure_head(j_init_cnn(k_init, cfg), cfg)
    return _tree_np(params), tuple(np.asarray(a) for a in data)


def _use_draws(monkeypatch, ref_draws):
    """Hand the port's trainer the JAX package's draws:
    ``ref_draws(**kw)`` gives them as numpy (params, data) for the
    keywords the port's ``_draws`` receives."""
    def draws(kind, seed, device, **kw):
        params, data = ref_draws(seed=seed, **kw)
        return (params_from_numpy(params, device),
                tuple(torch.tensor(a, device=device,
                                   dtype=torch.long if a.dtype.kind == "i"
                                   else torch.float32)
                      for a in data))
    monkeypatch.setattr(ttrain, "_draws", draws)


def _assert_losses(got, want):
    assert len(got) == len(want) and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS)


#: port runs (net, remat, accum), each held to the JAX package's run
#: with the same arguments.  Its remat and accum variants agree within
#: 1e-7 relative, so the port's other variants share one reference run
#: (remat off, accum 1): a JAX run costs 4-10 s here, and the first on
#: the densenet prefix ~35 s more to compile its initial draws
PLAN_CASES = {
    "cnn8-off-a1": ("cnn8", None, 1),
    "cnn8-auto-a2": ("cnn8", "auto", 2),
    "densenet-off-a1": ("densenet", None, 1),
    "densenet-off-a2": ("densenet", None, 2),
    "densenet-cut12-a2": ("densenet", (12,), 2),
    "densenet-auto-a1": ("densenet", "auto", 1),
    "densenet-auto-a2": ("densenet", "auto", 2),
}
#: the reference runs made with each case's own arguments
SAME_ARGS = {"cnn8-off-a1", "cnn8-auto-a2", "densenet-off-a1",
             "densenet-cut12-a2"}
PLAN_NETS = {"cnn8": _cnn8_net, "densenet": _densenet}
PLAN_KW = dict(steps=3, batch=2, n_train=6, lr=3e-3)


@functools.lru_cache(maxsize=None)
def _jax_plan_run(net_name, remat, accum):
    """Per-step losses of repro.cnn.train.train_plan."""
    jnet, _ = PLAN_NETS[net_name]()
    losses: list = []
    jtrain.train_plan(jnet, losses=losses, remat=remat, accum=accum,
                      **PLAN_KW)
    return losses


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_train_plan_losses_match_jax(case, monkeypatch):
    """Per-step losses of the port's train_plan on the JAX package's
    draws against repro.cnn.train.train_plan(losses=...): 3 steps at
    batch 2 (n_train 6, so the third step's window wraps); the plan's
    segments and memory estimates equal the JAX package's."""
    net_name, remat, accum = PLAN_CASES[case]
    monkeypatch.delenv("REPRO_TRAIN_MEM_BUDGET", raising=False)
    jnet, tnet = PLAN_NETS[net_name]()
    want = _jax_plan_run(net_name, *((remat, accum) if case in SAME_ARGS
                                        else (None, 1)))
    _use_draws(monkeypatch, lambda **d: _ref_plan_draws(jnet, **d))
    got: list = []
    tr = ttrain.train_plan(tnet, losses=got, device="cpu", remat=remat,
                           accum=accum, **PLAN_KW)
    _assert_losses(got, want)
    jplan = j_compile(jnet, executor_policy="reference", batch=2 // accum,
                      remat=remat)
    assert (tr.segments, tr.peak_mb, tr.unremat_peak_mb) == \
        (len(jplan.spans), jplan.peak_bytes / 1e6,
         jplan.unremat_peak_bytes / 1e6)
    assert tr.first_loss == got[0] and tr.final_loss == got[-1]
    assert tr.donated is False


def test_train_plan_budget_refusal_and_auto_remat(monkeypatch):
    """Under a forced REPRO_TRAIN_MEM_BUDGET between the segmented and
    the flat peak estimates, the flat plan refuses to train before any
    step and remat="auto" segments under the budget and trains."""
    from repro_torch.exec import compile_plan
    _, net = _densenet()
    monkeypatch.delenv("REPRO_TRAIN_MEM_BUDGET", raising=False)
    flat = compile_plan(net, executor_policy="reference", batch=2,
                        device="cpu")
    cut = compile_plan(net, executor_policy="reference", batch=2,
                       remat=(12,), device="cpu")
    assert cut.peak_bytes < flat.peak_bytes
    budget = (cut.peak_bytes + flat.peak_bytes) // 2
    monkeypatch.setenv("REPRO_TRAIN_MEM_BUDGET", str(budget))

    def no_draws(*a, **kw):
        raise AssertionError("drew before refusing")
    with monkeypatch.context() as mp:
        mp.setattr(ttrain, "_draws", no_draws)
        with pytest.raises(MemoryError, match="exceeds"):
            ttrain.train_plan(net, steps=1, batch=2, n_train=16,
                              device="cpu")
    losses: list = []
    r = ttrain.train_plan(net, steps=2, batch=2, remat="auto", n_train=16,
                          losses=losses, device="cpu")
    assert r.segments == 2
    assert r.peak_mb < budget / 1e6 < r.unremat_peak_mb
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert r.first_loss == losses[0] and r.final_loss == losses[-1]


@pytest.mark.parametrize("policy", ("sdk", "matmul-net"))
def test_train_plan_refuses_kernel_layers(policy):
    """Plans whose layers resolved to sdk or matmul (kernels with no
    backward) are refused before the first step, the layers named."""
    from repro_torch.launch.transformer import transformer_mapping
    if policy == "sdk":
        _, net = map_net_both("cnn8", lambda core: core.networks.cnn8(),
                              (512, 512), "TetrisG-SDK", (1, 1),
                              groups=(1, 2, 4))
        execs, match = ("reference",) + ("sdk",) * 5, r"CNN8-3:sdk"
    else:
        net = transformer_mapping("whisper_smoke", blocks=1)
        execs, match = "matmul", r"\.qkv:matmul"
    with pytest.raises(ValueError, match=match):
        ttrain.train_plan(net, steps=1, batch=2, device="cpu",
                          executor_policy=execs)


# ------------------------------------------------------------ train_cnn

@pytest.mark.parametrize("executor", ("reference", "cim", "mapped"))
def test_train_cnn_losses_match_jax(executor, monkeypatch):
    """The Table II trainer at G 2 on the JAX package's draws, 2 steps
    at batch 4 (accum 2): final loss, and train and test accuracy as
    counts, against repro.cnn.train.train_cnn."""
    from repro.core import ArrayConfig as JArray
    from repro_torch.core import ArrayConfig as TArray
    kw = dict(steps=2, batch=4, accum=2, lr=3e-3, n_train=8, n_test=4,
              executor=executor)
    jcfg = j_cnn8_config(in_size=6, in_ch=4, group=2)
    want = jtrain.train_cnn(jcfg, array=JArray(128, 128), **kw)
    _use_draws(monkeypatch, lambda seed, cfg, n_train, n_test:
               _ref_cnn_draws(jcfg, seed, n_train, n_test))
    got = ttrain.train_cnn(cnn8_config(in_size=6, in_ch=4, group=2),
                           array=TArray(128, 128), device="cpu", **kw)
    _assert_losses([got.final_loss], [want.final_loss])
    assert (got.train_acc, got.test_acc) == (want.train_acc, want.test_acc)
    assert (got.config, got.group, got.executor) == \
        (want.config, want.group, want.executor)


def test_apply_cnn_sdk_forward_only():
    """executor="sdk": the forward runs (plain tiles on the CPU) and
    matches F.conv2d's; with parameters that require grad it raises."""
    from repro_torch.cnn.models import apply_cnn, ensure_head, init_cnn
    from repro_torch.core import ArrayConfig
    cfg = cnn8_config(in_size=6, in_ch=4)       # every conv sdk-realizable
    gen = torch.Generator()
    gen.manual_seed(0)
    params = ensure_head(init_cnn(gen, cfg), cfg)
    maps = ttrain.train_mappings(cfg, ArrayConfig(64, 64))
    x = torch.randn(2, 4, 6, 6, generator=gen)
    with torch.no_grad():
        y = apply_cnn(params, cfg, x, mappings=maps, executor="sdk")
        r = apply_cnn(params, cfg, x)
    torch.testing.assert_close(y, r, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="has no backward"):
        apply_cnn(params, cfg, x, mappings=maps, executor="sdk")


# ------------------------------------------------------------------ CLI

def test_launch_train_plan_net_cpu(capsys, tmp_path):
    from repro_torch.launch import train as tlaunch
    r, losses, times = tlaunch.main(
        ["--plan-net", "cnn8", "--remat", "auto", "--steps", "2", "--batch",
         "2", "--accum", "2", "--device", "cpu"])

    assert len(losses) == len(times) == 2 and losses[-1] == r.final_loss
    out = capsys.readouterr().out
    assert "step     1  loss" in out and "step     2  loss" in out
    assert "segment(s), accum=2, donated=False)" in out and "peak~" in out
    assert r.segments > 1 and np.isfinite(r.final_loss)
    # without --plan-net the same CLI trains the language model
    run = tlaunch.main(["--arch", "stablelm_1_6b", "--smoke", "--steps", "1",
                        "--batch", "2", "--seq", "8", "--ckpt-dir",
                        str(tmp_path), "--device", "cpu"])
    assert run.last == 1 and np.isfinite(run.metrics[0]["loss"])
