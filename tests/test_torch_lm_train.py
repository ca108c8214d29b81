"""The port's LM train step against the JAX package's, on the CPU at the
smoke configs of test_models.py::test_smoke_train_step (stablelm-1.6b,
mixtral-8x7b, mamba2-130m, recurrentgemma-9b) plus internvl2-26b (its
vision prefix, cut off the loss) and whisper-base (its encoder), with
``microbatches=2`` and both packages' compute type switched to f32: the
same weights and batch through ``make_train_step`` and ``loss_fn``'s
gradients; then the port alone: remat on vs off bitwise, and the loss
falling over 40 steps (test_system.py::test_tiny_lm_loss_decreases).

Adam's first step is sign-sensitive: ``mh / (sqrt(vh) + eps)`` is
``g / (|g| + eps)``, about +-1 wherever |g| is well above eps, so an
element whose gradient is near 0 may move by up to ``2 * lr`` between
two packages whose gradients agree to 1e-6.  So the gradients are held
leaf by leaf, and the new parameters only within that bound."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

import repro.models.common as j_common                          # noqa: E402
import repro_torch.models.common as t_common                    # noqa: E402
from _torch_lm import f32, rel, setup                           # noqa: E402
from _torch_parity import assert_close                          # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401 (autouse)
from repro.launch import steps as j_steps                       # noqa: E402
from repro.models import transformer as JT                      # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.data import ShardedDataPipeline, TokenStream   # noqa: E402
from repro_torch.launch import steps                            # noqa: E402
from repro_torch.models import transformer as T                 # noqa: E402
from repro_torch.optim import tree_leaves                       # noqa: E402
from test_torch_zoo import routed_apart, routes                 # noqa: E402

ARCHS = ("stablelm_1_6b", "mixtral_8x7b", "mamba2_130m",
         "recurrentgemma_9b", "internvl2_26b", "whisper_base")
#: f32, the same function summed in another order.  The loss and the
#: gradient norm relative (measured up to 2.7e-6, mamba2's norm); the
#: gradients per leaf relative to its max|g| (measured up to 1.5e-5,
#: mamba2's SSD chain); the Adam moments derived from them (v holds g^2:
#: twice g's relative error).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
V_RTOL = 2 * GRAD_RTOL
#: the new parameters: a sign flip of one element's step moves it by at
#: most 2 * lr (module docstring), plus an f32 rounding of max|p|
PARAM_LR_BOUND = 2.0
PARAM_RTOL = 1e-6


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(j_common, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_common, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return setup(request.param)


def test_train_step_matches_jax(model, f32_compute):
    """Loss (the mean of the two microbatches'), gradient norm and
    learning rate; the new Adam moments and step; the new parameters
    within the sign-flip bound."""
    nj, mj = model.jax_step()
    nt, mt = model.port_step()
    assert rel(mt["loss"], mj["loss"]) <= LOSS_RTOL
    assert rel(mt["grad_norm"], mj["grad_norm"]) <= LOSS_RTOL
    assert f32(mt["lr"]) == f32(mj["lr"])
    assert int(nt["opt"]["step"]) == int(nj["opt"]["step"]) == 1
    for name, tol in (("m", GRAD_RTOL), ("v", V_RTOL)):
        for a, b in zip(jax.tree.leaves(nj["opt"][name]),
                        tree_leaves(nt["opt"][name])):
            assert_close(b, f32(a), tol)
    lr = float(mt["lr"])
    for a, b in zip(jax.tree.leaves(nj["params"]),
                    tree_leaves(nt["params"])):
        want = f32(a)
        err = np.abs(f32(b) - want).max()
        assert err <= PARAM_LR_BOUND * lr + PARAM_RTOL * np.abs(want).max()


def test_gradients_match_jax(model, f32_compute):
    """``loss_fn``'s value and gradients on the first microbatch, leaf by
    leaf against ``jax.grad``; a MoE model's tokens must route alike in
    both packages' forwards (f32: no token apart)."""
    rows = slice(0, 2)
    cfg_j = model.cfg_j
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, b: j_steps.loss_fn(p, cfg_j, b)))(
        model.state_j()["params"], model.batch_j(rows))
    lt, gt = steps.loss_and_grads(model.state_t()["params"], model.cfg,
                                  model.batch_t(rows))
    assert rel(lt, lj) <= LOSS_RTOL
    leaves_j = jax.tree.leaves(gj)
    assert len(leaves_j) == len(tree_leaves(gt))
    for a, b in zip(leaves_j, tree_leaves(gt)):
        assert b.dtype == torch.float32
        assert_close(b, f32(a), GRAD_RTOL)
    if model.cfg.moe is not None:
        kw = {k: v for k, v in model.batch_j(rows).items() if k != "tokens"}
        with routes() as log:
            JT.forward(model.state_j()["params"], cfg_j, mode="train",
                       tokens=model.batch_j(rows)["tokens"][:, :-1], **kw)
            T.forward(model.state_t()["params"], model.cfg, mode="train",
                      tokens=model.batch_t(rows)["tokens"][:, :-1])
        assert log["port"]
        routed_apart(log, model.cfg, "f32", model.batch["tokens"].shape[1] - 1)


def test_remat_on_off_bitwise(model):
    """Per-unit recomputation changes no bit of the loss or the gradients
    on the CPU (bf16 compute, as trained)."""
    params = model.state_t()["params"]
    batch = model.batch_t()
    l_on, g_on = steps.loss_and_grads(params, model.cfg, batch, remat=True)
    l_off, g_off = steps.loss_and_grads(params, model.cfg, batch,
                                        remat=False)
    assert torch.equal(l_on, l_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)


def test_remat_recomputes_each_unit(monkeypatch):
    """With remat every decoder unit's forward runs twice (its backward
    recomputes it), without it once; the encoder's once either way."""
    cfg = get_config("whisper_base", smoke=True)
    calls = []
    apply_block = T.apply_block

    def counting(x, p, spec, cfg_, **kw):
        calls.append((kw["mode"], spec.cross))
        return apply_block(x, p, spec, cfg_, **kw)
    monkeypatch.setattr(T, "apply_block", counting)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 9), generator=g),
             "enc_embeds": torch.randn((2, 8, cfg.d_model), generator=g)}
    n_dec, n_enc = cfg.stages[0].n_units, cfg.n_enc_layers
    for remat, per_unit in ((True, 2), (False, 1)):
        calls.clear()
        steps.loss_and_grads(params, cfg, batch, remat=remat)
        assert calls.count(("train", True)) == per_unit * n_dec
        assert calls.count(("encode", False)) == n_enc


def test_tiny_lm_loss_decreases():
    """The port's counterpart of test_system.py's: stablelm-1.6b smoke on
    the token stream, 40 steps at lr 3e-3 (bf16 compute): the mean of the
    last 5 losses at least 0.2 below the first 5's."""
    cfg = get_config("stablelm_1_6b", smoke=True)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    step = steps.make_train_step(cfg, steps.TrainConfig(
        microbatches=1, peak_lr=3e-3, warmup_steps=5, total_steps=80))
    pipe = ShardedDataPipeline(TokenStream(vocab=cfg.vocab, seq_len=32,
                                           global_batch=8, seed=0))
    losses = []
    for _ in range(40):
        state, m = step(state, {"tokens": torch.as_tensor(pipe.next())})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses[::6]


def test_batch_must_split_into_microbatches():
    cfg = get_config("stablelm_1_6b", smoke=True)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    step = steps.make_train_step(cfg, steps.TrainConfig(microbatches=2))
    with pytest.raises(ValueError, match="2 microbatches"):
        step(state, {"tokens": torch.zeros((3, 9), dtype=torch.int32)})
