"""Remat segments and layerwise plans in the port (repro_torch.exec), the
execution cases of tests/test_memory_remat.py: a plan's segments run
under ``torch.utils.checkpoint``, and its forward and gradients are the
port's own without segments bit for bit on the CPU (cnn8, and the
densenet40 prefix cut at its transition), and the JAX package's within
a tolerance (its own remat gradients are not bitwise on the concat
prefix, ROADMAP.md queue 3).  Layerwise plans (``chained=False``): the
flag joins the plan key, `execute_plan` and `execute_oracle` refuse
them, and `apply_layer` / `execute_layerwise` run each layer alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (RTOL_NET, assert_close, map_net_both,  # noqa: E402
                           net_data, t)
from repro.exec import apply_layer as j_apply_layer             # noqa: E402
from repro.exec import compile_plan as j_compile                # noqa: E402
from repro.exec import execute_plan as j_execute                # noqa: E402
from repro_torch.cnn.models import apply_cnn, cnn8_config       # noqa: E402
from repro_torch.cnn.models import ensure_head, init_cnn        # noqa: E402
from repro_torch.cnn.train import train_mappings                # noqa: E402
from repro_torch.exec import (apply_layer, compile_plan,        # noqa: E402
                              execute_layerwise, execute_oracle,
                              execute_plan)


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


def _nets(name):
    layers = {"cnn8": lambda core: core.networks.cnn8(),
              "densenet_prefix": lambda core: core.networks.densenet40()[:14]}
    return map_net_both(name, layers[name], (64, 64), "TetrisG-SDK", (2, 2),
                        groups=(1, 2))


#: (net, executor, remat of the segmented plan)
CASES = {
    "cnn8-reference": ("cnn8", "reference", "auto"),
    "cnn8-mapped": ("cnn8", "mapped", "auto"),
    "densenet-reference": ("densenet_prefix", "reference", (12,)),
    "densenet-mapped": ("densenet_prefix", "mapped", (12,)),
}


def _grads(plan, ks, x):
    ks = [k.clone().requires_grad_(True) for k in ks]
    y = execute_plan(plan, ks, x, activation=torch.relu)
    grads = torch.autograd.grad(y.sum(), ks)
    return y.detach(), grads


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test.  The patch gather's
    backward (``index_put_`` accumulating the windows' overlaps) is
    otherwise summed by several CPU threads in no fixed order, and the
    unsegmented plan's gradients differ between two of its own calls
    (by ~1e-7 of max|g| on the densenet prefix)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_forward_and_grads_bitwise(case, deterministic):
    """The segmented plan is the same arithmetic: forward and kernel
    gradients equal the unsegmented plan's bit for bit."""
    name, executor, remat = CASES[case]
    _, tnet = _nets(name)
    ks, x = net_data(tnet, np.random.RandomState(11))
    ks, x = [t(k) for k in ks], t(x)
    flat = compile_plan(tnet, executor_policy=executor, batch=2,
                        device="cpu")
    seg = compile_plan(tnet, executor_policy=executor, batch=2, remat=remat,
                       device="cpu")
    assert flat.segments is None and len(seg.spans) > 1
    y0, g0 = _grads(flat, ks, x)
    y1, g1 = _grads(seg, ks, x)
    assert torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,remat", (("cnn8", "auto"),
                                        ("densenet_prefix", (12,))))
def test_remat_matches_jax(name, remat):
    """Segmented forward and gradients against jax.grad of the JAX
    package's segmented execute_plan (reference executor), within
    RTOL_NET of max|y| / max|g|."""
    jnet, tnet = _nets(name)
    ks, x = net_data(tnet, np.random.RandomState(11))
    jplan = j_compile(jnet, executor_policy="reference", batch=2,
                      remat=remat)
    jks, jx = [jnp.asarray(k) for k in ks], jnp.asarray(x)

    def loss(ks):
        return j_execute(jplan, ks, jx, activation=jax.nn.relu).sum()
    want_y = np.asarray(j_execute(jplan, jks, jx, activation=jax.nn.relu))
    want_g = [np.asarray(g) for g in jax.grad(loss)(jks)]
    plan = compile_plan(tnet, executor_policy="reference", batch=2,
                        remat=remat, device="cpu")
    assert plan.segments == jplan.segments
    y, grads = _grads(plan, [t(k) for k in ks], t(x))
    assert_close(y, want_y, RTOL_NET)
    for got, want in zip(grads, want_g):
        assert_close(got, want, RTOL_NET)


def test_apply_cnn_remat_bitwise(deterministic):
    """apply_cnn through a layerwise plan: checkpointed segments (any
    conv may end one) give the unsegmented loss and gradients bit for
    bit."""
    from repro_torch.core import ArrayConfig, NetworkMapping
    from repro_torch.optim import tree_leaves
    cfg = cnn8_config(in_size=6, in_ch=4, group=2)
    maps = train_mappings(cfg, ArrayConfig(128, 128))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = ensure_head(init_cnn(gen, cfg), cfg)
    x = torch.randn(2, 4, 6, 6, generator=gen)
    out = []
    for remat in (None, "auto", (1, 3)):
        logits = apply_cnn(params, cfg, x, mappings=maps, executor="mapped",
                           remat=remat)
        out.append((logits.detach(), torch.autograd.grad(
            logits.square().sum(), tree_leaves(params))))
    net = NetworkMapping(cfg.name, maps[0].algorithm, maps[0].array,
                         tuple(maps), maps[0].grid)
    plan = compile_plan(net, executor_policy="mapped", batch=2,
                        chained=False, remat=(1, 3), device="cpu")
    assert plan.spans == ((0, 2), (2, 4), (4, 5))
    for y, g in out[1:]:
        assert torch.equal(y, out[0][0])
        for a, b in zip(g, out[0][1]):
            assert torch.equal(a, b)


# ------------------------------------------------------ layerwise plans

def test_layerwise_plans():
    """chained=False: layerwise glue, its own plan key, any cut allowed,
    refused by execute_plan / execute_oracle with the JAX package's
    messages; apply_layer and execute_layerwise run each layer on its own
    input, as the JAX package's apply_layer does."""
    jnet, tnet = _nets("densenet_prefix")
    chained = compile_plan(tnet, executor_policy="mapped", batch=2,
                           device="cpu")
    lw = compile_plan(tnet, executor_policy="mapped", batch=2,
                      chained=False, device="cpu")
    assert lw is not chained and lw.chained is False and chained.chained
    assert lw is compile_plan(tnet, executor_policy="mapped", batch=2,
                              chained=False, device="cpu")
    assert {lp.glue.kind for lp in lw.layers} == {"layerwise"}
    assert [lp.carry_c for lp in lw.layers] == \
        [m.layer.ic for m in tnet.layers]
    jlw = j_compile(jnet, executor_policy="mapped", batch=2, chained=False)
    cut = compile_plan(tnet, executor_policy="mapped", batch=2,
                       chained=False, remat=(3,), device="cpu")
    assert cut.segments == j_compile(jnet, executor_policy="mapped", batch=2,
                                     chained=False, remat=(3,)).segments
    assert cut.segments == ((0, 4), (4, len(tnet.layers)))
    ks, x = net_data(tnet, np.random.RandomState(2))
    with pytest.raises(ValueError, match="needs a chained plan; this one "
                       "was compiled with chained=False"):
        execute_plan(lw, [t(k) for k in ks], t(x))
    with pytest.raises(ValueError, match="execute_oracle needs a chained"):
        execute_oracle(lw, [t(k) for k in ks], t(x))
    rng = np.random.RandomState(5)
    xs = [rng.randn(2, m.layer.ic, m.layer.i_h, m.layer.i_w).astype(
        np.float32) for m in tnet.layers]
    ys = execute_layerwise(lw, [t(k) for k in ks], [t(a) for a in xs])
    for i in (0, 11, 12, 13):
        want = np.asarray(j_apply_layer(jlw, i, jnp.asarray(xs[i]),
                                        jnp.asarray(ks[i])))

        assert_close(ys[i], want, RTOL_NET)
        assert torch.equal(apply_layer(lw, i, t(xs[i]), t(ks[i])), ys[i])
    with pytest.raises(ValueError, match="inputs for"):
        execute_layerwise(lw, [t(k) for k in ks], [t(xs[0])])
