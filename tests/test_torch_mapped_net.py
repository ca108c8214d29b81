"""The port's macro-parallel executor (repro_torch.cnn.mapped_net)
against the JAX package's, single-device cases of
tests/test_mapped_net.py: every grid shape, every algorithm, strided and
grouped layers, group rounds, and whole networks (cnn8, a DenseNet40
slice across a transition, a strided chain) through mapped_net_apply."""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import (RTOL_LAYER, RTOL_NET, assert_close,  # noqa: E402
                           layer_data, map_layer_both, map_net_both,
                           net_data, t)
from repro.cnn import mapped_net as jmn                         # noqa: E402
from repro_torch.cnn import mapped_net as tmn                   # noqa: E402


def _spec(name, *args, **kw):
    return lambda core: core.ConvLayerSpec(name, *args, **kw)


LAYER_CASES = {
    **{f"grid-{r}x{c}": (_spec("t", 18, 18, 3, 3, 32, 32), (64, 64),
                          "Tetris-SDK", (r, c))
       for r, c in ((1, 1), (2, 2), (4, 2), (1, 16))},
    **{f"alg-{a}": (_spec("t", 18, 18, 3, 3, 24, 32), (64, 64), a, (2, 2))
       for a in ("img2col", "SDK", "VW-SDK", "Tetris-SDK", "TetrisG-SDK")},
    "strided": (_spec("s", 10, 10, 3, 3, 8, 8, stride=2), (128, 128),
                "Tetris-SDK", (2, 2)),
    "grouped": (_spec("g", 18, 18, 3, 3, 32, 32), (64, 64), "TetrisG-SDK",
                (2, 4)),
    "depthwise_rounds": (_spec("dw", 10, 10, 3, 3, 16, 16, groups=16),
                         (128, 128), "Tetris-SDK", (2, 2)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_mapped_conv2d_matches_jax(case):
    make, arr, alg, grid = LAYER_CASES[case]
    jm, tm = map_layer_both(make, arr, alg, grid)
    x, k = layer_data(tm, np.random.RandomState(11))
    want = np.asarray(jmn.mapped_conv2d(jm, x, k))
    assert_close(tmn.mapped_conv2d(tm, t(x), t(k)), want, RTOL_LAYER)
    assert tmn.executed_steps(tm) == jmn.executed_steps(jm) == tm.cycles
    sj, st = jmn.layer_schedule(jm), tmn.layer_schedule(tm)
    assert (st.group_rounds, st.steps) == (sj.group_rounds, sj.steps)
    if case == "depthwise_rounds":
        assert tm.group == 16 and st.group_rounds > 1


def test_prepared_weights_match_in_trace_build():
    """Pre-materialized shifted-weight blocks give the same layer output
    as building them per call, and have the JAX package's shapes."""
    jm, tm = map_layer_both(LAYER_CASES["grouped"][0], (64, 64),
                            "TetrisG-SDK", (2, 4))
    x, k = layer_data(tm, np.random.RandomState(12))
    tw = tmn.prepared_layer_weights(tm, t(k))
    jw = jmn.prepared_layer_weights(jm, jnp.asarray(k))
    assert [[tuple(b.shape) for b in tile] for tile in tw] == \
        [[tuple(b.shape) for b in tile] for tile in jw]
    y = tmn.mapped_conv2d(tm, t(x), None, weights=tw)
    assert_close(y, np.asarray(jmn.mapped_conv2d(jm, x, k)), RTOL_LAYER)


def _densenet_slice(core):
    return core.networks.densenet40()[10:15]  # b1l11, b1l12, t1, b2l1, b2l2


NET_CASES = {
    "cnn8": (lambda core: core.networks.cnn8(), (2, 2), {"groups": (1, 2, 4)},
             "TetrisG-SDK", 2),
    "densenet_slice": (_densenet_slice, (4, 1), {"groups": (1, 2)},
                       "TetrisG-SDK", 1),
    "strided_chain": (lambda core: [
        core.ConvLayerSpec("a", 18, 18, 3, 3, 8, 16),
        core.ConvLayerSpec("b", 16, 16, 3, 3, 16, 16, stride=2),
        core.ConvLayerSpec("c", 9, 9, 3, 3, 16, 32)], (2, 2), {},
        "Tetris-SDK", 2),
}


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_mapped_net_apply_matches_jax(case):
    layers_of, grid, kw, alg, batch = NET_CASES[case]
    jnet, tnet = map_net_both(case, layers_of, (64, 64), alg, grid, **kw)
    ks, x = net_data(tnet, np.random.RandomState(13), batch=batch)
    jks = [jnp.asarray(k) for k in ks]
    want = np.asarray(jmn.mapped_net_apply(jnet, jks, jnp.asarray(x)))
    tks = [t(k) for k in ks]
    assert_close(tmn.mapped_net_apply(tnet, tks, t(x)), want, RTOL_NET)
    oracle = np.asarray(jmn.reference_net_apply(jnet, jks, jnp.asarray(x)))
    assert_close(tmn.reference_net_apply(tnet, tks, t(x)), oracle, RTOL_NET)
    assert sum(s.steps for s in map(tmn.layer_schedule, tnet.layers)) \
        == tnet.total_cycles


def test_steps_equal_cycles_all_bench_networks():
    """Executed schedule == analytical cycles for every bench network,
    and the same schedule as the JAX package's — host-side only."""
    from repro import core as jcore
    from repro_torch import core as tcore
    for name in tcore.networks.NETWORKS:
        jnet, tnet = map_net_both(
            name, lambda core: core.networks.NETWORKS[name](), (64, 64),
            "TetrisG-SDK", (2, 2), groups=(1, 2))
        for jl, tl in zip(jnet.layers, tnet.layers):
            tmn.check_steps(tl)
            assert tmn.executed_steps(tl) == jmn.executed_steps(jl)
    assert jcore.networks.NETWORKS.keys() == tcore.networks.NETWORKS.keys()
