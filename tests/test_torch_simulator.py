"""The port's copy of the CIM simulator (`repro_torch.core.simulator`) and
of the paper's four CNN configs, held to the JAX package's EXACTLY: the
same mappings (field by field, `_torch_parity.map_net_both`) through the
same Python float arithmetic give the same latency, energy, area and
per-layer breakdowns, at the grids and `grid_search` budgets of
tests/test_simulator.py."""
import dataclasses

import pytest

from repro import configs as jconfigs, core as jcore
from repro.core import simulator as jsim
from repro_torch import configs as tconfigs, core as tcore
from repro_torch.core import simulator as tsim

from _torch_parity import map_net_both

NETS = ("cnn8", "inception", "densenet40", "mobilenet")
#: (array, grid) of tests/test_simulator.py's mapped nets: the paper's
#: macro on one macro, and a 64x64 macro on a 2x2 grid
SHAPES = (((512, 512), (1, 1)), ((64, 64), (2, 2)))


def _kw(alg):
    return {"groups": (1, 2)} if alg == "TetrisG-SDK" else {}


def _same(j, t):
    """Every field of two SystemMetrics / LayerMetrics, floats exactly."""
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.edap, j.edp, j.row()) == (t.edap, t.edp, t.row())


@pytest.mark.parametrize("net", NETS)
def test_simulate_equals_jax_for_every_algorithm(net):
    for array, grid in SHAPES:
        for alg in jcore.ALGORITHMS:
            jm, tm = map_net_both(
                net, lambda core: core.networks.NETWORKS[net](), array, alg,
                grid, **_kw(alg))
            j, t = jsim.simulate(jm), tsim.simulate(tm)
            _same(j, t)
            for jl, tl, m in zip(j.layers, t.layers, tm.layers):
                assert dataclasses.asdict(jl) == dataclasses.asdict(
                    tsim.simulate_layer(m, tsim.TechConfig()))
                assert dataclasses.asdict(jl) == dataclasses.asdict(tl)


@pytest.mark.parametrize("p_max", [4, 8])
def test_simulate_grid_search_winners_equal_jax(p_max):
    """The Fig 20 comparison of tests/test_simulator.py: cnn8 on 64x64
    macros, the Alg 2 sweep's best mapping under TetrisG-SDK (groups 1,
    2, 4) and Tetris-SDK, simulated by both packages."""
    for alg, kw in (("TetrisG-SDK", {"groups": (1, 2, 4)}),
                    ("Tetris-SDK", {})):
        best = []
        for core in (jcore, tcore):
            best.append(core.grid_search(
                "cnn8", core.networks.cnn8(), core.ArrayConfig(64, 64),
                p_max=p_max, algorithm=alg, **kw).best)
        assert dataclasses.astuple(best[0]) == dataclasses.astuple(best[1])
        _same(jsim.simulate(best[0]), tsim.simulate(best[1]))


def test_tech_and_area_equal_jax():
    """A non-default TechConfig reaches every term the same way, and the
    area model (macro and chip, idle macros included) is the same."""
    assert dataclasses.asdict(jsim.TechConfig()) == dataclasses.asdict(
        tsim.TechConfig())
    jt = jsim.TechConfig(act_bits=4, adc_share=4, clock_hz=5e8)
    tt = tsim.TechConfig(act_bits=4, adc_share=4, clock_hz=5e8)
    for ar, grid in (((512, 512), (1, 1)), ((512, 512), (4, 2)),
                     ((64, 64), (2, 2))):
        for tech in ((jsim.TechConfig(), tsim.TechConfig()), (jt, tt)):
            assert jsim.macro_area(jcore.ArrayConfig(*ar), tech[0]) == \
                tsim.macro_area(tcore.ArrayConfig(*ar), tech[1])
            assert jsim.chip_area(jcore.ArrayConfig(*ar),
                                  jcore.MacroGrid(*grid), tech[0]) == \
                tsim.chip_area(tcore.ArrayConfig(*ar),
                               tcore.MacroGrid(*grid), tech[1])
    jm, tm = map_net_both("inception",
                          lambda core: core.networks.inception(),
                          (64, 64), "TetrisG-SDK", (2, 2), groups=(1, 2))
    _same(jsim.simulate(jm, jt), tsim.simulate(tm, tt))


@pytest.mark.parametrize("net", NETS)
def test_cnn_configs_equal_jax(net):
    assert net in tconfigs.CNN_IDS
    j, t = jconfigs.get_config(net), tconfigs.get_config(net)
    assert sorted(t) == sorted(j) == ["array", "layers"]
    assert dataclasses.astuple(t["array"]) == dataclasses.astuple(j["array"])
    assert [dataclasses.astuple(x) for x in t["layers"]] == \
        [dataclasses.astuple(x) for x in j["layers"]]


def test_cnn_ids_equal_jax():
    assert tconfigs.CNN_IDS == jconfigs.CNN_IDS
