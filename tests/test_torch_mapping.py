"""The port's copy of the mapping search (repro_torch.core) against the
JAX package's: identical mappings field by field, the same executor
choice on the card as on the TPU, the same sdk step counts, and disk
cache keys that cannot collide between the two packages."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import core as jcore                                  # noqa: E402
from repro.core import memo as jmemo                             # noqa: E402
from repro.exec.plan import _auto_executor as j_auto             # noqa: E402
from repro.kernels.im2win_conv import sdk_conv_cycles as j_cycles  # noqa: E402
from repro_torch import core as tcore                            # noqa: E402
from repro_torch.core import memo as tmemo                       # noqa: E402
from repro_torch.exec.plan import _auto_executor as t_auto       # noqa: E402
from repro_torch.kernels.sdk_conv import sdk_conv_cycles as t_cycles  # noqa: E402

NETS = ("cnn8", "inception", "densenet40")
#: (array rows, cols, algorithm, macro grid, groups kwargs)
CONFIGS = {
    "tetrisg512": (512, 512, "TetrisG-SDK", (1, 1), {"groups": (1, 2, 4)}),
    "vwsdk256_2x2": (256, 256, "VW-SDK", (2, 2), {}),
}


def _both(net, config):
    ar, ac, alg, (r, c), kw = CONFIGS[config]
    out = []
    for core in (jcore, tcore):
        layers = core.networks.NETWORKS[net]()
        out.append(core.map_net(net, layers, core.ArrayConfig(ar, ac), alg,
                                core.MacroGrid(r, c), **kw))
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("net", NETS)
def test_map_net_identical(net, config):
    jm, tm = _both(net, config)
    assert dataclasses.astuple(tm) == dataclasses.astuple(jm)
    assert tm.total_cycles == jm.total_cycles


@pytest.mark.parametrize("net", NETS)
def test_auto_executor_and_sdk_cycles_match(net):
    """The port's "cuda" branch picks what the JAX package's "tpu" branch
    picks, layer by layer, and both count the same sdk steps."""
    jm, tm = _both(net, "tetrisg512")
    for jl, tl in zip(jm.layers, tm.layers):
        assert t_auto(tl, backend="cuda") == j_auto(jl, backend="tpu")
        assert t_auto(tl, backend="cpu") == j_auto(jl, backend="cpu")
        assert t_cycles(tl) == j_cycles(jl)


def test_memo_disk_keys_differ(tmp_path, monkeypatch):
    """Equal keys (the reprs of the two packages' frozen dataclasses are
    identical) must land in different disk-cache files."""
    jm, tm = _both("cnn8", "tetrisg512")
    jkey, tkey = ("t", jm.layers[0].layer), ("t", tm.layers[0].layer)
    assert repr(jkey) == repr(tkey)
    monkeypatch.setattr(jmemo, "_disk_dir", tmp_path)
    monkeypatch.setattr(tmemo, "_disk_dir", tmp_path)
    assert jmemo._disk_path(jkey) != tmemo._disk_path(tkey)
    assert tmemo._disk_path(tkey) == tmemo._disk_path(tkey)
