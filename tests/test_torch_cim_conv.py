"""The port's reference executor (repro_torch.cnn.cim_conv) against the
JAX package's on the same mappings and inputs: the cases of
tests/test_cim_conv.py — every algorithm, pruned, multi-tile, strided
(border coverage included), depthwise, conv1d, 5x5 and a synthetic
multi-tile layer whose pruned tile is not the last."""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import (RTOL_LAYER, assert_close, layer_data,  # noqa: E402
                           map_layer_both, t)
from repro.cnn import cim_conv2d as j_cim                       # noqa: E402
from repro.cnn import reference_conv2d as j_ref                 # noqa: E402
from repro_torch.cnn import cim_conv2d as t_cim                 # noqa: E402
from repro_torch.cnn import reference_conv2d as t_ref           # noqa: E402


def _spec(*args, **kw):
    return lambda core: core.ConvLayerSpec("t", *args, **kw)


CASES = {
    **{f"alg-{a}": (_spec(18, 18, 3, 3, 24, 32), (512, 512), a)
       for a in ("img2col", "SDK", "VW-SDK", "Tetris-SDK", "TetrisG-SDK")},
    "pruned": (_spec(18, 18, 3, 3, 32, 32), (512, 512), "Tetris-SDK"),
    "multi_tile": (_spec(7, 7, 3, 3, 64, 64), (512, 512), "Tetris-SDK"),
    **{f"stride2-{a}": (_spec(10, 10, 3, 3, 8, 8, stride=2), (128, 128), a)
       for a in ("img2col", "VW-SDK", "Tetris-SDK")},
    "stride2-96": (_spec(13, 13, 3, 3, 4, 4, stride=2), (96, 96),
                   "Tetris-SDK"),
    "border-11-3-2": (_spec(11, 11, 3, 3, 8, 8, stride=2), (128, 128),
                      "Tetris-SDK"),
    "border-14-5-2": (_spec(14, 14, 5, 5, 8, 8, stride=2), (128, 128),
                      "VW-SDK"),
    "depthwise": (_spec(10, 10, 3, 3, 16, 16, groups=16), (128, 128),
                  "Tetris-SDK"),
    "conv1d": (lambda core: core.conv1d("t", 32, 4, 8, 8), (128, 128),
               "Tetris-SDK"),
    "5x5": (_spec(12, 12, 5, 5, 16, 32), (256, 256), "Tetris-SDK"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cim_conv2d_matches_jax(case):
    make, arr, alg = CASES[case]
    jm, tm = map_layer_both(make, arr, alg)
    x, k = layer_data(tm, np.random.RandomState(0))
    want = np.asarray(j_cim(jm, x, k))
    assert_close(t_cim(tm, t(x), t(k)), want, RTOL_LAYER)
    oracle = np.asarray(j_ref(jm.layer, x, k, groups=jm.group))
    assert_close(t_ref(tm.layer, t(x), t(k), groups=tm.group), oracle,
                 RTOL_LAYER)
    assert_close(t_cim(tm, t(x), t(k)), oracle, RTOL_LAYER)


def test_multi_tile_pruned_channels_zero_per_tile():
    """A pruned tile that is not the last: every executor of the port
    skips that tile's trailing channels in place, as the JAX package's
    do, and zero_pruned_kernels zeroes exactly those slices."""
    import torch
    from repro import core as jcore
    from repro.cnn.mapped_net import zero_pruned_kernels as j_zero
    from repro_torch import core as tcore
    from repro_torch.cnn import mapped_conv2d, zero_pruned_kernels
    from repro_torch.kernels.sdk_conv import sdk_conv

    def synthetic(core):
        layer = core.ConvLayerSpec("mt", 18, 18, 3, 3, 12, 8)
        tiles = tuple(core.TileMapping(
            window=core.Window(6, 6), depth=d, ic_t=d, oc_t=8, ar_c=1,
            ac_c=1, n_regular=16, pruned_channels=p)
            for d, p in ((5, 1), (6, 0)))
        m = core.LayerMapping(layer=layer, array=core.ArrayConfig(512, 512),
                              algorithm="synthetic", tiles=tiles)
        return m, core.NetworkMapping(name="mt", algorithm="synthetic",
                                      array=m.array, layers=(m,))

    (jm, jnet), (tm, tnet) = synthetic(jcore), synthetic(tcore)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 18, 18).astype(np.float32)
    k = rng.randn(3, 3, 12, 8).astype(np.float32)
    (kz,) = zero_pruned_kernels(tnet, [t(k)])
    np.testing.assert_array_equal(
        kz.numpy(), np.asarray(j_zero(jnet, [jnp.asarray(k)])[0]))
    assert float(kz[:, :, 5].abs().sum()) == 0.0
    assert float(kz[:, :, 11].abs().sum()) > 0.0
    oracle = np.asarray(j_ref(jm.layer, x, np.asarray(kz)))
    for y in (t_cim(tm, t(x), t(k)), mapped_conv2d(tm, t(x), t(k)),
              sdk_conv(tm, t(x), t(k))):
        assert isinstance(y, torch.Tensor)
        assert_close(y, oracle, RTOL_LAYER)
