"""The port's sdk executor (repro_torch.kernels.sdk_conv) against the
JAX package's Pallas kernels run in interpret mode, both block modes,
on the cases of tests/test_sdk_conv.py: every algorithm, marginal
windows, strided, grouped, multi-tile, pruned, conv1d, the
double-buffer hazard case and the auto block rule.  On the CPU the port
runs the kernels' plain version; the kernels themselves are held to it
on the card by chip_smoke.py and tests/test_torch_cuda.py."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import (RTOL_LAYER, assert_close, layer_data,  # noqa: E402
                           map_layer_both, t)
from repro.cnn import reference_conv2d as j_ref                 # noqa: E402
from repro.kernels import im2win_conv as jk                     # noqa: E402
from repro_torch.kernels import sdk_conv as tk                  # noqa: E402


def _spec(*args, **kw):
    return lambda core: core.ConvLayerSpec("t", *args, **kw)


CASES = {
    **{f"alg-{a}": (_spec(18, 18, 3, 3, 24, 32), (512, 512), a)
       for a in ("img2col", "SDK", "VW-SDK", "Tetris-SDK", "TetrisG-SDK")},
    "marginal": (_spec(18, 18, 3, 3, 32, 32), (512, 512), "Tetris-SDK"),
    "strided": (_spec(10, 10, 3, 3, 8, 8, stride=2), (128, 128),
                "Tetris-SDK"),
    "multi_tile": (_spec(7, 7, 3, 3, 64, 64), (512, 512), "Tetris-SDK"),
    "conv1d": (lambda core: core.conv1d("t", 32, 4, 8, 8), (128, 128),
               "Tetris-SDK"),
    "double_buffer": (_spec(11, 11, 3, 3, 16, 16, stride=2), (128, 128),
                      "Tetris-SDK"),
}


#: the window kernel on the cases that stress it: grouped (TetrisG),
#: marginal windows, stride, several tiles and the double-buffer case
WINDOW_CASES = ("alg-TetrisG-SDK", "marginal", "strided", "multi_tile",
                "double_buffer")


@pytest.mark.parametrize("case,block", [(c, "whole") for c in sorted(CASES)]
                         + [(c, "window") for c in WINDOW_CASES])
def test_sdk_conv_matches_jax(case, block):
    make, arr, alg = CASES[case]
    jm, tm = map_layer_both(make, arr, alg)
    x, k = layer_data(tm, np.random.RandomState(3))
    want = np.asarray(jk.sdk_conv(jm, x, k, interpret=True, block=block))
    assert_close(tk.sdk_conv(tm, t(x), t(k), block=block), want, RTOL_LAYER)
    assert_close(tk.sdk_conv_plain(tm, t(x), t(k)), want, RTOL_LAYER)
    oracle = np.asarray(j_ref(jm.layer, x, k, groups=jm.group))
    assert_close(tk.sdk_conv(tm, t(x), t(k), block=block), oracle,
                 RTOL_LAYER)
    assert tk.sdk_conv_cycles(tm) == jk.sdk_conv_cycles(jm)


def test_double_buffer_case_shape():
    """The double-buffer case exercises every window-kernel hazard at
    once: several channel passes, marginal windows, pruned channels."""
    _, tm = map_layer_both(CASES["double_buffer"][0], (128, 128),
                           "Tetris-SDK")
    assert any(tl.marginals for tl in tm.tiles)
    assert any(tl.pruned_channels for tl in tm.tiles)
    assert any(tl.ar_c > 1 for tl in tm.tiles)


@pytest.mark.parametrize("budget", [None, 64 * 1024])
def test_auto_block_rule_matches_jax(budget, monkeypatch):
    """block="auto" resolves per tile exactly as the JAX package does:
    window above the budget (a big Inception-style layer under 64 KiB),
    whole under the 8 MiB default; REPRO_SDK_VMEM_BUDGET is read per
    call."""
    monkeypatch.delenv("REPRO_SDK_VMEM_BUDGET", raising=False)
    make = _spec(30, 30, 5, 5, 16, 32)
    jm, tm = map_layer_both(make, (64, 64), "VW-SDK")
    x, k = layer_data(tm, np.random.RandomState(4), batch=1)
    modes = {c.mode for c in tk.tile_calls(tm, t(x), t(k), "auto", budget)}
    jb = jk.default_vmem_budget() if budget is None else budget
    want = {"window" if jk._vmem_bytes_whole(
        1, *tm.tile_passes(tl)[0::2], jm.layer) > jb else "whole"
        for tl in jm.tiles}
    assert modes == want == ({"window"} if budget else {"whole"})
    y = tk.sdk_conv(tm, t(x), t(k), block="auto", vmem_budget=budget)
    assert_close(y, np.asarray(j_ref(jm.layer, x, k)), RTOL_LAYER)
    monkeypatch.setenv("REPRO_SDK_VMEM_BUDGET", "1024")
    assert tk.default_vmem_budget() == jk.default_vmem_budget() == 1024
    assert {c.mode for c in tk.tile_calls(tm, t(x), t(k))} == {"window"}


def test_launch_dims_fit_shared_memory():
    """The window kernel's two patch slots fit a block's shared memory
    even where the whole batch does not (a DenseNet40 block-3 layer at
    batch 256), and every launch covers every window and image."""
    from repro_torch.core import ArrayConfig, networks
    from repro_torch.core import map_net
    net = map_net("densenet40", networks.densenet40(), ArrayConfig(512, 512),
                  "TetrisG-SDK", groups=(1, 2, 4))
    m = next(m for m in net.layers if m.layer.name == "DN40-b3l12")
    for b in (1, 8, 256):
        for tile in m.tiles:
            g = tk.tile_geom(m, tile)
            b_chunk, run, smem, blocks = tk.window_launch_dims(b, g)
            assert smem == 2 * 4 * b_chunk * g.patch_floats <= tk.SMEM_LIMIT
            assert 1 <= b_chunk <= b and 1 <= run <= g.nw
            assert blocks == (g.ar_c * g.ac_c * -(-g.nw // run)
                              * -(-b // b_chunk))
            if b == 256:
                assert b_chunk < b      # the whole batch does not fit
            wb, wblocks = tk.whole_launch_dims(b, g)
            assert wblocks == g.steps * -(-b // wb)

