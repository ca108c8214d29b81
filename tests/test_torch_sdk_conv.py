"""The port's sdk executor (repro_torch.kernels.sdk_conv) against the
JAX package's Pallas kernels run in interpret mode, both block modes,
on the cases of tests/test_sdk_conv.py: every algorithm, marginal
windows, strided, grouped, multi-tile, pruned, conv1d, the
double-buffer hazard case and the auto block rule.  On the CPU the port
runs the kernels' plain version; the kernels themselves are held to it
on the card by chip_smoke.py and tests/test_torch_cuda.py."""
import dataclasses

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


def _window_cover(b, g, d):
    """How often each (ci, oi, wi, image, channel) of a tile is computed
    by the window kernel's grid under launch dims ``d``."""
    parts = -(-g.oc_t // d.oc_b)
    seen = {}
    for bx in range(g.ar_c * g.ac_c * parts):
        ci, oi = divmod(bx // parts, g.ac_c)
        o_lo = (bx % parts) * d.oc_b
        for by in range(-(-g.nw // d.run)):
            for bz in range(-(-b // d.b_chunk)):
                for wi in range(by * d.run, min(g.nw, (by + 1) * d.run)):
                    for img in range(bz * d.b_chunk,
                                     min(b, (bz + 1) * d.b_chunk)):
                        for o in range(o_lo, min(g.oc_t, o_lo + d.oc_b)):
                            key = (ci, oi, wi, img, o)
                            seen[key] = seen.get(key, 0) + 1
    return seen


def _assert_window_launch(b, g):
    d = tk.window_launch_dims(b, g)
    assert d.smem <= tk.SMEM_LIMIT
    assert 1 <= d.b_chunk <= b and 1 <= d.run <= g.nw
    assert d.oc_b % 4 == 0 and 4 <= d.oc_b <= -(-g.oc_t // 4) * 4
    seen = _window_cover(b, g, d)
    assert len(seen) == g.steps * b * g.oc_t
    assert set(seen.values()) == {1}
    assert d.blocks == (g.ar_c * g.ac_c * -(-g.oc_t // d.oc_b)
                        * -(-g.nw // d.run) * -(-b // d.b_chunk))
    return d


def _assert_whole_launch(b, g):
    """The whole kernel's grid under whole_launch_dims, decoded as
    csrc/sdk_conv.cu decodes it (x the flat step (ci, oi, wi), y the
    column part, z the image chunk), computes every (step, image, output
    column) exactly once within 227 KB, in steps x parts x chunks
    blocks."""
    d = tk.whole_launch_dims(b, g)
    assert d.run == 1 and d.smem <= tk.SMEM_LIMIT
    assert 1 <= d.b_chunk <= b
    assert d.oc_b % 4 == 0 and 4 <= d.oc_b <= -(-g.oc_t // 4) * 4
    parts, chunks = -(-g.oc_t // d.oc_b), -(-b // d.b_chunk)
    assert d.blocks == g.steps * parts * chunks
    seen = np.zeros((g.ar_c, g.ac_c, g.nw, b, g.oc_t), dtype=int)
    for step in range(g.steps):
        pass_, wi = divmod(step, g.nw)
        ci, oi = divmod(pass_, g.ac_c)
        for part in range(parts):
            for chunk in range(chunks):
                seen[ci, oi, wi, chunk * d.b_chunk:(chunk + 1) * d.b_chunk,
                     part * d.oc_b:(part + 1) * d.oc_b] += 1
    assert (seen == 1).all()
    return d


def test_launch_dims_fit_shared_memory():
    """The window kernel's kernel block and patch slots fit a block's
    shared memory even where the whole batch does not (a DenseNet40
    block-3 layer at batch 256), and every launch computes every
    (ci, oi, wi, image, channel) of the tile exactly once."""
    from repro_torch.core import ArrayConfig, networks
    from repro_torch.core import map_net
    net = map_net("densenet40", networks.densenet40(), ArrayConfig(512, 512),
                  "TetrisG-SDK", groups=(1, 2, 4))
    m = next(m for m in net.layers if m.layer.name == "DN40-b3l12")
    for b in (1, 8, 256):
        for tile in m.tiles:
            g = tk.tile_geom(m, tile)
            d = _assert_window_launch(b, g)
            if b == 256:
                assert d.b_chunk < b      # the whole batch does not fit
            _assert_whole_launch(b, g)


def _served(net_name):
    from repro_torch.core import ArrayConfig
    from repro_torch.launch import serve_cnn
    net, _ = serve_cnn.map_for_serving(net_name, ArrayConfig(512, 512),
                                       "TetrisG-SDK")
    return net


@pytest.mark.parametrize("net_name", ["cnn8", "densenet40", "inception"])
def test_window_launch_fills_the_card_on_served_tiles(net_name):
    """On every tile of the served mappings at batch 8 the window kernel's
    launch covers the tile once and fits; where the tile has at least 66
    (window, image) pairs the launch has at least 66 blocks (half the
    card), and a block walks a run of windows only past two waves."""
    for m in _served(net_name).layers:
        for tile in m.tiles:
            g = tk.tile_geom(m, tile)
            d = _assert_window_launch(8, g)
            pairs = g.steps * 8
            assert d.blocks >= min(pairs, 66)
            if d.run > 1:
                assert pairs * -(-g.oc_t // d.oc_b) > 264


@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("net_name", ["cnn8", "densenet40", "inception"])
def test_whole_launch_covers_and_fits_served_tiles(net_name, batch):
    """On every tile of the served mappings the whole kernel's launch
    covers the tile once within 227 KB; on cnn8's five sdk layers at
    batch 8 (the served path) every launch has at least 64 blocks."""
    from repro_torch.exec.plan import _auto_executor
    for m in _served(net_name).layers:
        for tile in m.tiles:
            d = _assert_whole_launch(batch, tk.tile_geom(m, tile))
            if (net_name, batch) == ("cnn8", 8) and \
                    _auto_executor(m, backend="cuda") == "sdk":
                assert d.blocks >= 64, m.layer.name


def test_whole_launch_dims_at_cnn8_batch_8():
    """The served cnn8's five sdk layers at batch 8: the whole kernel's
    column parts and blocks, one image a block (no layer reaches two
    waves); the window kernel's layout on the same tiles is the same
    (its runs start past two waves)."""
    from repro_torch.exec.plan import _auto_executor
    got = {}
    for m in _served("cnn8").layers:
        if _auto_executor(m, backend="cuda") != "sdk":
            continue
        for tile in m.tiles:
            g = tk.tile_geom(m, tile)
            d = tk.whole_launch_dims(8, g)
            assert d.b_chunk == 1
            assert d == tk.window_launch_dims(8, g)
            got[m.layer.name] = got.get(m.layer.name, 0) + d.blocks
    assert sorted(got) == ["CNN8-3", "CNN8-4", "CNN8-5", "CNN8-6", "CNN8-7"]
    assert all(n >= 64 for n in got.values()), got


@pytest.mark.parametrize("net_name", ["cnn8", "densenet40", "inception"])
def test_covers_output_on_served_mappings(net_name):
    """Every tile of the served TetrisG-SDK mappings (and the strided
    VW-SDK case of the chip smoke) writes every output position, so the
    kernels allocate their output without a zero fill."""
    from repro_torch.core import ArrayConfig, ConvLayerSpec, map_layer
    maps = list(_served(net_name).layers)
    if net_name == "cnn8":
        maps.append(map_layer(ConvLayerSpec("s2", 11, 11, 3, 3, 16, 16,
                                            stride=2),
                              ArrayConfig(512, 512), "VW-SDK"))
    for m in maps:
        for tile in m.tiles:
            assert tk.tile_geom(m, tile).covers_output, m.layer.name


def test_covers_output_detects_a_gap():
    """A raster whose step exceeds its output tile leaves a row of
    outputs unwritten: covers_output is false there (and the kernels
    zero-fill), true for the same raster stepped by its tile."""
    gap = tk.TileGeom(s=1, k_h=3, k_w=3, pw_h=5, pw_w=9, py=3, px=7,
                      step_y=4, step_x=7, ny=2, nx=1, lim_y=2, lim_x=0,
                      ic_t=4, ar_c=1, oc_t=4, ac_c=1, o_h=7, o_w=7)
    assert not gap.covers_output            # output row 3 is never written
    tight = dataclasses.replace(gap, step_y=3, ny=3, lim_y=4)
    assert tight.covers_output
    outside = dataclasses.replace(gap, step_y=3, ny=3, lim_y=6)
    assert not outside.covers_output         # writes rows 6..8 of 7


@pytest.mark.parametrize("batch", [8, 16, 32, 64, 128, 256])
def test_auto_block_reaches_window_only_at_large_batch(batch):
    """Under the 8 MiB default budget, of the layers the auto policy gives
    to ``sdk`` in the served cnn8, densenet40 and inception mappings, only
    Incep-3b resolves to the window kernel, and only from batch 128 (its
    whole-array working set is 10.3 MB there); up to batch 64 only a
    forced ``block="window"`` reaches that kernel."""
    from repro_torch.exec.plan import _auto_executor
    window = set()
    for net_name in ("cnn8", "densenet40", "inception"):
        for m in _served(net_name).layers:
            if _auto_executor(m, backend="cuda") != "sdk":
                continue
            for tile in m.tiles:
                g = tk.tile_geom(m, tile)
                if tk.resolve_block("auto", batch, g, m.layer,
                                    tk.DEFAULT_VMEM_BUDGET) == "window":
                    window.add(m.layer.name)
    assert window == (set() if batch <= 64 else {"Incep-3b"})
