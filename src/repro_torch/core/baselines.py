"""Baseline mapping algorithms the paper compares against (Fig 4 a-d).

* img2col — unroll one kernel window; no input reuse.
* SDK — one rigid parallel window spanning *all* input channels.
* VW-SDK — channel tiling + exhaustive window search (ceil window count,
  null-padded borders, one window shape for every tile).
* VWC-SDK — VW-SDK + residual-channel pruning under a global budget.

All return :class:`LayerMapping`; network-level helpers live in mapper.py.

Like the Tetris search, the exhaustive window scans are scored in one
numpy pass over the cached window table (cycles.window_table) and the
result is memoized under the effective grid (core/memo.py);
``memo.disabled()`` falls back to the original scalar loops, and both
paths return bit-identical mappings (tests/test_search_cache.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from . import cycles as cyc
from . import memo
from .types import (ArrayConfig, ConvLayerSpec, LayerMapping, MacroGrid,
                    TileMapping, Window)


def _tile(layer: ConvLayerSpec, array: ArrayConfig, window: Window,
          depth: int, *, marginal: bool, ic_t: Optional[int] = None,
          oc: Optional[int] = None, pruned: int = 0) -> Optional[TileMapping]:
    """Build a TileMapping for `depth` channels under `window`."""
    ic_t = cyc.ic_t_for(window, depth, array) if ic_t is None else ic_t
    if ic_t < 1:
        return None
    oc_t = cyc.oc_t_for(window, layer, array, oc)
    if oc_t < 1:
        return None
    n_reg, margs = cyc.n_windows(layer, window, marginal=marginal)
    return TileMapping(
        window=window, depth=depth, ic_t=ic_t, oc_t=oc_t,
        ar_c=math.ceil(depth / ic_t),
        ac_c=math.ceil((layer.oc if oc is None else oc) / oc_t),
        n_regular=n_reg, marginals=margs, pruned_channels=pruned)


_memoized = memo.memoized_search


def img2col(layer: ConvLayerSpec, array: ArrayConfig,
            grid: MacroGrid = MacroGrid()) -> LayerMapping:
    """PW == K: every output position is its own window load."""
    w = Window(layer.k_w, layer.k_h)
    # img2col stacks the whole K*K*IC column vector; channel capacity per
    # array load is floor(AR / (K*K)).
    t = _tile(layer, array, w, layer.ic, marginal=False)
    if t is None:
        raise ValueError(f"{layer.name}: kernel column exceeds array")
    return LayerMapping(layer=layer, array=array, algorithm="img2col",
                        tiles=(t,), grid=grid)


def sdk_scalar(layer: ConvLayerSpec, array: ArrayConfig,
               grid: MacroGrid = MacroGrid()) -> LayerMapping:
    """Reference scalar loop for :func:`sdk`."""
    best = None
    for w in cyc.candidate_windows(layer, array):
        m = _sdk_candidate(layer, array, w, grid)
        if m is not None and (best is None or m.cycles < best.cycles):
            best = m
    if best is None:
        raise ValueError(f"{layer.name}: no feasible SDK window")
    return best


def _sdk_candidate(layer: ConvLayerSpec, array: ArrayConfig, w: Window,
                   grid: MacroGrid) -> Optional[LayerMapping]:
    rows = w.rows(layer.ic)
    ar_c = math.ceil(rows / array.ar)
    oc_t = cyc.oc_t_for(w, layer, array)
    if oc_t < 1:
        return None
    n_reg, _ = cyc.n_windows(layer, w, marginal=False)
    t = TileMapping(window=w, depth=layer.ic, ic_t=layer.ic, oc_t=oc_t,
                    ar_c=ar_c, ac_c=math.ceil(layer.oc / oc_t),
                    n_regular=n_reg)
    return LayerMapping(layer=layer, array=array, algorithm="SDK",
                        tiles=(t,), grid=grid)


def sdk(layer: ConvLayerSpec, array: ArrayConfig,
        grid: MacroGrid = MacroGrid()) -> LayerMapping:
    """SDK: search windows but *all* IC channels must live in one tile —
    if the unrolled window exceeds AR the load is multiplexed over
    ceil(rows/AR) array passes (the 'great number of CIM arrays' cost)."""

    def vectorized(g: MacroGrid) -> LayerMapping:
        tab = cyc.cached_window_table(layer, array)
        if not len(tab):
            raise ValueError(f"{layer.name}: no feasible SDK window")
        ar_c = cyc.ceil_div(tab.rows1 * layer.ic, array.ar)
        ac_c = cyc.ceil_div(layer.oc, tab.oc_t)
        cycles = tab.n_ceil * cyc.ceil_div(ar_c, g.r) * cyc.ceil_div(ac_c, g.c)
        i = int(np.argmin(cycles))          # first min == scalar strict <
        m = _sdk_candidate(layer, array, tab.window(i), g)
        assert m is not None
        return m

    return _memoized("sdk", layer, array, grid,
                     lambda g: sdk_scalar(layer, array, g), vectorized)


def vw_sdk_scalar(layer: ConvLayerSpec, array: ArrayConfig,
                  grid: MacroGrid = MacroGrid()) -> LayerMapping:
    """Reference scalar loop for :func:`vw_sdk` (Alg 1 core loop)."""
    best = None
    for w in cyc.candidate_windows(layer, array):
        t = _tile(layer, array, w, layer.ic, marginal=False)
        if t is None:
            continue
        m = LayerMapping(layer=layer, array=array, algorithm="VW-SDK",
                         tiles=(t,), grid=grid)
        key = (m.cycles, -m.utilization)
        if best is None or key < (best.cycles, -best.utilization):
            best = m
    if best is None:
        raise ValueError(f"{layer.name}: no feasible VW-SDK window")
    return best


def vw_sdk(layer: ConvLayerSpec, array: ArrayConfig,
           grid: MacroGrid = MacroGrid()) -> LayerMapping:
    """VW-SDK (Alg 1 core loop): minimise N_w * AR_c * AC_c over windows."""

    def vectorized(g: MacroGrid) -> LayerMapping:
        tab = cyc.cached_window_table(layer, array)
        if not len(tab):
            raise ValueError(f"{layer.name}: no feasible VW-SDK window")
        ic_t = np.minimum(layer.ic, tab.ic_cap)
        ar_c = cyc.ceil_div(layer.ic, ic_t)
        ac_c = cyc.ceil_div(layer.oc, tab.oc_t)
        cycles = tab.n_ceil * cyc.ceil_div(ar_c, g.r) * cyc.ceil_div(ac_c, g.c)
        best = None
        for i in np.flatnonzero(cycles == cycles.min()):
            t = _tile(layer, array, tab.window(int(i)), layer.ic,
                      marginal=False)
            if t is None:
                continue
            m = LayerMapping(layer=layer, array=array, algorithm="VW-SDK",
                             tiles=(t,), grid=g)
            key = (m.cycles, -m.utilization)
            if best is None or key < (best.cycles, -best.utilization):
                best = m
        assert best is not None
        return best

    return _memoized("vw", layer, array, grid,
                     lambda g: vw_sdk_scalar(layer, array, g), vectorized)


def vwc_sdk_scalar(layer: ConvLayerSpec, array: ArrayConfig,
                   grid: MacroGrid = MacroGrid(),
                   prune_budget: float = 0.05) -> LayerMapping:
    """Reference scalar loop for :func:`vwc_sdk`."""
    best = vw_sdk(layer, array, grid)
    best = dataclasses.replace(best, algorithm="VWC-SDK")
    for w in cyc.candidate_windows(layer, array):
        ic_t = cyc.ic_t_for(w, layer.ic, array)
        if ic_t < 1:
            continue
        residual = layer.ic % ic_t
        if residual == 0 or residual / layer.ic > prune_budget:
            continue
        kept = layer.ic - residual
        t = _tile(layer, array, w, kept, marginal=False, pruned=residual)
        if t is None:
            continue
        m = LayerMapping(layer=layer, array=array, algorithm="VWC-SDK",
                         tiles=(t,), grid=grid)
        if m.cycles < best.cycles:
            best = m
    return best


def vwc_sdk(layer: ConvLayerSpec, array: ArrayConfig,
            grid: MacroGrid = MacroGrid(),
            prune_budget: float = 0.05) -> LayerMapping:
    """VWC-SDK: VW-SDK + residual-channel pruning.

    For each window, if ``IC % IC_t`` leaves a residual tile, the residual
    channels may be pruned away (dropping AR_c by one) provided the pruned
    fraction of this layer stays within ``prune_budget``.  The paper notes
    this "only works for selected layers" — the budget is that selector.
    Exact VWC numbers in Table I/II come from the retrained network of
    [21] and are not derivable from layer dims alone (see EXPERIMENTS.md).
    """

    def vectorized(g: MacroGrid) -> LayerMapping:
        best = vw_sdk(layer, array, g)
        best = dataclasses.replace(best, algorithm="VWC-SDK")
        tab = cyc.cached_window_table(layer, array)
        if not len(tab):
            return best
        ic_t = np.minimum(layer.ic, tab.ic_cap)
        residual = layer.ic % ic_t
        ok = (residual > 0) & (residual <= prune_budget * layer.ic)
        if not ok.any():
            return best
        kept = layer.ic - residual
        ic_t2 = np.minimum(kept, tab.ic_cap)    # kept >= 1 on ok lanes
        ar_c = cyc.ceil_div(kept, np.maximum(ic_t2, 1))
        ac_c = cyc.ceil_div(layer.oc, tab.oc_t)
        cycles = np.where(
            ok, tab.n_ceil * cyc.ceil_div(ar_c, g.r) * cyc.ceil_div(ac_c, g.c),
            np.iinfo(np.int64).max)
        # the scalar loop keeps the first strict win == first argmin lane
        # (all table lanes are feasible, so _tile cannot fail here)
        i = int(np.argmin(cycles))
        t = _tile(layer, array, tab.window(i), int(kept[i]),
                  marginal=False, pruned=int(residual[i]))
        m = LayerMapping(layer=layer, array=array, algorithm="VWC-SDK",
                         tiles=(t,), grid=g)
        if m.cycles < best.cycles:
            best = m
        return best

    return _memoized("vwc", layer, array, grid,
                     lambda g: vwc_sdk_scalar(layer, array, g, prune_budget),
                     vectorized, extra=(prune_budget,))
