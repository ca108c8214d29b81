"""Tetris-SDK adaptive-window search (paper §III D-F, Algs 3-5).

Structure of the per-layer search (validated against the paper's worked
examples — CNN8 totals 116, CNN8-3 = 38, CNN8-5 tiles 24+24+16):

1. enumerate base parallel windows (square-inclined shapes rank first,
   Alg 3 — for a fixed number of in-window convolutions, a near-square
   output footprint minimises input rows, AM-GM);
2. the base window defines `ic_t`; channels split into ``ic // ic_t`` full
   tiles + one remainder tile;
3. the remainder tile gets its own *depth-optimal* window (Alg 5), allowed
   to prune up to ``max_prune`` channels when that unlocks a strictly
   better factorisation (paper prunes 1 channel in CNN8-3);
4. every tile uses floor-form window counts plus *marginal windows*
   (Alg 4, implemented in cycles.marginal_windows);
5. keep the base window minimising total layer cycles.

Execution strategy: the candidate scoring is vectorized — one numpy pass
over the whole window set (cycles.window_table) ranks every candidate by
exact integer cycle count, and only the argmin set is materialised as
TileMapping objects for the float utilization tie-break.  The table is
grid-independent and cached (core/memo.py), so a macro-grid sweep
(Alg 2) scores ~P·log P grids against one table; full results are also
cached under the *effective* grid.  ``memo.disabled()`` falls back to
the original first-strictly-better scalar loop (kept as
``tetris_layer_scalar``), and both paths are asserted identical in
tests/test_search_cache.py.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np

from . import cycles as cyc
from . import memo
from .types import (ArrayConfig, ConvLayerSpec, LayerMapping, MacroGrid,
                    TileMapping, Window)


def factor_pairs_square_first(n: int) -> List[Tuple[int, int]]:
    """Factor pairs (a, b) of n ordered square-inclined first (Alg 3 l.4:
    'factorize N_conv using square-root')."""
    pairs = []
    for a in range(int(math.isqrt(n)), 0, -1):
        if n % a == 0:
            b = n // a
            pairs.append((a, b))
            if a != b:
                pairs.append((b, a))
    return pairs


def square_inclined(layer: ConvLayerSpec, array: ArrayConfig,
                    window: Window) -> Window:
    """Alg 3: replace `window` by the most square window computing the same
    number of convolutions, if it needs no more rows (=> ic_t can only
    grow).  The exhaustive search in :func:`tetris_layer` subsumes this,
    but the faithful refinement is exposed (and unit-tested) on its own."""
    n_conv = window.positions(layer.k_w, layer.k_h, layer.stride)
    s = layer.stride
    best = window
    for a, b in factor_pairs_square_first(n_conv):
        cand = Window((a - 1) * s + layer.k_w, (b - 1) * s + layer.k_h)
        if cand.pw_w > layer.i_w or cand.pw_h > layer.i_h:
            continue
        if cand.rows(1) <= best.rows(1):  # fewer rows per channel
            if cand.rows(1) < best.rows(1) or cand is window:
                best = cand
    return best


def _mk_tile(layer: ConvLayerSpec, array: ArrayConfig, window: Window,
             depth: int, pruned: int = 0) -> Optional[TileMapping]:
    ic_t = cyc.ic_t_for(window, depth, array)
    if ic_t < 1:
        return None
    oc_t = cyc.oc_t_for(window, layer, array)
    if oc_t < 1:
        return None
    n_reg, margs = cyc.n_windows(layer, window, marginal=True)
    return TileMapping(window=window, depth=depth, ic_t=ic_t, oc_t=oc_t,
                       ar_c=math.ceil(depth / ic_t),
                       ac_c=math.ceil(layer.oc / oc_t),
                       n_regular=n_reg, marginals=margs,
                       pruned_channels=pruned)


def _better_tile(t: Optional[TileMapping], ref: Optional[TileMapping]
                 ) -> bool:
    """Alg 5 ordering: fewest single-grid cycles, then least pruning,
    then densest load."""
    if t is None:
        return False
    if ref is None:
        return True
    a = (t.n_windows * t.ar_c * t.ac_c, t.pruned_channels,
         -t.ic_t * t.window.rows(1))
    b = (ref.n_windows * ref.ar_c * ref.ac_c, ref.pruned_channels,
         -ref.ic_t * ref.window.rows(1))
    return a < b


@functools.lru_cache(maxsize=65536)
def depth_optimal_tile_scalar(layer: ConvLayerSpec, array: ArrayConfig,
                              depth: int, max_prune: int = 1
                              ) -> Optional[TileMapping]:
    """Reference scalar loop for Alg 5 (see :func:`depth_optimal_tile`);
    lru-cached exactly as the seed implementation was, but on a cache of
    its own so memo.disabled() parity runs truly execute the scalar
    scan."""
    best: Optional[TileMapping] = None
    for prune in range(0, max_prune + 1):
        d = depth - prune
        if d < 1:
            break
        for w in cyc.candidate_windows(layer, array):
            if w.rows(d) > array.ar:
                continue  # the whole remainder must fit one load
            t = _mk_tile(layer, array, w, d, pruned=prune)
            if t is not None and _better_tile(t, best):
                best = t
    return best


@functools.lru_cache(maxsize=65536)
def _depth_optimal_tile_fast(layer: ConvLayerSpec, array: ArrayConfig,
                             depth: int, max_prune: int = 1
                             ) -> Optional[TileMapping]:
    """Vectorized Alg 5 scan: one pass per prune level over the cached
    window table (see :func:`depth_optimal_tile`)."""
    tab = cyc.cached_window_table(layer, array)
    if not len(tab):
        return None
    ac_c = cyc.ceil_div(layer.oc, tab.oc_t)
    best: Optional[TileMapping] = None
    best_key = None
    for prune in range(0, max_prune + 1):
        d = depth - prune
        if d < 1:
            break
        fits = tab.rows1 * d <= array.ar   # whole remainder in one load
        if not fits.any():
            continue
        # one load => ar_c == 1; Alg 5 key (cycles, prune, -density)
        k1 = np.where(fits, tab.n_marg * ac_c, np.iinfo(np.int64).max)
        k3 = -d * tab.rows1
        i = int(np.lexsort((k3, k1))[0])   # stable: first in table order
        key = (int(k1[i]), prune, int(k3[i]))
        if best is None or key < best_key:
            t = _mk_tile(layer, array, tab.window(i), d, pruned=prune)
            if t is not None:
                best, best_key = t, key
    return best


def depth_optimal_tile(layer: ConvLayerSpec, array: ArrayConfig,
                       depth: int, max_prune: int = 1
                       ) -> Optional[TileMapping]:
    """Alg 5: best window for a remainder tile of `depth` channels, pruning
    up to `max_prune` channels when it strictly reduces cycles.

    Rather than only scanning factor pairs of ``Max_conv = AC // OC`` (the
    paper's inner loop, which assumes OC <= AC), we exhaustively score every
    feasible window whose full `depth` fits in one load — this subsumes the
    paper's loop and reproduces its examples (CNN8-3: 6x6 @ 14ch after
    pruning 1; CNN8-5: 6x4 @ 16ch, no pruning).  Scalar and vectorized
    implementations keep separate caches so the memo-disabled path never
    reads vectorized results (and vice versa).
    """
    if not memo.enabled():
        return depth_optimal_tile_scalar(layer, array, depth, max_prune)
    return _depth_optimal_tile_fast(layer, array, depth, max_prune)


memo.register_cache_clear(depth_optimal_tile_scalar.cache_clear)
memo.register_cache_clear(_depth_optimal_tile_fast.cache_clear)


def _candidate_mapping(layer: ConvLayerSpec, array: ArrayConfig,
                       w: Window, grid: MacroGrid, max_prune: int,
                       algorithm: str) -> Optional[LayerMapping]:
    """Materialise the full-tiles + depth-optimal-remainder mapping for one
    base window (the scalar loop body of the Tetris search)."""
    ic_t = cyc.ic_t_for(w, layer.ic, array)
    if ic_t < 1:
        return None
    oc_t = cyc.oc_t_for(w, layer, array)
    if oc_t < 1:
        return None
    n_full, rem = divmod(layer.ic, ic_t)
    tiles: List[TileMapping] = []
    if n_full:
        t = _mk_tile(layer, array, w, ic_t)
        if t is None:
            return None
        # n_full congruent tiles: represent once with ar_c = n_full
        tiles.append(TileMapping(
            window=t.window, depth=n_full * ic_t, ic_t=ic_t, oc_t=t.oc_t,
            ar_c=n_full, ac_c=t.ac_c, n_regular=t.n_regular,
            marginals=t.marginals))
    if rem:
        rt = depth_optimal_tile(layer, array, rem, max_prune=max_prune)
        if rt is None:
            # fall back: remainder under the base window (multi-load)
            rt = _mk_tile(layer, array, w, rem)
        if rt is None:
            return None
        tiles.append(rt)
    if not tiles:
        return None
    return LayerMapping(layer=layer, array=array, algorithm=algorithm,
                        tiles=tuple(tiles), grid=grid)


def _vw_seed(layer: ConvLayerSpec, array: ArrayConfig, grid: MacroGrid,
             algorithm: str) -> LayerMapping:
    """The VW-SDK solution (ceil windows, no marginal set) is included as
    a candidate, so Tetris is never worse than VW-SDK — on rare geometries
    the floor+marginal decomposition alone can lose to a single
    border-overhanging window (found by the hypothesis suite)."""
    from . import baselines
    vw = baselines.vw_sdk(layer, array, grid)
    return LayerMapping(layer=layer, array=array, algorithm=algorithm,
                        tiles=vw.tiles, grid=grid)


def tetris_layer_scalar(layer: ConvLayerSpec, array: ArrayConfig,
                        grid: MacroGrid = MacroGrid(), *,
                        max_prune: int = 1,
                        algorithm: str = "Tetris-SDK") -> LayerMapping:
    """Reference scalar loop (see :func:`tetris_layer`): first-strictly-
    better scan over every candidate window."""
    best: Optional[LayerMapping] = _vw_seed(layer, array, grid, algorithm)
    for w in cyc.candidate_windows(layer, array):
        m = _candidate_mapping(layer, array, w, grid, max_prune, algorithm)
        if m is None:
            continue
        key = (m.cycles, m.pruned_channels, -m.utilization)
        if best is None or key < (best.cycles, best.pruned_channels,
                                  -best.utilization):
            best = m
    if best is None:
        raise ValueError(f"{layer.name}: no feasible Tetris window")
    return best


def _tetris_layer_search(layer: ConvLayerSpec, array: ArrayConfig,
                         grid: MacroGrid, max_prune: int,
                         algorithm: str) -> LayerMapping:
    """Vectorized Tetris search: exact integer (cycles, pruned) scores for
    all candidates at once, then the scalar tie-break on the argmin set."""
    tab = cyc.cached_window_table(layer, array)
    if not len(tab):
        raise ValueError(f"{layer.name}: no feasible Tetris window")
    r, c = grid.r, grid.c

    ic_t = np.minimum(layer.ic, tab.ic_cap)     # >= 1 for all table rows
    n_full = layer.ic // ic_t                   # >= 1 (ic_t <= ic)
    rem = layer.ic % ic_t
    ac_c = cyc.ceil_div(layer.oc, tab.oc_t)
    cycles = tab.n_marg * cyc.ceil_div(n_full, r) * cyc.ceil_div(ac_c, c)
    pruned = np.zeros(len(tab), np.int64)

    # remainder-tile contribution per distinct remainder depth
    for d in np.unique(rem):
        d = int(d)
        if d == 0:
            continue
        lanes = rem == d
        # never None here: rem < ic_t <= ic_cap, so every lane's own base
        # window fits the whole remainder in one load
        rt = depth_optimal_tile(layer, array, d, max_prune=max_prune)
        cycles[lanes] += (rt.n_windows * math.ceil(rt.ar_c / r)
                          * math.ceil(rt.ac_c / c))
        pruned[lanes] += rt.pruned_channels

    best = _vw_seed(layer, array, grid, algorithm)
    m1 = cycles == cycles.min()
    subset = np.flatnonzero(m1 & (pruned == pruned[m1].min()))
    for i in subset:
        m = _candidate_mapping(layer, array, tab.window(int(i)), grid,
                               max_prune, algorithm)
        if m is None:
            continue
        key = (m.cycles, m.pruned_channels, -m.utilization)
        if key < (best.cycles, best.pruned_channels, -best.utilization):
            best = m
    return best


def tetris_layer(layer: ConvLayerSpec, array: ArrayConfig,
                 grid: MacroGrid = MacroGrid(), *,
                 max_prune: int = 1,
                 algorithm: str = "Tetris-SDK") -> LayerMapping:
    """Full Tetris-SDK search for one layer (one group's dims).

    Memoized under the effective grid (memo.effective_grid) and scored
    via the vectorized table; with ``memo.disabled()`` this is the plain
    scalar loop.  Both return bit-identical mappings.
    """
    return memo.memoized_search(
        "tetris", layer, array, grid,
        scalar=lambda g: tetris_layer_scalar(
            layer, array, g, max_prune=max_prune, algorithm=algorithm),
        vectorized=lambda g: _tetris_layer_search(
            layer, array, g, max_prune, algorithm),
        extra=(max_prune, algorithm))
