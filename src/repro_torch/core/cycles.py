"""Window-count arithmetic (Eq 7) and marginal windows (Alg 4).

Two counting conventions exist in the SDK literature and both appear in the
paper:

* **ceil form** (VW/VWC-SDK): ``ceil((I - K + 1) / (PW - K + 1))`` per axis —
  the last window overhangs the border and the overhang rows are *null
  inputs* (wasted array area but correct coverage).
* **floor form + marginal windows** (Tetris/TetrisG-SDK):
  ``floor((I - PW) / (PW - K + 1)) + 1`` regular windows, plus dedicated
  border windows from Alg 4 when the leftover is nonzero.

Verified against the paper: VW-SDK/CNN8/512x512 => 128 total cycles and
Tetris-SDK => 116 (Table I); CNN8-3 => 48 vs 38 (Fig 12).

Operator-generic note (ISSUE 8): an ``op="matmul"`` spec
(`types.matmul_spec`) is the degenerate k=1, stride=1, i_w=1 geometry, so
both conventions coincide — every candidate window is ``1 x pw_h`` with
``pw_h`` token positions per load, no marginals along the trivial axis —
and the window search below applies verbatim (the ceil-form cycle count
becomes ``ceil(M / pw_h) * ceil(ar_c / r) * ceil(ac_c / c)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from . import memo
from .types import (ArrayConfig, ConvLayerSpec, MarginalWindow, Window)


def axis_windows_ceil(i: int, pw: int, k: int, stride: int = 1) -> int:
    """VW-SDK convention: over-cover the border with null inputs."""
    out = (i - k) // stride + 1                 # output positions along axis
    per_window = (pw - k) // stride + 1         # outputs one window yields
    return math.ceil(out / per_window)


def axis_windows_floor(i: int, pw: int, k: int, stride: int = 1) -> int:
    """Tetris convention: only fully-inside windows (Eq 7 floor form)."""
    per_window = (pw - k) // stride + 1
    return (i - pw) // (stride * per_window) + 1


def axis_leftover(i: int, pw: int, k: int, stride: int = 1) -> int:
    """Input pixels at the border not covered by floor-form windows
    (Alg 4 lines 1-2: ``(I - PW) % (PW - K + 1)`` for stride 1)."""
    per_window = (pw - k) // stride + 1
    return (i - pw) % (stride * per_window)


def axis_covers(i: int, pw: int, k: int, stride: int = 1) -> bool:
    """Can `pw`-sized windows at stride-aligned origins reach the last
    output of the axis?  Border clamps must stay on the stride grid
    (cnn.cim_conv.window_placements), so the largest usable origin is
    ``((i - pw) // s) * s``; the last output's receptive field ends at
    ``((i - k) // s) * s + k``.  Equivalent to
    ``(i - pw) % s <= (i - k) % s``.  Always true for stride 1."""
    return (i - pw) % stride <= (i - k) % stride


def grow_to_cover(i: int, pw: int, k: int, stride: int = 1) -> int:
    """Smallest feasible window size >= pw satisfying :func:`axis_covers`
    (growth < stride; capped at the IFM, where coverage is trivial)."""
    return min(i, pw + max(0, (i - pw) % stride - (i - k) % stride))


def ic_t_for(window: Window, depth_cap: int, array: ArrayConfig) -> int:
    """Channels mappable per array load: floor(AR / (PW_w*PW_h)), Alg 1 l.7."""
    per_ch_rows = window.pw_w * window.pw_h
    return min(depth_cap, array.ar // per_ch_rows)


def oc_t_for(window: Window, layer: ConvLayerSpec, array: ArrayConfig,
             oc_cap: Optional[int] = None) -> int:
    """Output channels per load: floor(AC / (positions * cols_per_weight)),
    Alg 1 l.8."""
    pos = window.positions(layer.k_w, layer.k_h, layer.stride)
    oc = layer.oc if oc_cap is None else oc_cap
    return min(oc, array.ac // (pos * array.cols_per_weight))


def marginal_windows(layer: ConvLayerSpec,
                     base: Window) -> Tuple[MarginalWindow, ...]:
    """Alg 4: dedicated border windows when the IFM is not evenly covered.

    The marginal window keeps roughly the base window's area (so the tile's
    ``ic_t`` still fits) but is reshaped to the leftover strip:
    ``MW_w = leftover + K - 1`` and ``MW_h = area // MW_w`` (capped at the
    IFM).  Its count covers the strip's output rows:
    ``ceil((I - K + 1) / (MW_h - K + 1))`` (equals Alg 4's ``ceil(I / MW_h)``
    on all the paper's worked examples, but is coverage-exact in general).
    """
    s = layer.stride
    area = base.pw_w * base.pw_h
    out: List[MarginalWindow] = []

    # a marginal set is needed only when the leftover strip contains
    # *uncovered outputs* — leftover pixels alone don't imply that at
    # stride > 1 (lo <= (I-K)%S means the last output is already inside
    # the floor-form raster); at stride 1 this is the plain lo > 0 gate
    lo_w = axis_leftover(layer.i_w, base.pw_w, layer.k_w, s)
    if lo_w > (layer.i_w - layer.k_w) % s:
        # max(1, .) guards stride > k geometries where the leftover strip
        # holds no full kernel position (degenerate zero-output window);
        # grow_to_cover keeps stride-aligned border clamps able to reach
        # the last output (no-op at stride 1)
        mw_w = grow_to_cover(layer.i_w, max(1, lo_w + layer.k_w - s),
                             layer.k_w, s)
        mw_h = grow_to_cover(layer.i_h,
                             min(layer.i_h, max(layer.k_h, area // mw_w)),
                             layer.k_h, s)
        per = (mw_h - layer.k_h) // s + 1
        count = math.ceil(((layer.i_h - layer.k_h) // s + 1) / per)
        out.append(MarginalWindow(mw_w=mw_w, mw_h=mw_h, count=count, edge="w"))

    lo_h = axis_leftover(layer.i_h, base.pw_h, layer.k_h, s)
    if lo_h > (layer.i_h - layer.k_h) % s:
        mw_h = grow_to_cover(layer.i_h, max(1, lo_h + layer.k_h - s),
                             layer.k_h, s)
        mw_w = grow_to_cover(layer.i_w,
                             min(layer.i_w, max(layer.k_w, area // mw_h)),
                             layer.k_w, s)
        per = (mw_w - layer.k_w) // s + 1
        count = math.ceil(((layer.i_w - layer.k_w) // s + 1) / per)
        out.append(MarginalWindow(mw_w=mw_w, mw_h=mw_h, count=count, edge="h"))

    return tuple(out)


def n_windows(layer: ConvLayerSpec, window: Window, *,
              marginal: bool) -> Tuple[int, Tuple[MarginalWindow, ...]]:
    """(regular windows, marginal windows) for one window shape.

    ``marginal=False`` => VW-SDK ceil convention, no marginal set.
    ``marginal=True``  => Tetris floor convention + Alg 4 marginal set.
    """
    s = layer.stride
    if not marginal:
        nw = (axis_windows_ceil(layer.i_w, window.pw_w, layer.k_w, s)
              * axis_windows_ceil(layer.i_h, window.pw_h, layer.k_h, s))
        return nw, ()
    nw = (axis_windows_floor(layer.i_w, window.pw_w, layer.k_w, s)
          * axis_windows_floor(layer.i_h, window.pw_h, layer.k_h, s))
    return nw, marginal_windows(layer, window)


def candidate_windows(layer: ConvLayerSpec, array: ArrayConfig):
    """All feasible (window) shapes: at least one channel and one output
    channel must fit (AR constraint Eq 10, AC constraint Eq 11)."""
    for pw_w in range(layer.k_w, layer.i_w + 1):
        for pw_h in range(layer.k_h, layer.i_h + 1):
            w = Window(pw_w, pw_h)
            if w.rows(1) > array.ar:
                continue
            pos = w.positions(layer.k_w, layer.k_h, layer.stride)
            if pos * array.cols_per_weight > array.ac:
                continue
            if not (axis_covers(layer.i_w, pw_w, layer.k_w, layer.stride)
                    and axis_covers(layer.i_h, pw_h, layer.k_h,
                                    layer.stride)):
                continue     # border clamp would fall off the stride grid
            yield w


# ---------------------------------------------------------------------------
# Vectorized candidate scoring
# ---------------------------------------------------------------------------

def ceil_div(a, b):
    """Ceiling division, exact for ints and numpy int arrays alike."""
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class WindowTable:
    """All feasible candidate windows of a (layer, array) pair scored at
    once with numpy — the grid-independent half of the window search.

    Rows follow :func:`candidate_windows` iteration order exactly
    (``pw_w`` outer, ``pw_h`` inner), so a stable argmin over table
    columns picks the same winner as the first-strictly-better scalar
    loop.  All columns are exact int64 replicas of the scalar formulas
    (asserted against the scalar path in tests/test_search_cache.py).
    """

    pw_w: np.ndarray       # candidate window widths
    pw_h: np.ndarray       # candidate window heights
    rows1: np.ndarray      # input rows per channel (pw_w * pw_h)
    pos: np.ndarray        # kernel positions inside the window
    ic_cap: np.ndarray     # channels per array load (AR constraint)
    oc_t: np.ndarray       # output channels per load (AC constraint)
    n_ceil: np.ndarray     # ceil-form window count (VW-SDK convention)
    n_marg: np.ndarray     # floor-form count + Alg 4 marginal loads

    def __len__(self) -> int:
        return len(self.pw_w)

    def window(self, i: int) -> Window:
        return Window(int(self.pw_w[i]), int(self.pw_h[i]))


def window_table(layer: ConvLayerSpec, array: ArrayConfig) -> WindowTable:
    """Score every feasible window of (layer, array) in one numpy pass."""
    s = layer.stride
    k_w, k_h = layer.k_w, layer.k_h
    ww = np.arange(k_w, layer.i_w + 1, dtype=np.int64)
    hh = np.arange(k_h, layer.i_h + 1, dtype=np.int64)
    pw_w = np.repeat(ww, len(hh))          # pw_w outer, pw_h inner
    pw_h = np.tile(hh, len(ww))

    rows1 = pw_w * pw_h
    px = (pw_w - k_w) // s + 1
    py = (pw_h - k_h) // s + 1
    pos = px * py
    feasible = ((rows1 <= array.ar)
                & (pos * array.cols_per_weight <= array.ac)
                & ((layer.i_w - pw_w) % s <= (layer.i_w - k_w) % s)
                & ((layer.i_h - pw_h) % s <= (layer.i_h - k_h) % s))
    pw_w, pw_h = pw_w[feasible], pw_h[feasible]
    rows1, px, py, pos = (rows1[feasible], px[feasible], py[feasible],
                          pos[feasible])

    ic_cap = array.ar // rows1
    oc_t = np.minimum(layer.oc, array.ac // (pos * array.cols_per_weight))

    out_w = (layer.i_w - k_w) // s + 1
    out_h = (layer.i_h - k_h) // s + 1
    n_ceil = ceil_div(out_w, px) * ceil_div(out_h, py)
    n_floor = (((layer.i_w - pw_w) // (s * px) + 1)
               * ((layer.i_h - pw_h) // (s * py) + 1))

    # Alg 4 marginal loads, vectorized (mirrors marginal_windows exactly,
    # including grow_to_cover: m + max(0, (i-m)%s - (i-k)%s) capped at i)
    def grow(i, m, k):
        return np.minimum(i, m + np.maximum(0, (i - m) % s - (i - k) % s))

    area = pw_w * pw_h
    lo_w = (layer.i_w - pw_w) % (s * px)
    mw_w = grow(layer.i_w, np.maximum(1, lo_w + k_w - s), k_w)
    mw_h = grow(layer.i_h,
                np.minimum(layer.i_h, np.maximum(k_h, area // mw_w)), k_h)
    per_w = (mw_h - k_h) // s + 1
    cnt_w = np.where(lo_w > (layer.i_w - k_w) % s,
                     ceil_div(out_h, per_w), 0)

    lo_h = (layer.i_h - pw_h) % (s * py)
    mw_h2 = grow(layer.i_h, np.maximum(1, lo_h + k_h - s), k_h)
    mw_w2 = grow(layer.i_w,
                 np.minimum(layer.i_w, np.maximum(k_w, area // mw_h2)), k_w)
    per_h = (mw_w2 - k_w) // s + 1
    cnt_h = np.where(lo_h > (layer.i_h - k_h) % s,
                     ceil_div(out_w, per_h), 0)

    return WindowTable(pw_w=pw_w, pw_h=pw_h, rows1=rows1, pos=pos,
                       ic_cap=ic_cap, oc_t=oc_t, n_ceil=n_ceil,
                       n_marg=n_floor + cnt_w + cnt_h)


def cached_window_table(layer: ConvLayerSpec,
                        array: ArrayConfig) -> WindowTable:
    """The (grid-independent) window table through the memo table cache —
    the single shared accessor for every search algorithm."""
    return memo.cached_table(("wtab", layer, array),
                             lambda: window_table(layer, array))
