"""TetrisG grouped-convolution mapping (paper §III-B, Alg 1).

A grouping factor G transforms the layer to per-group dims
``(IC/G, OC/G)`` (Eq 9), relaxing the AR/AC constraints (Eq 10/11): a
group's outputs only need IC/G input channels, so when AC bounds the
window (positions * OC > AC) a grouped window can grow by up to G x
positions — fewer parallel windows for the same coverage (Fig 11).

Accounting: one group's mapping is searched with Tetris-SDK on per-group
dims; the G congruent groups either time-multiplex a macro (single-macro
mode) or spread over disjoint sub-grids of the macro grid
(``group_split``), which is where the paper's EDAP wins come from (§IV-E).

Accuracy: the paper trains the network with grouped Conv2D and accepts G
only if accuracy loss stays under a threshold (<=0.5 %).  The training-side
counterpart lives in ``repro.cnn.train`` (grouped CNN training on the
synthetic dataset, now runnable *through* the mapped executor so the
accuracy and the cycles come from the same path); this module takes the
*mapping* decision given an allowed set of G.

Invariants:

* the winning ``LayerMapping`` has ``group == G`` and tiles searched on
  the per-group dims — executors therefore expect kernels in the lax
  grouped layout ``(k, k, ic/G, oc)``;
* ``group_split=(gr, gc)`` always satisfies ``gr <= grid.r``,
  ``gc <= grid.c`` and ``gr*gc <= G`` (best_group_split's lattice), so
  ``sub_grid`` never degenerates below 1x1;
* ties prefer fewer groups (accuracy headroom before cycle parity).

Operator-generic note (ISSUE 8): grouped *matmul* is exactly this
transform at k=1 — an ``op="matmul"`` spec (`types.matmul_spec`) with
``groups=G`` is the paper's §III-B grouped convolution on the degenerate
geometry, and the whole search (valid_groups, group_split, Eq 9-11)
applies unchanged; the ``"matmul"`` executor realises the G congruent
groups as `kernels.grouped_matmul`'s block-diagonal grid.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from .tetris import tetris_layer
from .types import ArrayConfig, ConvLayerSpec, LayerMapping, MacroGrid


def valid_groups(layer: ConvLayerSpec,
                 candidates: Iterable[int] = (1, 2, 4, 8)) -> Tuple[int, ...]:
    """G must divide both IC and OC; native grouping (depthwise) composes
    multiplicatively and is handled by mapping the per-native-group layer."""
    return tuple(g for g in candidates
                 if layer.ic % g == 0 and layer.oc % g == 0)


def best_group_split(base: LayerMapping, group: int,
                     grid: MacroGrid) -> Tuple[int, int]:
    """Choose (gr, gc): how many groups run concurrently along each grid
    dim.  Exhaustive over the (small) grid divisor lattice."""
    best_split, best_cyc = (1, 1), None
    for gr in range(1, grid.r + 1):
        for gc in range(1, grid.c + 1):
            if gr * gc > group:
                continue
            m = LayerMapping(**{**base.__dict__, "group": group,
                                "group_split": (gr, gc)})
            if best_cyc is None or m.cycles < best_cyc:
                best_cyc, best_split = m.cycles, (gr, gc)
    return best_split


def tetrisg_layer(layer: ConvLayerSpec, array: ArrayConfig,
                  grid: MacroGrid = MacroGrid(), *,
                  groups: Iterable[int] = (1, 2, 4, 8),
                  max_prune: int = 1) -> LayerMapping:
    """Alg 1: pick the grouping factor (and its grid split) minimising
    layer cycles; per-group windows come from the Tetris-SDK search."""
    best: Optional[LayerMapping] = None
    for g in valid_groups(layer, groups):
        glayer = layer.per_group(g)
        base = tetris_layer(glayer, array, grid, max_prune=max_prune,
                            algorithm="TetrisG-SDK")
        split = best_group_split(base, g, grid)
        m = LayerMapping(layer=layer, array=array, algorithm="TetrisG-SDK",
                         tiles=base.tiles, grid=grid, group=g,
                         group_split=split)
        key = (m.cycles, m.group)   # prefer fewer groups on ties (accuracy)
        if best is None or key < (best.cycles, best.group):
            best = m
    assert best is not None
    return best
