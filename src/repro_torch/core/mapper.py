"""Top-level mapping API: algorithm dispatch + depthwise/native-group
handling + network mapping (paper §III, Algs 1-5 behind one door).

``map_layer(layer, array, algorithm=..., grid=...)`` is the single entry
point used by benchmarks, the CIM simulator and all three JAX executors
(cnn/cim_conv.py, cnn/mapped_net.py, kernels/im2win_conv.py);
``map_net`` / ``grid_search`` lift it to whole networks and the Alg 2
macro-budget sweep.  ``ALGORITHMS`` orders the six searches exactly as
the paper's comparison tables do (img2col -> TetrisG-SDK).

Native groups (depthwise = ``groups=ic``, §IV-C3): a layer with
``groups > 1`` is mapped once on its per-group dims and the native-group
count folds *multiplicatively* into ``LayerMapping.group`` — TetrisG's
searched grouping composes on top, and the paper's MobileNet observation
(depthwise leaves no cross-channel reuse, so SDK windows degenerate)
falls out of this accounting rather than being special-cased.

Invariants:

* every returned ``LayerMapping`` carries the caller's ``grid`` and is
  executable as-is by the executors (tiles cover all kept channels; the
  DESIGN.md §5 equivalence contract is algorithm-independent);
* ``tiles`` always describe ONE group's mapping — for native groups the
  per-group sub-layer's, re-wrapped onto the full layer spec;
* dispatch is total over ``ALGORITHMS``: an unknown name raises KeyError
  rather than silently falling back.
"""
from __future__ import annotations

from typing import Callable, Sequence

from . import baselines, grouped, tetris
from .macro_grid import GridSearchResult, macro_grid_search
from .types import (ArrayConfig, ConvLayerSpec, LayerMapping, MacroGrid,
                    NetworkMapping)

ALGORITHMS = ("img2col", "SDK", "VW-SDK", "VWC-SDK", "Tetris-SDK",
              "TetrisG-SDK")


def _dispatch(algorithm: str) -> Callable[..., LayerMapping]:
    return {
        "img2col": baselines.img2col,
        "SDK": baselines.sdk,
        "VW-SDK": baselines.vw_sdk,
        "VWC-SDK": baselines.vwc_sdk,
        "Tetris-SDK": tetris.tetris_layer,
        "TetrisG-SDK": grouped.tetrisg_layer,
    }[algorithm]


def map_layer(layer: ConvLayerSpec, array: ArrayConfig,
              algorithm: str = "TetrisG-SDK",
              grid: MacroGrid = MacroGrid(), **kw) -> LayerMapping:
    """Map one conv layer.  Layers with native groups (depthwise etc.) are
    mapped per native group and the native-group loop folds into the
    `group` multiplier — the paper's MobileNet observation (depthwise
    leaves no cross-channel reuse) falls out of this accounting."""
    if layer.groups > 1:
        sub = layer.per_group(layer.groups)
        m = _dispatch(algorithm)(sub, array, grid, **kw)
        return LayerMapping(layer=layer, array=array, algorithm=m.algorithm,
                            tiles=m.tiles, grid=grid,
                            group=layer.groups * m.group,
                            group_split=grouped.best_group_split(
                                m, layer.groups * m.group, grid))
    return _dispatch(algorithm)(layer, array, grid, **kw)


def map_net(name: str, layers: Sequence[ConvLayerSpec], array: ArrayConfig,
            algorithm: str = "TetrisG-SDK",
            grid: MacroGrid = MacroGrid(), glue=None, **kw) -> NetworkMapping:
    """Map every layer; ``glue`` (optional tuple[GlueSpec, ...], one per
    layer) passes through to the NetworkMapping for compile_plan —
    mapping search itself never looks at it."""
    mapped = tuple(map_layer(ly, array, algorithm, grid, **kw)
                   for ly in layers)
    return NetworkMapping(name=name, algorithm=algorithm, array=array,
                          layers=mapped, grid=grid, glue=glue)


def grid_search(name: str, layers: Sequence[ConvLayerSpec],
                array: ArrayConfig, p_max: int,
                algorithm: str = "TetrisG-SDK", **kw) -> GridSearchResult:
    """Alg 2 entry point."""
    def mapper(ly, a, g, **kwargs):
        return map_layer(ly, a, algorithm, g, **kwargs)
    return macro_grid_search(name, layers, array, mapper, p_max, **kw)
