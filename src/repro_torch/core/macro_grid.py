"""Macro-configuration search (paper §III-C, Alg 2).

Given a hardware budget of P_max identical macros, enumerate every
rectangular grid (r, c) with r*c <= P_max, map the whole network per grid
(re-running the window search — "the window set is resized for a P-macro
grid"), and keep the grid minimising total CC_multi.  The search is
offline (O(P_max log P_max) grids) and sub-second for practical budgets:
the per-layer searches this sweep fans out are memoized under their
*effective* grid and score candidates against a shared grid-independent
window table (core/memo.py), so the sweep only pays full search cost for
distinct effective shapes — see benchmarks/search_bench.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from .types import (ArrayConfig, ConvLayerSpec, LayerMapping, MacroGrid,
                    NetworkMapping)


def candidate_grids(p_max: int) -> List[MacroGrid]:
    out = []
    for r in range(1, p_max + 1):
        for c in range(1, p_max // r + 1):
            out.append(MacroGrid(r, c))
    return out


@dataclass(frozen=True)
class GridSearchResult:
    best: NetworkMapping
    per_grid: Tuple[Tuple[MacroGrid, int], ...]   # (grid, total cycles)

    def table(self) -> str:
        lines = ["grid,cycles"]
        for g, cc in sorted(self.per_grid, key=lambda t: (t[0].p, t[0].r)):
            lines.append(f"{g.r}x{g.c},{cc}")
        return "\n".join(lines)


def map_network(name: str,
                layers: Sequence[ConvLayerSpec],
                array: ArrayConfig,
                layer_mapper: Callable[..., LayerMapping],
                grid: MacroGrid = MacroGrid(),
                algorithm: Optional[str] = None,
                **kw) -> NetworkMapping:
    mapped = tuple(layer_mapper(ly, array, grid, **kw) for ly in layers)
    return NetworkMapping(name=name,
                          algorithm=algorithm or mapped[0].algorithm,
                          array=array, layers=mapped, grid=grid)


def macro_grid_search(name: str,
                      layers: Sequence[ConvLayerSpec],
                      array: ArrayConfig,
                      layer_mapper: Callable[..., LayerMapping],
                      p_max: int,
                      **kw) -> GridSearchResult:
    """Alg 2 over a whole network."""
    best: Optional[NetworkMapping] = None
    per_grid: List[Tuple[MacroGrid, int]] = []
    for grid in candidate_grids(p_max):
        net = map_network(name, layers, array, layer_mapper, grid, **kw)
        per_grid.append((grid, net.total_cycles))
        key = (net.total_cycles, grid.p)     # fewest cycles, then macros
        if best is None or key < (best.total_cycles, best.grid.p):
            best = net
    assert best is not None
    return GridSearchResult(best=best, per_grid=tuple(per_grid))
