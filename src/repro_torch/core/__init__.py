# The paper's primary contribution: TetrisG-SDK convolution->CIM mapping.
# A copy of the JAX package's core, kept as close to verbatim as
# possible so both packages compute identical mappings.
# types.py      data model (layers, arrays, windows, mappings)
# cycles.py     window-count arithmetic (Eq 7) + marginal windows (Alg 4)
# baselines.py  img2col / SDK / VW-SDK / VWC-SDK
# tetris.py     square-inclined + depth-optimal search (Algs 3, 5)
# grouped.py    grouped-convolution mapping (Alg 1)
# macro_grid.py macro-configuration search (Alg 2)
# mapper.py     top-level dispatch
# simulator.py  NeuroSim-style latency/energy/area/EDAP model
# memo.py       search / plan caches (disk keys carry this package's name)
# networks.py   benchmark conv stacks (CNN8, Inception, DenseNet40, MobileNet)
from .types import (ArrayConfig, ConvLayerSpec, GlueSpec, LayerMapping,
                    MacroGrid, MarginalWindow, NetworkMapping, TileMapping,
                    Window, conv1d, matmul_spec)
from .mapper import ALGORITHMS, grid_search, map_layer, map_net
from . import memo, networks

__all__ = [
    "ArrayConfig", "ConvLayerSpec", "GlueSpec", "LayerMapping", "MacroGrid",
    "MarginalWindow", "NetworkMapping", "TileMapping", "Window", "conv1d",
    "matmul_spec", "ALGORITHMS", "grid_search", "map_layer", "map_net",
    "memo", "networks",
]
