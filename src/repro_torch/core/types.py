"""Core data model for CIM convolution mapping.

All mapping algorithms (img2col / SDK / VW-SDK / VWC-SDK / Tetris-SDK /
TetrisG-SDK) consume a :class:`ConvLayerSpec` + :class:`ArrayConfig` and
produce a :class:`LayerMapping` — an explicit, executable description of the
parallel-window tiling (window shapes, per-tile channel depths, marginal
windows, cycle counts). The `MappingPlan` for a whole network is the unit
consumed by the CIM simulator (core/simulator.py) and by the JAX executors
(cnn/cim_conv.py, kernels/).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence, Tuple


@dataclass(frozen=True)
class ConvLayerSpec:
    """One convolutional layer, post-padding.

    ``i_w``/``i_h`` are the *padded* input feature-map spatial dims (the
    paper's Table I lists padded IFMs, e.g. 18x18 for a 16x16 feature map
    with 3x3/pad-1 convolution).  ``groups`` is the layer's *native* group
    count (depthwise = ic); TetrisG's grouped-convolution transform is
    applied on top via ``grouped.apply_grouping``.
    """

    name: str
    i_w: int
    i_h: int
    k_w: int
    k_h: int
    ic: int
    oc: int
    stride: int = 1
    groups: int = 1
    op: str = "conv"           # "conv" | "matmul" (degenerate 1x1 geometry)

    def __post_init__(self):
        if self.i_w < self.k_w or self.i_h < self.k_h:
            raise ValueError(f"{self.name}: IFM smaller than kernel")
        if self.ic % self.groups or self.oc % self.groups:
            raise ValueError(f"{self.name}: ic/oc not divisible by groups")
        if self.op not in ("conv", "matmul"):
            raise ValueError(f"{self.name}: unknown op {self.op!r}")
        if self.op == "matmul" and (self.k_w != 1 or self.k_h != 1
                                    or self.stride != 1 or self.i_w != 1):
            raise ValueError(
                f"{self.name}: op='matmul' must be the degenerate 1x1 "
                f"geometry (k=1, stride=1, i_w=1); use matmul_spec()")

    @property
    def k(self) -> int:
        if self.k_w != self.k_h:
            raise ValueError("square kernel expected")
        return self.k_w

    @property
    def o_w(self) -> int:
        return (self.i_w - self.k_w) // self.stride + 1

    @property
    def o_h(self) -> int:
        return (self.i_h - self.k_h) // self.stride + 1

    @property
    def macs(self) -> int:
        """MAC count of the layer (per image)."""
        return (self.k_w * self.k_h * (self.ic // self.groups) * self.oc
                * self.o_w * self.o_h)

    def per_group(self, g: int) -> "ConvLayerSpec":
        """Per-group dims after grouping (Eq 9).  The per-group layer is an
        ordinary (group-free) convolution."""
        if self.ic % g or self.oc % g:
            raise ValueError(f"{self.name}: cannot split into {g} groups")
        return dataclasses.replace(
            self, name=f"{self.name}/g{g}", ic=self.ic // g, oc=self.oc // g,
            groups=1)


def conv1d(name: str, length: int, k: int, ic: int, oc: int,
           groups: int = 1) -> ConvLayerSpec:
    """1-D (temporal) convolution as a degenerate Kx1 2-D layer."""
    return ConvLayerSpec(name=name, i_w=1, i_h=length, k_w=1, k_h=k,
                         ic=ic, oc=oc, groups=groups)


def matmul_spec(name: str, m: int, d: int, f: int,
                groups: int = 1) -> ConvLayerSpec:
    """An ``(M, D) @ (D, F)`` matmul as the degenerate 1x1 conv the
    mapping search already speaks: M token/row positions along ``i_h``,
    D input channels, F output channels (grouped matmul == the paper's
    §III-B grouped convolution with k=1).  ``macs`` reduces to
    ``M * (D // G) * F`` and the ceil-form cycle model, utilization and
    ``group_split`` all apply verbatim; the ``op`` tag is what executors
    and cache keys dispatch on."""
    return ConvLayerSpec(name=name, i_w=1, i_h=m, k_w=1, k_h=1,
                         ic=d, oc=f, groups=groups, op="matmul")


_GLUE_PRE = ("none", "layernorm")
_GLUE_ACT = ("none", "relu", "gelu", "silu")
_GLUE_POST = ("none", "attention")


@dataclass(frozen=True)
class GlueSpec:
    """Inter-layer glue for one plan step — everything between two mapped
    layers that the CIM macros do not execute.

    Applied around layer i's mapped op in this order: ``save`` captures
    the (pre-norm) input for a later residual; ``pre`` normalizes the
    mapped op's input; ``act`` activates its output (overriding any
    global activation for this layer); ``post='attention'`` runs the
    opaque flash-attention stage on a fused qkv output (``heads =
    (n_q, n_kv, head_dim)``); ``kind`` then forms the next layer's
    input — "chain" passes through, "concat" is the DenseNet skip,
    "residual" pops the innermost saved input and adds it.
    """

    kind: str = "chain"        # "chain" | "concat" | "residual" | "last"
    pre: str = "none"
    act: str = "none"
    post: str = "none"
    save: bool = False
    heads: "Tuple[int, int, int]" = None  # (n_q_heads, n_kv_heads, head_dim)
    causal: bool = True

    def __post_init__(self):
        if self.kind not in ("chain", "concat", "residual", "last",
                             "layerwise"):
            raise ValueError(f"unknown glue kind {self.kind!r}")
        if self.pre not in _GLUE_PRE:
            raise ValueError(f"unknown glue pre {self.pre!r}")
        if self.act not in _GLUE_ACT:
            raise ValueError(f"unknown glue act {self.act!r}")
        if self.post not in _GLUE_POST:
            raise ValueError(f"unknown glue post {self.post!r}")
        if (self.heads is not None) != (self.post == "attention"):
            raise ValueError("heads required iff post='attention'")


@dataclass(frozen=True)
class ArrayConfig:
    """A CIM macro: AR x AC bit-cells.

    ``cols_per_weight`` — columns one weight occupies (multi-bit weights on
    consecutive bitlines, Fig 3).  Table I accounting uses 1 (AC counted in
    weight units); the Fig 4 worked example uses 5 (5b weights on a 40x15
    array).
    """

    ar: int = 512
    ac: int = 512
    cols_per_weight: int = 1
    input_bits: int = 8        # bit-serial input cycles (used by simulator)

    @property
    def cells(self) -> int:
        return self.ar * self.ac


@dataclass(frozen=True)
class MacroGrid:
    """An r x c arrangement of identical macros (Alg 2 candidate)."""

    r: int = 1
    c: int = 1

    @property
    def p(self) -> int:
        return self.r * self.c


@dataclass(frozen=True)
class Window:
    """A parallel window: pw_w x pw_h input pixels, covering
    (pw_w-k_w+1) x (pw_h-k_h+1) kernel positions (stride 1 inside)."""

    pw_w: int
    pw_h: int

    def positions(self, k_w: int, k_h: int, stride: int = 1) -> int:
        return (((self.pw_w - k_w) // stride + 1)
                * ((self.pw_h - k_h) // stride + 1))

    def rows(self, depth: int) -> int:
        return self.pw_w * self.pw_h * depth

    def __str__(self):
        return f"{self.pw_w}x{self.pw_h}"


@dataclass(frozen=True)
class MarginalWindow:
    """Alg 4 border window: shape + how many window loads it contributes."""

    mw_w: int
    mw_h: int
    count: int
    edge: str  # "w" (right strip) or "h" (bottom strip)


@dataclass(frozen=True)
class TileMapping:
    """One channel-partition tile mapped with one window shape."""

    window: Window
    depth: int                 # input channels in this tile
    ic_t: int                  # channels per array load (<= depth)
    oc_t: int                  # output channels per array load
    ar_c: int                  # ceil(depth / ic_t) sequential channel loads
    ac_c: int                  # ceil(oc / oc_t) sequential output loads
    n_regular: int
    marginals: tuple = ()      # tuple[MarginalWindow, ...]
    pruned_channels: int = 0

    @property
    def n_windows(self) -> int:
        return self.n_regular + sum(m.count for m in self.marginals)

    def cycles(self, grid: MacroGrid = MacroGrid()) -> int:
        """Eq 5 (grid=1x1) / generalised Eq 6."""
        return (self.n_windows
                * math.ceil(self.ar_c / grid.r)
                * math.ceil(self.ac_c / grid.c))

    def mapped_cells(self, layer: ConvLayerSpec, array: ArrayConfig) -> int:
        """Weight-occupied cells (WC) per array load, for Eq 8.  SDK-style
        whole-channel tiles multiplex over several loads: a single load
        holds at most floor(AR / window area) channels."""
        k_area = layer.k_w * layer.k_h
        pos = self.window.positions(layer.k_w, layer.k_h, layer.stride)
        per_load_ic = min(self.ic_t,
                          array.ar // (self.window.pw_w * self.window.pw_h))
        return k_area * per_load_ic * pos * self.oc_t * array.cols_per_weight


def sub_grid(grid: MacroGrid, group_split: Tuple[int, int]) -> MacroGrid:
    """The disjoint sub-grid ONE group's mapping runs on when
    ``group_split=(gr,gc)`` groups execute concurrently along the grid
    axes (Eq 6): rows parallelize channel passes, columns oc passes."""
    gr, gc = group_split
    return MacroGrid(max(1, grid.r // gr), max(1, grid.c // gc))


def layer_cycles(tiles: Sequence["TileMapping"], grid: MacroGrid,
                 group: int, group_split: Tuple[int, int]) -> int:
    """Total cycles for `group` groups, `group_split=(gr,gc)` of them running
    concurrently on disjoint (r//gr) x (c//gc) sub-grids (Eq 5/6 general).

    The mapping of a single group runs on a sub-grid; `gr*gc` groups run in
    parallel; remaining groups are time-multiplexed.  With grid=1x1 and
    group=1 this is exactly Eq 5.
    """
    gr, gc = group_split
    sub = sub_grid(grid, group_split)
    per_group = sum(t.cycles(sub) for t in tiles)
    return per_group * math.ceil(group / (gr * gc))


@dataclass(frozen=True)
class LayerMapping:
    """Full mapping of one layer under one algorithm.

    ``group`` is the TetrisG grouping factor; ``tiles`` describe ONE group's
    mapping (all groups are congruent); ``group_split=(gr,gc)`` says how many
    groups run concurrently along each grid dimension.
    """

    layer: ConvLayerSpec
    array: ArrayConfig
    algorithm: str
    tiles: tuple                   # tuple[TileMapping, ...]
    grid: MacroGrid = MacroGrid()
    group: int = 1
    group_split: Tuple[int, int] = (1, 1)

    @property
    def cycles(self) -> int:
        return layer_cycles(self.tiles, self.grid, self.group,
                            self.group_split)

    @property
    def sub_grid(self) -> MacroGrid:
        """Sub-grid one group's passes occupy (rows -> channel passes,
        columns -> oc passes); see :func:`sub_grid`."""
        return sub_grid(self.grid, self.group_split)

    @property
    def group_rounds(self) -> int:
        """Sequential rounds of group execution: ``gr*gc`` groups run
        concurrently on disjoint sub-grids, the rest time-multiplex."""
        gr, gc = self.group_split
        return math.ceil(self.group / (gr * gc))

    def tile_passes(self, tile: "TileMapping") -> Tuple[int, int, int, int]:
        """Executed pass structure ``(ic_t, ar_c, oc_t, ac_c)`` of a tile,
        per group.  ``ar_c``/``ac_c`` are the MAPPING's sequential pass
        counts; the executed channel block is re-derived as
        ``ceil(depth / ar_c)`` because SDK-style tiles whose unrolled
        window exceeds AR multiplex *rows* (not channels) over their
        ``ar_c`` passes — re-deriving keeps executed passes == accounted
        passes for every algorithm (DESIGN.md §3 equivalence contract)."""
        oc_g = self.layer.oc // self.group
        ic_t = math.ceil(tile.depth / tile.ar_c)
        oc_t = min(tile.oc_t, oc_g)
        ac_c = math.ceil(oc_g / oc_t)
        return ic_t, tile.ar_c, oc_t, ac_c

    @property
    def n_windows(self) -> int:
        return sum(t.n_windows for t in self.tiles) * self.group

    @property
    def pruned_channels(self) -> int:
        return sum(t.pruned_channels for t in self.tiles) * self.group

    @property
    def utilization(self) -> float:
        """Array utilization (Eq 8), averaged over tiles weighted by loads."""
        num = 0
        den = 0
        for t in self.tiles:
            loads = t.ar_c * t.ac_c * t.n_windows
            num += t.mapped_cells(self.layer, self.array) * loads
            den += self.array.cells * loads
        return num / den if den else 0.0

    @property
    def active_macros(self) -> int:
        """Macros actually used (idle ones are power-gated, §IV-E)."""
        gr, gc = self.group_split
        sub = self.sub_grid
        used_r = max(min(t.ar_c, sub.r) for t in self.tiles)
        used_c = max(min(t.ac_c, sub.c) for t in self.tiles)
        g_par = min(self.group, gr * gc)
        return min(self.grid.p, used_r * used_c * g_par)


@dataclass(frozen=True)
class NetworkMapping:
    """Mapping of a whole network: one LayerMapping per mapped layer.

    ``glue`` is optional explicit inter-layer glue (one `GlueSpec` per
    layer, e.g. from `launch.transformer.transformer_mapping`); when
    None, ``compile_plan`` infers chain/concat glue from channel
    arithmetic as it always has for CNNs.
    """

    name: str
    algorithm: str
    array: ArrayConfig
    layers: tuple                  # tuple[LayerMapping, ...]
    grid: MacroGrid = MacroGrid()
    glue: tuple = None             # Optional[tuple[GlueSpec, ...]]

    def __post_init__(self):
        if self.glue is not None and len(self.glue) != len(self.layers):
            raise ValueError(
                f"{self.name}: glue length {len(self.glue)} != "
                f"{len(self.layers)} layers")

    @property
    def total_cycles(self) -> int:
        return sum(m.cycles for m in self.layers)

    @property
    def mean_utilization(self) -> float:
        us = [m.utilization for m in self.layers]
        return sum(us) / len(us) if us else 0.0

    def summary(self) -> str:
        lines = [f"{self.name} [{self.algorithm}] grid={self.grid.r}x{self.grid.c} "
                 f"total_cycles={self.total_cycles}"]
        for m in self.layers:
            tiles = ", ".join(
                f"{t.window}x{t.ic_t}x{t.oc_t}"
                + (f"(-{t.pruned_channels}ch)" if t.pruned_channels else "")
                for t in m.tiles)
            lines.append(
                f"  {m.layer.name:>14s} G={m.group} cycles={m.cycles:>5d} "
                f"util={m.utilization:5.1%}  [{tiles}]")
        return "\n".join(lines)
