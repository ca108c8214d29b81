"""Macro-parallel mapped-network executor: the ``mapped`` executor (port
of ``repro/cnn/mapped_net.py``).

``TileMapping.cycles`` assumes a grid (r, c) runs ``r`` channel passes and
``c`` oc passes of every window load concurrently:

    cycles = n_windows * ceil(AR_c / r) * ceil(AC_c / c)

This module executes exactly that schedule.  Per tile, the
(AR_c x AC_c) pass matrix is covered by ``ceil(AR_c/r) * ceil(AC_c/c)``
sequential *super-steps*; within a super-step the (r x c) block of array
passes runs as one macro-grid step — one batched einsum over the
explicit (row, col) macro axes on one device, or, on a ("row", "col")
device mesh (`launch.mesh.make_macro_mesh`) whose axes divide the
sub-grid, one product per mesh coordinate on that coordinate's device,
with the cross-row partial sums added on the input's device
(`launch.sharding.macro_pass_specs`).  A leading "data" mesh axis splits
the batch as well.  Groups follow ``LayerMapping.group_split``: ``gr*gc``
congruent groups run concurrently (batched through the group axis),
remaining groups time-multiplex as ``group_rounds`` sequential rounds.

The *executed* step count is derived from the same host-side structures
the executor iterates and is asserted equal to ``LayerMapping.cycles``
for every layer (:func:`check_steps`, :func:`assert_steps_match`).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.types import LayerMapping, MacroGrid, NetworkMapping, TileMapping
from ..launch.sharding import macro_mesh_fits, macro_pass_specs
from .cim_conv import (_long, build_weight_matrix, gather_patches,
                       kept_writes, placement_groups)


# ---------------------------------------------------------------------------
# Execution schedule: the executor's sequential structure, as host ints
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TileSchedule:
    """Sequential structure of one tile's execution (per group round)."""

    window_loads: int          # gathered placements == tile.n_windows
    r_steps: int               # ceil(ar_c / sub_r) channel super-steps
    c_steps: int               # ceil(ac_c / sub_c) oc super-steps

    @property
    def steps(self) -> int:
        return self.window_loads * self.r_steps * self.c_steps


@dataclass(frozen=True)
class LayerSchedule:
    """What :func:`mapped_conv2d` actually executes for one layer."""

    layer: str
    sub: MacroGrid             # macro sub-grid of one group's passes
    group_rounds: int          # sequential rounds of gr*gc-parallel groups
    tiles: Tuple[TileSchedule, ...]

    @property
    def steps(self) -> int:
        """Executed sequential grid steps — the measured counterpart of
        ``LayerMapping.cycles``."""
        return self.group_rounds * sum(t.steps for t in self.tiles)


@functools.lru_cache(maxsize=None)
def layer_schedule(mapping: LayerMapping) -> LayerSchedule:
    """Derive the executor's schedule from the mapping.  ``window_loads``
    counts the *actual* placement list the executor gathers (floor grid +
    marginals, or the ceil-form clamped raster), not the stored
    ``n_windows`` — the equality of the two is part of the contract."""
    sub = mapping.sub_grid
    tiles = []
    for tile in mapping.tiles:
        _, ar_c, _, ac_c = mapping.tile_passes(tile)
        loads = sum(len(o) for o in
                    placement_groups(mapping.layer, tile).values())
        tiles.append(TileSchedule(
            window_loads=loads,
            r_steps=math.ceil(ar_c / sub.r),
            c_steps=math.ceil(ac_c / sub.c)))
    return LayerSchedule(layer=mapping.layer.name, sub=sub,
                         group_rounds=mapping.group_rounds,
                         tiles=tuple(tiles))


def executed_steps(mapping: LayerMapping) -> int:
    return layer_schedule(mapping).steps


def network_schedule(net: NetworkMapping) -> Tuple[LayerSchedule, ...]:
    return tuple(layer_schedule(m) for m in net.layers)


def check_steps(mapping: LayerMapping) -> None:
    """Raise unless the executor's schedule matches the mapping's cycle
    count — the per-layer half of the steps == cycles contract."""
    s = layer_schedule(mapping)
    if s.steps != mapping.cycles:
        raise AssertionError(
            f"{mapping.layer.name}: executed steps {s.steps} != "
            f"cycles {mapping.cycles} (sub-grid {s.sub.r}x{s.sub.c}, "
            f"rounds {s.group_rounds})")


def assert_steps_match(net: NetworkMapping) -> None:
    """Executed grid steps == analytical cycle count for every layer —
    the Fig 20 speed-ups are executed, not only counted."""
    for m in net.layers:
        check_steps(m)


# ---------------------------------------------------------------------------
# One macro-grid super-step
# ---------------------------------------------------------------------------

def _macro_products(p_blk: torch.Tensor, w_blk: torch.Tensor
                    ) -> torch.Tensor:
    """Each macro's array pass: (sub_r, sub_c, b, g, N, Po) — row r's
    patch block against macro (r, c)'s weight block."""
    return torch.einsum("rbgnk,rcgko->rcbgno", p_blk, w_blk)


def _row_sum(parts) -> torch.Tensor:
    """The macro rows' partial products added in ascending row order —
    the one order both the batched and the sharded step use."""
    acc = None
    for part in parts:
        acc = part if acc is None else acc + part
    return acc


def _macro_grid(p_blk: torch.Tensor, w_blk: torch.Tensor) -> torch.Tensor:
    """The (r x c) block of array passes on one device: each macro's
    product, summed over the block's rows."""
    return _row_sum(_macro_products(p_blk, w_blk))


def _shard(t: torch.Tensor, spec, mesh, coord: dict) -> torch.Tensor:
    """The block of ``t`` at mesh coordinate ``coord``: dimension i
    split evenly over mesh axis ``spec[i]``."""
    for dim, axis in enumerate(spec):
        size = t.shape[dim] // mesh.shape[axis]
        t = t.narrow(dim, coord[axis] * size, size)
    return t


def _gather(blocks: dict, spec, mesh, fixed: dict = None) -> torch.Tensor:
    """Put the blocks back together along ``spec``'s axes, first axis
    outermost; ``blocks`` is keyed by the coordinate over those axes."""
    fixed = fixed or {}
    dim = len(fixed)
    if dim == len(spec):
        return blocks[tuple(fixed[a] for a in spec)]
    axis = spec[dim]
    return torch.cat([_gather(blocks, spec, mesh, {**fixed, axis: i})
                      for i in range(mesh.shape[axis])], dim=dim)


def _macro_step(p_blk: torch.Tensor, w_blk: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """One super-step of the macro grid: an (r x c) block of array passes
    runs concurrently.

    p_blk (sub_r, b, g, N, K): each macro row's channel-pass patch block.
    w_blk (sub_r, sub_c, g, K, Po): each macro's weight block.
    Returns (sub_c, b, g, N, Po) — partial products summed over the grid
    rows (the shift-and-add accumulation across macro rows).

    On a ("row", "col") mesh whose axes divide (sub_r, sub_c) — and, with
    a "data" axis, whose data size divides the batch — every mesh
    coordinate takes its shards of the operands
    (`launch.sharding.macro_pass_specs`) to its device and multiplies
    them there, one product per macro; the products come back to the
    input's device and add up over the macro rows in ascending row order
    — the order of the batched step, so two runs agree bit for bit and
    the sharded step differs from the batched one by no more than its
    GEMMs do on the smaller shards; the "col" and "data" blocks are put
    back together.  The weights go to every data replica.  Otherwise the
    macro axes stay batched on the input's device."""
    if not macro_mesh_fits(mesh, p_blk.shape[0], w_blk.shape[1],
                           batch=p_blk.shape[1]):
        return _macro_grid(p_blk, w_blk)
    p_spec, w_spec, o_spec = macro_pass_specs(mesh)
    home = p_blk.device
    # launch every coordinate's products before reading any back, so the
    # devices of a real mesh work at once
    parts = {}
    for coord in mesh.coords():
        dev = mesh.device_at(coord)
        p = _shard(p_blk, p_spec, mesh, coord).to(dev)
        w = _shard(w_blk, w_spec, mesh, coord).to(dev)
        parts[tuple(coord.items())] = _macro_products(p, w)
    blocks = {}
    for coord in mesh.coords():
        if coord["row"]:
            continue
        rows = (part.to(home) for r in range(mesh.shape["row"])
                for part in parts[tuple({**coord, "row": r}.items())])
        blocks[tuple(coord[a] for a in o_spec)] = _row_sum(rows)
    return _gather(blocks, o_spec, mesh)


# ---------------------------------------------------------------------------
# Layer executor
# ---------------------------------------------------------------------------

def _tile_dims(mapping: LayerMapping, tile: TileMapping
               ) -> Tuple[int, int, int, int]:
    """(R, C, ic_pad, oc_pad) of one tile's super-step blocking — the
    sequential channel/oc super-step counts and the channel paddings
    that make every super-step a full (sub_r x sub_c) macro block."""
    sub = mapping.sub_grid
    ic_t, ar_c, oc_t, ac_c = mapping.tile_passes(tile)
    R = math.ceil(ar_c / sub.r)
    C = math.ceil(ac_c / sub.c)
    return R, C, R * sub.r * ic_t, C * sub.c * oc_t


def _tile_weights(mapping: LayerMapping, tile: TileMapping,
                  ks: torch.Tensor, R: int, C: int
                  ) -> Tuple[torch.Tensor, ...]:
    """Blocked shifted-weight matrices, one per congruent window shape:
    (R, C, sub_r, sub_c, g, K, npos*oc_t) — the row/oc blocking of the
    Fig 5 shifted-and-duplicated matrix.  Input- and batch-independent."""
    layer = mapping.layer
    s = layer.stride
    sub = mapping.sub_grid
    ic_t, _, oc_t, _ = mapping.tile_passes(tile)
    g = ks.shape[3]
    ic_pad, oc_pad = ks.shape[2], ks.shape[4]
    out = []
    for (ph, pw), _origins in placement_groups(layer, tile).items():
        py = (ph - layer.k_h) // s + 1
        px = (pw - layer.k_w) // s + 1
        npos = py * px
        K = ic_t * ph * pw
        Wm = build_weight_matrix(
            layer, ks.reshape(layer.k_h, layer.k_w, ic_pad, g * oc_pad),
            ph, pw)                                    # (ic_pad*ph*pw, ...)
        w_all = Wm.reshape(R, sub.r, K, npos, g, C, sub.c, oc_t)
        w_all = w_all.permute(0, 5, 1, 6, 4, 2, 3, 7).reshape(
            R, C, sub.r, sub.c, g, K, npos * oc_t)
        out.append(w_all)
    return tuple(out)


def _tile_operands(mapping: LayerMapping, tile: TileMapping,
                   xc: torch.Tensor, ks: Optional[torch.Tensor],
                   R: int, C: int,
                   prepared: Optional[Sequence[torch.Tensor]] = None
                   ) -> List[dict]:
    """Pass-blocked operands per congruent window shape.

    xc (b, g, ic_pad, H, W) and ks (k_h, k_w, ic_pad, g, oc_pad) are the
    tile's channel slice zero-padded to whole super-steps.  For each
    shape: patches (R, sub_r, b, g, N, K) with K = ic_t*ph*pw, and
    weights (R, C, sub_r, sub_c, g, K, npos*oc_t).  ``prepared``
    substitutes pre-materialized weight blocks (`_tile_weights` order);
    ``ks`` may then be None."""
    layer = mapping.layer
    s = layer.stride
    sub = mapping.sub_grid
    ic_t, _, _, _ = mapping.tile_passes(tile)
    b, g = xc.shape[0], xc.shape[1]
    if prepared is None:
        weights = _tile_weights(mapping, tile, ks, R, C)
    else:
        weights = tuple(prepared)
    groups = placement_groups(layer, tile)
    if len(weights) != len(groups):
        raise ValueError(f"{layer.name}: {len(weights)} prepared weight "
                         f"blocks for {len(groups)} window shapes")
    out = []
    for ((ph, pw), origins), (src, OY, OX) in zip(
            groups.items(), kept_writes(layer, tile)):
        py = (ph - layer.k_h) // s + 1
        px = (pw - layer.k_w) // s + 1
        K = ic_t * ph * pw
        flat = gather_patches(xc, origins, ph, pw)     # (b,g,N,ic_pad*ph*pw)
        n = flat.shape[2]
        p_all = flat.reshape(b, g, n, R * sub.r, K)
        p_all = p_all.permute(3, 0, 1, 2, 4).reshape(R, sub.r, b, g, n, K)
        out.append(dict(p_all=p_all, w_all=weights[len(out)],
                        src=_long(src, xc.device),
                        OY=_long(OY, xc.device), OX=_long(OX, xc.device),
                        py=py, px=px))
    return out


def _pad_kernel(kr: torch.Tensor, c_base: int, kept: int, ic_pad: int,
                oc_pad: int) -> torch.Tensor:
    """kr (k_h, k_w, ic_g, g, oc_g) -> the tile's channel slice padded to
    (k_h, k_w, ic_pad, g, oc_pad)."""
    oc_g = kr.shape[4]
    return F.pad(kr[:, :, c_base:c_base + kept],
                 (0, oc_pad - oc_g, 0, 0, 0, ic_pad - kept))


def prepared_layer_weights(mapping: LayerMapping, kernel: torch.Tensor
                           ) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Materialize one layer's blocked shifted-weight matrices from its
    kernel — per tile, per congruent window shape, in exactly the order
    :func:`mapped_conv2d` consumes them via ``weights=``.  They depend
    only on (mapping, kernel), never on the input or the batch."""
    layer = mapping.layer
    g = mapping.group
    ic_g, oc_g = layer.ic // g, layer.oc // g
    if tuple(kernel.shape) != (layer.k_h, layer.k_w, ic_g, layer.oc):
        raise ValueError(f"kernel shape {tuple(kernel.shape)} != grouped "
                         f"layout {(layer.k_h, layer.k_w, ic_g, layer.oc)}")
    kr = kernel.reshape(layer.k_h, layer.k_w, ic_g, g, oc_g)
    out = []
    c_base = 0
    for tile in mapping.tiles:
        kept = tile.depth
        R, C, ic_pad, oc_pad = _tile_dims(mapping, tile)
        ks = _pad_kernel(kr, c_base, kept, ic_pad, oc_pad)
        out.append(_tile_weights(mapping, tile, ks, R, C))
        c_base += kept + tile.pruned_channels
    return tuple(out)


def mapped_conv2d(mapping: LayerMapping, x: torch.Tensor,
                  kernel: Optional[torch.Tensor], *, mesh=None,
                  weights=None) -> torch.Tensor:
    """Execute one layer macro-parallel, asserting the executed schedule
    matches the mapping's cycle count.  Same layout contract as
    :func:`cim_conv2d`: x (batch, ic, i_h, i_w) pre-padded, kernel
    (k_h, k_w, ic // G, oc) grouped HWIO, output (batch, oc, o_h, o_w);
    pruned channels are skipped.  ``weights`` substitutes this layer's
    pre-materialized blocks (:func:`prepared_layer_weights`); ``kernel``
    may then be None.  ``mesh`` runs every super-step over that device
    mesh where it fits the sub-grid and the batch (:func:`_macro_step`);
    the output lies on ``x``'s device either way."""
    check_steps(mapping)
    layer = mapping.layer
    b = x.shape[0]
    o_h, o_w = layer.o_h, layer.o_w
    g = mapping.group
    ic_g, oc_g = layer.ic // g, layer.oc // g
    if weights is None:
        if tuple(kernel.shape) != (layer.k_h, layer.k_w, ic_g, layer.oc):
            raise ValueError(f"kernel shape {tuple(kernel.shape)} != "
                             f"grouped layout "
                             f"{(layer.k_h, layer.k_w, ic_g, layer.oc)}")
        kr = kernel.reshape(layer.k_h, layer.k_w, ic_g, g, oc_g)
        w_dtype = kernel.dtype
    else:
        if len(weights) != len(mapping.tiles):
            raise ValueError(f"{layer.name}: {len(weights)} prepared "
                             f"weight tiles for {len(mapping.tiles)}")
        kr = None
        w_dtype = weights[0][0].dtype

    # all groups are congruent: the group axis batches the gr*gc-parallel
    # groups; sequential group rounds only multiply the step count
    xr = x.reshape(b, g, ic_g, layer.i_h, layer.i_w)
    out = x.new_zeros((b, g, oc_g, o_h, o_w),
                      dtype=torch.promote_types(x.dtype, w_dtype))

    sub = mapping.sub_grid
    c_base = 0
    for ti, tile in enumerate(mapping.tiles):
        kept = tile.depth
        oc_t = mapping.tile_passes(tile)[2]
        R, C, ic_pad, oc_pad = _tile_dims(mapping, tile)
        xc = F.pad(xr[:, :, c_base:c_base + kept],
                   (0, 0, 0, 0, 0, ic_pad - kept))
        ks = None if weights is not None else _pad_kernel(
            kr, c_base, kept, ic_pad, oc_pad)
        shapes = _tile_operands(mapping, tile, xc, ks, R, C,
                                prepared=None if weights is None
                                else weights[ti])

        acc = x.new_zeros((b, g, oc_pad, o_h, o_w), dtype=out.dtype)
        soc = sub.c * oc_t                   # oc columns per super-step
        for ri in range(R):
            # one channel super-step: set semantics within it (every
            # window writes this step's full partial sum), accumulate
            # across steps (shift-and-add).  The oc super-steps write
            # disjoint channel slices, and within one the shapes' kept
            # writes (kept_writes) give each output position one writer
            buf = torch.zeros_like(acc)
            for ci in range(C):
                for sh in shapes:
                    res = _macro_step(sh["p_all"][ri], sh["w_all"][ri, ci],
                                      mesh)
                    py, px = sh["py"], sh["px"]
                    n = res.shape[3]
                    vals = res.reshape(sub.c, b, g, n, py, px, oc_t)
                    vals = vals.permute(1, 2, 0, 6, 3, 4, 5).reshape(
                        b, g, soc, n * py * px)
                    buf[:, :, ci * soc:(ci + 1) * soc,
                        sh["OY"], sh["OX"]] = vals.index_select(3, sh["src"])
            acc = acc + buf
        out = out + acc[:, :, :oc_g]
        # skip the tile's pruned trailing channels instead of shifting
        # the next tile's range onto them
        c_base += kept + tile.pruned_channels
    return out.reshape(b, layer.oc, o_h, o_w)


# ---------------------------------------------------------------------------
# Network forward pass — thin wrappers over the compiled-plan path
# ---------------------------------------------------------------------------

def mapped_net_apply(net: NetworkMapping, kernels: Sequence[torch.Tensor],
                     x: torch.Tensor, *, mesh=None,
                     activation=None) -> torch.Tensor:
    """Forward an entire ``NetworkMapping`` through the macro-parallel
    executor: ``compile_plan`` with every layer pinned to ``"mapped"``,
    on ``x``'s device and over ``mesh`` (compiled for ``x``'s batch when
    a mesh is given).  ``kernels[i]`` is layer i's kernel in that
    mapping's grouped layout ``(k_h, k_w, ic // G_i, oc)``."""
    from ..exec import compile_plan, execute_plan
    plan = compile_plan(net, executor_policy="mapped", device=x.device,
                        mesh=mesh,
                        batch=x.shape[0] if mesh is not None else None)
    return execute_plan(plan, kernels, x, mesh=mesh, activation=activation)


def reference_net_apply(net: NetworkMapping,
                        kernels: Sequence[torch.Tensor], x: torch.Tensor,
                        *, activation=None) -> torch.Tensor:
    """Oracle composition: the same compiled chain (glue and all),
    ``F.conv2d`` per layer (pruned channels must be zeroed in
    ``kernels``, see zero_pruned_kernels)."""
    from ..exec import compile_plan
    from ..exec.run import execute_oracle
    plan = compile_plan(net, executor_policy="reference", device=x.device)
    return execute_oracle(plan, kernels, x, activation=activation)


def zero_pruned_kernels(net: NetworkMapping,
                        kernels: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
    """Zero each tile's pruned input channels — the trailing slice of
    that tile's nominal (kept + pruned) channel range, which is exactly
    what the executors skip.  One trailing slice per *tile*: with several
    pruned tiles the pruned channels interleave with later tiles' kept
    ranges.  Returns new tensors; the inputs are left as they were."""
    out = []
    for m, k in zip(net.layers, kernels):
        k = k.clone()
        c_base = 0
        for t in m.tiles:
            c_base += t.depth
            if t.pruned_channels:
                k[:, :, c_base:c_base + t.pruned_channels, :] = 0.0
            c_base += t.pruned_channels
        out.append(k)
    return out
