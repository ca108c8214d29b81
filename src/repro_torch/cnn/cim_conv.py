"""Execute a convolution *exactly as a LayerMapping prescribes*: the
``reference`` executor (port of ``repro/cnn/cim_conv.py``).

Every array load of the mapping becomes one (patch-vector @ mapped-weight-
matrix) product: the weight matrix is the shifted-and-duplicated kernel
layout of Fig 5 (rows = window pixels x channel tile, columns = kernel
position x output channel), built by :func:`build_weight_matrix`.  Summing
partial products over channel loads and scattering per-position outputs
reconstructs the OFM against ``F.conv2d`` up to float summation order.

Overlap semantics: border-clamped (ceil-form) and marginal windows may
recompute output positions already produced by a neighbouring window of
the same channel pass; recomputed values are equal up to rounding, so
each tile writes into its own buffer with *set* semantics, and buffers
accumulate across tiles (the partial-sum adds of the shift-and-add
peripheral, Fig 3).  Placements are batched: all window loads of one
shape are gathered into one stacked patch tensor and hit the weight
matrix as one batched matmul, followed by one scatter.

Every output position has exactly one writer (:func:`kept_writes`): the
last window of the tile's placement order that produces it, which is
the value a sequential set-semantics scatter leaves.  A scatter with
duplicate indices would hand the full output gradient to every writer
(``index_put_``'s backward), and on CUDA it has no defined winner.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import ConvLayerSpec, LayerMapping, TileMapping


def window_placements(layer: ConvLayerSpec, tile: TileMapping
                      ) -> List[Tuple[int, int, int, int]]:
    """(y, x, pw_h, pw_w) for every window load of a tile: the regular
    floor-grid, then Alg 4 marginal windows (or, for ceil-form baselines,
    border-clamped overhang windows)."""
    s = layer.stride
    w, k_w, k_h = tile.window, layer.k_w, layer.k_h
    step_x = ((w.pw_w - k_w) // s + 1) * s
    step_y = ((w.pw_h - k_h) // s + 1) * s

    n_x = (layer.i_w - w.pw_w) // step_x + 1
    n_y = (layer.i_h - w.pw_h) // step_y + 1
    ceil_x = math.ceil(((layer.i_w - k_w) // s + 1) / (step_x // s))
    ceil_y = math.ceil(((layer.i_h - k_h) // s + 1) / (step_y // s))

    # border clamps must stay on the stride grid so in-window kernel
    # positions align with the global output raster
    def clamp(v: int, limit: int) -> int:
        return min(v, (limit // s) * s)

    out: List[Tuple[int, int, int, int]] = []
    use_ceil = not tile.marginals
    nx, ny = (ceil_x, ceil_y) if use_ceil else (n_x, n_y)
    for iy in range(ny):
        for ix in range(nx):
            y = clamp(iy * step_y, layer.i_h - w.pw_h)
            x = clamp(ix * step_x, layer.i_w - w.pw_w)
            out.append((y, x, w.pw_h, w.pw_w))

    for mw in tile.marginals:
        if mw.edge == "w":          # right strip
            x = clamp(layer.i_w - mw.mw_w, layer.i_w - mw.mw_w)
            step = ((mw.mw_h - k_h) // s + 1) * s
            for i in range(mw.count):
                y = clamp(i * step, layer.i_h - mw.mw_h)
                out.append((y, x, mw.mw_h, mw.mw_w))
        else:                        # bottom strip
            y = clamp(layer.i_h - mw.mw_h, layer.i_h - mw.mw_h)
            step = ((mw.mw_w - k_w) // s + 1) * s
            for i in range(mw.count):
                x = clamp(i * step, layer.i_w - mw.mw_w)
                out.append((y, x, mw.mw_h, mw.mw_w))
    return out


def placement_groups(layer: ConvLayerSpec, tile: TileMapping
                     ) -> Dict[Tuple[int, int], np.ndarray]:
    """Window placements grouped by congruent shape: {(pw_h, pw_w) ->
    (N, 2) int array of (y, x) origins}.  All N loads of one shape share
    one weight matrix and execute as one batched matmul."""
    groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for (y, x, ph, pw) in window_placements(layer, tile):
        groups.setdefault((ph, pw), []).append((y, x))
    return {shape: np.asarray(org, np.int32)
            for shape, org in groups.items()}


def gather_patches(xc: torch.Tensor, origins: np.ndarray, ph: int, pw: int
                   ) -> torch.Tensor:
    """Stack every congruent placement of one window shape in one gather:
    xc (..., C, H, W), origins (N, 2) of (y, x) -> (..., N, C*ph*pw).
    Row order is channel-major (channel, y, x) — the row order of
    :func:`build_weight_matrix`, so the result multiplies it directly."""
    ys, xs = origins[:, 0], origins[:, 1]
    Y = ys[:, None, None] + np.arange(ph)[None, :, None]   # (N, ph, 1)
    X = xs[:, None, None] + np.arange(pw)[None, None, :]   # (N, 1, pw)
    Y = torch.as_tensor(Y, dtype=torch.long, device=xc.device)
    X = torch.as_tensor(X, dtype=torch.long, device=xc.device)
    p = xc[..., Y, X]                                      # (..., C, N, ph, pw)
    p = torch.movedim(p, -4, -3)                           # (..., N, C, ph, pw)
    return p.reshape(*p.shape[:-3], -1)


def scatter_indices(origins: np.ndarray, py: int, px: int, stride: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Output-raster indices of every placement's (py x px) output tile:
    (OY, OX) broadcastable to (N, py, px); overlapping windows recompute
    some positions (:func:`kept_writes` keeps one writer of each)."""
    ys, xs = origins[:, 0], origins[:, 1]
    OY = (ys // stride)[:, None, None] + np.arange(py)[None, :, None]
    OX = (xs // stride)[:, None, None] + np.arange(px)[None, None, :]
    return OY, OX


@functools.lru_cache(maxsize=None)
def kept_writes(layer: ConvLayerSpec, tile: TileMapping
                ) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], ...]:
    """One writer per output position across all of a tile's window
    shapes, in :func:`placement_groups` order.  Per shape: ``(src, OY,
    OX)`` — the kept flat indices into that shape's (N, py, px) outputs
    and their output-raster rows and columns.  The last write of each
    position is kept, so a forward equals the sequential set-semantics
    scatter, and every position's gradient reaches one writer."""
    s = layer.stride
    per_shape = []
    for (ph, pw), origins in placement_groups(layer, tile).items():
        py = (ph - layer.k_h) // s + 1
        px = (pw - layer.k_w) // s + 1
        OY, OX = scatter_indices(origins, py, px, s)
        OY, OX = np.broadcast_arrays(OY, OX)
        per_shape.append((OY.reshape(-1), OX.reshape(-1)))
    flat = np.concatenate([oy * layer.o_w + ox for oy, ox in per_shape])
    # last occurrence of each position: first occurrence in reverse
    _, first_rev = np.unique(flat[::-1], return_index=True)
    keep = np.zeros(flat.size, bool)
    keep[flat.size - 1 - first_rev] = True
    out, base = [], 0
    for oy, ox in per_shape:
        k = keep[base:base + oy.size]
        src = np.flatnonzero(k)
        out.append((src, oy[k], ox[k]))
        base += oy.size
    return tuple(out)


def _long(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.long, device=device)


def build_weight_matrix(layer: ConvLayerSpec, kernel: torch.Tensor,
                        pw_h: int, pw_w: int) -> torch.Tensor:
    """Shifted-and-duplicated kernel matrix for one window shape (Fig 5).

    kernel: (k_h, k_w, ic_t, oc_t) slice ->
    matrix: (ic_t * pw_h * pw_w, n_pos * oc_t); rows are channel-major
    window pixels, columns enumerate (position, oc).  Built as a single
    scatter — every (position, kernel-pixel) destination is distinct
    (one position index ``p`` per column block, and within it the kernel
    pixels land on distinct window pixels), so its backward is exact.
    """
    s = layer.stride
    k_h, k_w = layer.k_h, layer.k_w
    ic_t, oc_t = kernel.shape[2], kernel.shape[3]
    py = (pw_h - k_h) // s + 1
    px = (pw_w - k_w) // s + 1
    kt = kernel.permute(2, 0, 1, 3)            # (ic_t, k_h, k_w, oc_t)

    iy, ix = np.divmod(np.arange(py * px), px)
    ys = (iy * s)[:, None, None] + np.arange(k_h)[None, :, None]  # (P,kh,1)
    xs = (ix * s)[:, None, None] + np.arange(k_w)[None, None, :]  # (P,1,kw)
    p = np.arange(py * px)[:, None, None]
    dev = kernel.device
    W = kernel.new_zeros((ic_t, pw_h, pw_w, py * px, oc_t))
    W[:, _long(ys, dev), _long(xs, dev), _long(p, dev), :] = \
        kt[:, None].expand(ic_t, py * px, k_h, k_w, oc_t)
    return W.reshape(ic_t * pw_h * pw_w, py * px * oc_t)


def cim_conv2d(mapping: LayerMapping, x: torch.Tensor,
               kernel: torch.Tensor) -> torch.Tensor:
    """Convolve per the mapping (placement-batched).

    x: (batch, ic, i_h, i_w) pre-padded; kernel in grouped HWIO layout
    (k_h, k_w, ic // G, oc) with G = mapping.group.  Returns
    (batch, oc, o_h, o_w).  Pruned channels — the trailing slice of each
    tile's channel range — are skipped; callers comparing against an
    exact conv must zero the corresponding kernel slices
    (zero_pruned_kernels)."""
    layer = mapping.layer
    s = layer.stride
    b = x.shape[0]
    o_h, o_w = layer.o_h, layer.o_w
    g = mapping.group
    ic_g, oc_g = layer.ic // g, layer.oc // g
    if tuple(kernel.shape) != (layer.k_h, layer.k_w, ic_g, layer.oc):
        raise ValueError(f"kernel shape {tuple(kernel.shape)} != grouped "
                         f"layout {(layer.k_h, layer.k_w, ic_g, layer.oc)}")

    # all G groups are congruent (same tiles, same placements): expose the
    # group axis once and batch it through every gather/matmul/scatter
    xr = x.reshape(b, g, ic_g, layer.i_h, layer.i_w)
    kr = kernel.reshape(layer.k_h, layer.k_w, ic_g, g, oc_g)
    out = x.new_zeros((b, g, oc_g, o_h, o_w),
                      dtype=torch.result_type(x, kernel))

    c_base = 0
    for tile in mapping.tiles:
        kept = tile.depth            # TileMapping.depth is the KEPT channels
        xc = xr[:, :, c_base:c_base + kept]     # (b, g, kept, i_h, i_w)
        ks = kr[:, :, c_base:c_base + kept]     # (kh, kw, kept, g, oc_g)
        buf = torch.zeros_like(out)
        writes = kept_writes(layer, tile)
        for ((ph, pw), origins), (src, OY, OX) in zip(
                placement_groups(layer, tile).items(), writes):
            # the tile's (ic_t x oc_t) array loads batch into ONE matmul
            # per group: channel passes stack along the contraction rows,
            # oc passes concatenate along columns
            Wm = build_weight_matrix(
                layer, ks.reshape(layer.k_h, layer.k_w, kept, g * oc_g),
                ph, pw)
            py = (ph - layer.k_h) // s + 1
            px = (pw - layer.k_w) // s + 1
            Wm = Wm.reshape(kept * ph * pw, py * px, g, oc_g)
            Wm = Wm.permute(2, 0, 1, 3).reshape(
                g, kept * ph * pw, py * px * oc_g)
            n = len(origins)
            flat = gather_patches(xc, origins, ph, pw)  # (b,g,N,kept*ph*pw)
            prod = torch.einsum("bgnr,grp->bgnp", flat, Wm)
            prod = prod.reshape(b, g, n * py * px, oc_g)
            prod = prod.permute(0, 1, 3, 2)         # (b,g,oc_g,N*py*px)
            # one writer per output position (kept_writes): recomputed
            # duplicates are dropped before the scatter
            buf[:, :, :, _long(OY, x.device), _long(OX, x.device)] = \
                prod.index_select(3, _long(src, x.device))
        out = out + buf
        # a tile's nominal channel range is kept + pruned: the pruned
        # trailing slice is skipped here, not shifted into the next tile
        c_base += tile.depth + tile.pruned_channels
    return out.reshape(b, layer.oc, o_h, o_w)


def reference_conv2d(layer: ConvLayerSpec, x: torch.Tensor,
                     kernel: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Oracle: ``F.conv2d`` on the (pre-padded) input; kernel in the same
    grouped HWIO layout cim_conv2d consumes."""
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=layer.stride,
                    groups=groups)
