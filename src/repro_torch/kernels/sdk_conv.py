"""Mapping-driven SDK convolution: the ``sdk`` executor.

The port of the sdk half of ``repro/kernels/im2win_conv.py``.  For each
(group, tile) of a :class:`LayerMapping` one kernel launch enumerates the
tile's window loads ``(ci, oi, wi)`` — channel pass, oc pass, window of
the ceil-form raster — so the steps launched, summed over (group, tile),
are the mapping's cycle count (:func:`sdk_conv_cycles`).  Every step
takes a border-clamped window patch and does ``k_h*k_w`` strided
shift-matmuls against the tile's ``(ic_t x oc_t)`` kernel block, writing
the ``(b, oc_t, py, px)`` output tile into its channel pass's slot of a
leading ``ar_c`` axis that is summed afterwards (Fig 3's shift-and-add).

Two hand-written CUDA kernels (``csrc/sdk_conv.cu``) carry it on the
card, both on one block body: a block stages the tile's kernel block
(its share of the columns) and a window patch at a time in shared
memory and runs the register-tiled product of
``csrc/window_product.cuh``.  A block of :func:`sdk_whole` owns one
window (one TPU grid step); a block of :func:`sdk_window` may walk a run
of windows, double-buffering their patches.  :func:`whole_launch_dims`
and :func:`window_launch_dims` lay them out to fill the card: column
parts until a launch has about 132 blocks, and past two waves of blocks
several images a block (whole) or runs of windows first (window).
``block="auto"`` picks the window kernel when the whole-array
working set exceeds the budget — the JAX package's rule, kept so both
packages resolve the same ``block`` per layer.  Under the 8 MiB default
no served mapping of cnn8, densenet40 or inception reaches the window
kernel below batch 128; from 128, Incep-3b does.

:func:`sdk_conv_plain` repeats the same per-(group, tile, window)
arithmetic in PyTorch.  :func:`sdk_conv` takes it only for tensors on
the CPU; for CUDA tensors it launches the kernels or raises.

:func:`sdk_placed` runs the same block body on a mapping's own window
list (``cnn/cim_conv.py::placement_groups``: the regular windows, then
Alg 4's marginal strips), which the raster cannot express: one launch
per (tile, window shape), all groups in its grid, origins read from a
device table built once (:func:`placed_layer`, ``_placed_args``).
It is the ``reference`` executor's path on the card under
``no_grad``; ``cim_conv2d`` is its plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..cnn.cim_conv import placement_groups
from ..core.types import LayerMapping
from ._build import launch, no_backward, ptr
from .window_product import SMEM_LIMIT, k_groups, round4, smem_bytes

#: Fallback ``block="auto"`` budget (bytes) when the environment does
#: not override it — the JAX package's VMEM budget, kept as the same
#: number so both packages pick the same block mode per layer.
DEFAULT_VMEM_BUDGET = 8 * 1024 * 1024
_VMEM_ENV_VAR = "REPRO_SDK_VMEM_BUDGET"

#: Streaming multiprocessors of an H100: both kernels' launches aim at
#: this many blocks; past two waves the window kernel takes runs of
#: windows, the whole kernel (and then the window kernel) several images.
_SMS = 132
_TWO_WAVES = 2 * _SMS
SOURCE = "sdk_conv.cu"


def default_vmem_budget() -> int:
    """The ``block="auto"`` budget in bytes when the caller passes
    ``vmem_budget=None``: the ``REPRO_SDK_VMEM_BUDGET`` environment
    variable, else :data:`DEFAULT_VMEM_BUDGET` (8 MiB).  Read per call."""
    env = os.environ.get(_VMEM_ENV_VAR)
    if not env:
        return DEFAULT_VMEM_BUDGET
    try:
        budget = int(env)
    except ValueError:
        raise ValueError(
            f"{_VMEM_ENV_VAR}={env!r} is not an integer byte count "
            f"(suffixes like '8M' are not supported)") from None
    if budget <= 0:
        raise ValueError(f"{_VMEM_ENV_VAR}={env!r} must be > 0 "
                         f"(unset it for the {DEFAULT_VMEM_BUDGET}-byte "
                         f"default)")
    return budget


def _tile_grid(layer, tile) -> Tuple[int, int, int, int, int, int]:
    """(step_y, step_x, ny, nx, lim_y, lim_x) of a tile's ceil-form window
    raster: `n = ny*nx` border-clamped loads of the regular window shape
    cover every output position (clamps stay on the stride grid)."""
    s = layer.stride
    w = tile.window
    step_y = ((w.pw_h - layer.k_h) // s + 1) * s
    step_x = ((w.pw_w - layer.k_w) // s + 1) * s
    ny = math.ceil(((layer.i_h - layer.k_h) // s + 1) / (step_y // s))
    nx = math.ceil(((layer.i_w - layer.k_w) // s + 1) / (step_x // s))
    lim_y = ((layer.i_h - w.pw_h) // s) * s
    lim_x = ((layer.i_w - w.pw_w) // s) * s
    return step_y, step_x, ny, nx, lim_y, lim_x


def _window_origin(wi: int, *, step_y, step_x, nx, lim_y, lim_x
                   ) -> Tuple[int, int]:
    """Border-clamped (y0, x0) of window `wi` in the ceil-form raster."""
    return min((wi // nx) * step_y, lim_y), min((wi % nx) * step_x, lim_x)


def _vmem_bytes_whole(b, ic_t, oc_t, layer) -> int:
    """f32 working set of one whole-array step (the JAX package's VMEM
    estimate, which decides ``block="auto"``)."""
    return 4 * (b * ic_t * layer.i_h * layer.i_w
                + layer.k_h * layer.k_w * ic_t * oc_t
                + b * oc_t * layer.o_h * layer.o_w)


class SdkGeom(ctypes.Structure):
    """One (group, tile) launch's geometry; mirrors ``struct SdkGeom`` in
    ``csrc/sdk_conv.cu`` field for field."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "b", "ic_pad", "i_h", "i_w", "oc_pad", "o_h", "o_w",
        "ar_c", "ac_c", "ic_t", "oc_t", "k_h", "k_w", "s",
        "pw_h", "pw_w", "py", "px", "step_y", "step_x", "nx", "nw",
        "lim_y", "lim_x", "b_chunk", "run", "oc_b", "ks")]


@dataclass(frozen=True)
class TileGeom:
    """Static geometry of one tile's launch (shared by every group)."""

    s: int
    k_h: int
    k_w: int
    pw_h: int
    pw_w: int
    py: int
    px: int
    step_y: int
    step_x: int
    ny: int
    nx: int
    lim_y: int
    lim_x: int
    ic_t: int
    ar_c: int
    oc_t: int
    ac_c: int
    o_h: int
    o_w: int

    @property
    def nw(self) -> int:
        return self.ny * self.nx

    @property
    def steps(self) -> int:
        """TPU grid steps (ci, oi, wi) of this launch."""
        return self.ar_c * self.ac_c * self.nw

    @property
    def patch_floats(self) -> int:
        """f32 values of one image's window patch (ic_t, pw_h, pw_w)."""
        return self.ic_t * self.pw_h * self.pw_w

    def origin(self, wi: int) -> Tuple[int, int]:
        return _window_origin(wi, step_y=self.step_y, step_x=self.step_x,
                              nx=self.nx, lim_y=self.lim_y,
                              lim_x=self.lim_x)

    @functools.cached_property
    def covers_output(self) -> bool:
        """True when the window raster writes every output position and
        none outside ``(o_h, o_w)``: the kernels then need no zero-filled
        output.  Rows and columns of the raster are independent."""
        def covered(n_win, step, lim, tile, size):
            seen = set()
            for i in range(n_win):
                o0 = min(i * step, lim) // self.s
                seen.update(range(o0, o0 + tile))
            return seen == set(range(size))
        return (covered(self.ny, self.step_y, self.lim_y, self.py, self.o_h)
                and covered(self.nx, self.step_x, self.lim_x, self.px,
                            self.o_w))


def tile_geom(mapping: LayerMapping, tile) -> TileGeom:
    layer = mapping.layer
    s = layer.stride
    w = tile.window
    ic_t, ar_c, oc_t, ac_c = mapping.tile_passes(tile)
    step_y, step_x, ny, nx, lim_y, lim_x = _tile_grid(layer, tile)
    return TileGeom(s=s, k_h=layer.k_h, k_w=layer.k_w, pw_h=w.pw_h,
                    pw_w=w.pw_w, py=(w.pw_h - layer.k_h) // s + 1,
                    px=(w.pw_w - layer.k_w) // s + 1, step_y=step_y,
                    step_x=step_x, ny=ny, nx=nx, lim_y=lim_y, lim_x=lim_x,
                    ic_t=ic_t, ar_c=ar_c, oc_t=oc_t, ac_c=ac_c,
                    o_h=layer.o_h, o_w=layer.o_w)


def resolve_block(block: str, b: int, geom: TileGeom, layer,
                  vmem_budget: int) -> str:
    """The tiling a tile runs with: ``"whole"`` or ``"window"``
    (``"auto"`` compares the whole-array working set with the budget)."""
    if block not in ("auto", "whole", "window"):
        raise ValueError(f"unknown block mode {block!r}")
    if block != "auto":
        return block
    whole = _vmem_bytes_whole(b, geom.ic_t, geom.oc_t, layer)
    return "window" if whole > vmem_budget else "whole"


# ---------------------------------------------------------------------------
# The plain version: the kernels' arithmetic in PyTorch
# ---------------------------------------------------------------------------

def tile_plain(xt: torch.Tensor, kt: torch.Tensor, g: TileGeom,
               mode: str) -> torch.Tensor:
    """One (group, tile) in PyTorch: xt (b, ic_pad, i_h, i_w), kt
    (k_h, k_w, ic_pad, oc_pad) -> (ar_c, b, oc_pad, o_h, o_w).  Each
    window does the k_h*k_w strided shift-matmuls of every (ci, oi) pass
    at once (the oc passes are column blocks of one product).  ``mode``
    is accepted for the kernels' signature; both tilings compute the
    same thing."""
    b, ic_pad, i_h, i_w = xt.shape
    oc_pad = kt.shape[3]
    s, py, px = g.s, g.py, g.px
    xr = xt.view(b, g.ar_c, g.ic_t, i_h, i_w)
    kr = kt.view(g.k_h, g.k_w, g.ar_c, g.ic_t, oc_pad)
    out = xt.new_zeros((g.ar_c, b, oc_pad, g.o_h, g.o_w))
    for wi in range(g.nw):
        y0, x0 = g.origin(wi)
        win = xr[..., y0:y0 + g.pw_h, x0:x0 + g.pw_w]
        acc = xt.new_zeros((g.ar_c, b, oc_pad, py, px))
        for dy in range(g.k_h):
            for dx in range(g.k_w):
                patch = win[..., dy:dy + (py - 1) * s + 1:s,
                            dx:dx + (px - 1) * s + 1:s]
                acc += torch.einsum("bciyx,cio->cboyx", patch, kr[dy, dx])
        out[..., y0 // s:y0 // s + py, x0 // s:x0 // s + px] = acc
    return out


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    """The built ``csrc/sdk_conv.cu``, its C signatures declared (once)."""
    from . import _build
    lib = _build.load(SOURCE)
    ptrs = [ctypes.c_void_p] * 3 + [ctypes.POINTER(SdkGeom)]
    lib.sdk_conv_whole.argtypes = ptrs + [ctypes.POINTER(ctypes.c_int),
                                          ctypes.c_void_p]
    lib.sdk_conv_whole.restype = ctypes.c_int
    lib.sdk_conv_window.argtypes = ptrs + [ctypes.c_void_p]
    lib.sdk_conv_window.restype = ctypes.c_int
    lib.sdk_conv_placed.argtypes = ptrs + [ctypes.c_void_p] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.sdk_conv_placed.restype = ctypes.c_int
    return lib


def _check_operands(xt: torch.Tensor, kt: torch.Tensor, g: TileGeom
                    ) -> None:
    for name, t in (("x", xt), ("kernel", kt)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs "
                             f"a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}, the kernel takes f32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xt.device != kt.device:
        raise ValueError(f"x on {xt.device}, kernel on {kt.device}")
    if xt.shape[1] != g.ar_c * g.ic_t or kt.shape != (
            g.k_h, g.k_w, g.ar_c * g.ic_t, g.ac_c * g.oc_t):
        raise ValueError(f"operands {tuple(xt.shape)} / {tuple(kt.shape)} "
                         f"do not match the tile's passes")


def _c_geom(x_shape, oc_pad: int, g: TileGeom, d: "WindowLaunch"
            ) -> SdkGeom:
    """The C geometry of a launch on x of ``x_shape`` (b, ic_pad, i_h,
    i_w) into ``oc_pad`` output channels, laid out as ``d``."""
    b, ic_pad, i_h, i_w = x_shape
    return SdkGeom(b=b, ic_pad=ic_pad, i_h=i_h, i_w=i_w,
                   oc_pad=oc_pad, o_h=g.o_h, o_w=g.o_w, ar_c=g.ar_c,
                   ac_c=g.ac_c, ic_t=g.ic_t, oc_t=g.oc_t, k_h=g.k_h,
                   k_w=g.k_w, s=g.s, pw_h=g.pw_h, pw_w=g.pw_w, py=g.py,
                   px=g.px, step_y=g.step_y, step_x=g.step_x, nx=g.nx,
                   nw=g.nw, lim_y=g.lim_y, lim_x=g.lim_x, b_chunk=d.b_chunk,
                   run=d.run, oc_b=d.oc_b, ks=d.ks)


class WindowLaunch(NamedTuple):
    """How :func:`sdk_whole` or :func:`sdk_window` lays out one
    (group, tile) launch, and :func:`sdk_placed` one (tile, window
    shape)."""

    b_chunk: int   # images per block
    run: int       # consecutive windows per block (> 1: double buffer)
    oc_b: int      # of the oc_t columns per block, a multiple of 4
    ks: int        # thread groups splitting the K sum
    smem: int      # bytes of shared memory per block
    blocks: int    # blocks of the launch


def whole_launch_dims(b: int, g: TileGeom) -> WindowLaunch:
    """The whole kernel's layout: :func:`window_launch_dims` with a run of
    one window, so a block owns one TPU grid step and one patch slot, and
    past two waves it takes several images.  ``blocks`` is steps x column
    parts x image chunks."""
    return _launch_dims(b, g, runs=False)


def window_launch_dims(b: int, g: TileGeom) -> WindowLaunch:
    """The window kernel's layout.  A block starts at one window, one
    image and all ``oc_t`` columns; the columns are halved (down to 4)
    while the launch has at most half as many blocks as the card's 132
    SMs.  Past two waves a block walks a run of windows (its patch
    double-buffered), then takes several images.  Its kernel block and
    patch slots must fit 227 KB: the columns are halved further until
    they do."""
    return _launch_dims(b, g, runs=True)


def _launch_dims(b: int, g: TileGeom, runs: bool) -> WindowLaunch:
    passes = g.ar_c * g.ac_c
    k_taps = g.k_h * g.k_w
    k_steps = k_taps * round4(g.ic_t) // 4

    def parts_of(oc_b):
        return math.ceil(g.oc_t / oc_b)

    oc_b = round4(g.oc_t)
    while oc_b > 4 and 2 * passes * g.nw * b * parts_of(oc_b) <= _SMS:
        oc_b = round4(math.ceil(oc_b / 2))
    while True:
        blocks_per_image = passes * parts_of(oc_b)
        run = 1
        if runs and blocks_per_image * g.nw * b > _TWO_WAVES:
            run = min(g.nw, math.ceil(blocks_per_image * g.nw * b
                                      / _TWO_WAVES))
        per_chunk = blocks_per_image * math.ceil(g.nw / run)
        b_chunk = min(b, math.ceil(b / max(1, _TWO_WAVES // per_chunk)))
        while True:
            rows = b_chunk * g.py * g.px
            ks = k_groups(rows, oc_b, k_steps)
            smem = smem_bytes(b_chunk * g.pw_h * g.pw_w, k_taps, g.ic_t,
                              rows, oc_b, ks, 2 if run > 1 else 1)
            if smem <= SMEM_LIMIT or b_chunk == 1:
                break
            b_chunk -= 1
        if smem <= SMEM_LIMIT:
            return WindowLaunch(b_chunk, run, oc_b, ks, smem,
                                per_chunk * math.ceil(b / b_chunk))
        if oc_b == 4:
            raise ValueError(f"one window patch of {g.patch_floats} floats "
                             f"and 4 kernel columns exceed {SMEM_LIMIT} "
                             f"bytes of shared memory")
        oc_b = round4(math.ceil(oc_b / 2))


def _output(g: TileGeom, b: int, oc_pad: int, device) -> torch.Tensor:
    """The launch's (ar_c, b, oc_pad, o_h, o_w) output: uninitialised when
    the raster writes all of it, else zero-filled."""
    alloc = torch.empty if g.covers_output else torch.zeros
    return alloc((g.ar_c, b, oc_pad, g.o_h, g.o_w), dtype=torch.float32,
                 device=device)


def sdk_whole(xt: torch.Tensor, kt: torch.Tensor, g: TileGeom
              ) -> torch.Tensor:
    """Launch the whole kernel (replaces ``_sdk_kernel``) on one
    (group, tile) with :func:`whole_launch_dims`' layout; returns (ar_c,
    b, oc_pad, o_h, o_w).  Counts its launches in ``sdk_whole.launches``,
    the grid steps (ci, oi, wi) they ran in ``sdk_whole.steps`` and the
    blocks the C entry reports it launched in ``sdk_whole.blocks``."""
    no_backward("sdk_whole", xt, kt)
    _check_operands(xt, kt, g)
    b = xt.shape[0]
    out = _output(g, b, kt.shape[3], xt.device)
    blocks = ctypes.c_int(0)
    launch(_library().sdk_conv_whole, xt.device, ptr(xt, "xt"),
           ptr(kt, "kt"), ptr(out, "out"),
           ctypes.byref(_c_geom(xt.shape, kt.shape[3], g,
                                 whole_launch_dims(b, g))),
           ctypes.byref(blocks))
    sdk_whole.launches += 1
    sdk_whole.steps += g.steps
    sdk_whole.blocks += blocks.value
    return out


def sdk_window(xt: torch.Tensor, kt: torch.Tensor, g: TileGeom
               ) -> torch.Tensor:
    """Launch the window kernel (replaces ``_sdk_kernel_blocked``) on one
    (group, tile); returns (ar_c, b, oc_pad, o_h, o_w).  Counts its
    launches in ``sdk_window.launches`` and the grid steps (ci, oi, wi)
    they ran in ``sdk_window.steps``."""
    no_backward("sdk_window", xt, kt)
    _check_operands(xt, kt, g)
    b = xt.shape[0]
    out = _output(g, b, kt.shape[3], xt.device)
    launch(_library().sdk_conv_window, xt.device, ptr(xt, "xt"),
           ptr(kt, "kt"), ptr(out, "out"),
           ctypes.byref(_c_geom(xt.shape, kt.shape[3], g,
                                 window_launch_dims(b, g))))
    sdk_window.launches += 1
    sdk_window.steps += g.steps
    return out


# ---------------------------------------------------------------------------
# The placed kernel: a mapping's window list
# ---------------------------------------------------------------------------

class PlacedLaunch(NamedTuple):
    """One launch of :func:`sdk_placed`: a (tile, window shape) of
    ``placement_groups``.  ``geom`` is the shape's windows as one row of
    ``nw`` whose origins ``origins`` gives (its raster fields are 0, and
    the placed kernel reads none of them); its oc passes are the layer's
    G groups (``ac_c`` = G of ``oc_t`` = oc / G columns) and its channel
    passes one contraction of the tile's kept channels (``ar_c`` = 1,
    ``ic_t`` = the tile's depth), summed inside a block."""

    tile: int              # index in mapping.tiles: the output slot
    c_base: int            # the tile's first channel within a group
    geom: TileGeom
    origins: np.ndarray    # (nw, 2) int32 (y, x), placement order


class PlacedLayer(NamedTuple):
    """The launches of :func:`sdk_placed` on one mapping, in the order
    they run, with the window loads they stand for and whether they
    write every output position."""

    launches: Tuple[PlacedLaunch, ...]
    steps: int             # the mapping's window loads: ar_c*ac_c*nw*G
    covers_output: bool    # each tile's windows write all of (o_h, o_w)


@functools.lru_cache(maxsize=None)
def placed_layer(mapping: LayerMapping) -> PlacedLayer:
    """Tile by tile, one launch per window shape in ``placement_groups``
    order (the order ``kept_writes`` keeps the last writer of); a tile's
    pruned trailing channels are skipped.  The coverage is read from the
    placements, so an output that some tile leaves unwritten is
    zero-filled."""
    layer = mapping.layer
    s = layer.stride
    launches, steps, covered, c_base = [], 0, True, 0
    for ti, tile in enumerate(mapping.tiles):
        _, ar_c, _, ac_c = mapping.tile_passes(tile)
        seen = np.zeros((layer.o_h, layer.o_w), bool)
        for (ph, pw), origins in placement_groups(layer, tile).items():
            g = TileGeom(s=s, k_h=layer.k_h, k_w=layer.k_w, pw_h=ph,
                         pw_w=pw, py=(ph - layer.k_h) // s + 1,
                         px=(pw - layer.k_w) // s + 1, step_y=0, step_x=0,
                         ny=1, nx=len(origins), lim_y=0, lim_x=0,
                         ic_t=tile.depth, ar_c=1,
                         oc_t=layer.oc // mapping.group, ac_c=mapping.group,
                         o_h=layer.o_h, o_w=layer.o_w)
            launches.append(PlacedLaunch(ti, c_base, g, origins))
            steps += ar_c * ac_c * g.nw * mapping.group
            for y, x in origins:
                seen[y // s:y // s + g.py, x // s:x // s + g.px] = True
        covered = covered and bool(seen.all())
        c_base += tile.depth + tile.pruned_channels
    return PlacedLayer(tuple(launches), steps, covered)


@functools.lru_cache(maxsize=None)
def _placed_args(mapping: LayerMapping, b: int, device: torch.device
                 ) -> Tuple[Tuple[PlacedLaunch, SdkGeom, torch.Tensor], ...]:
    """Per launch of :func:`placed_layer`: its C geometry at batch ``b``
    (laid out by :func:`window_launch_dims`) and its origin table on
    ``device``, built once, so a warm call does no layout search and no
    host-to-device copy."""
    layer = mapping.layer
    shape = (b, layer.ic, layer.i_h, layer.i_w)
    return tuple(
        (ln, _c_geom(shape, layer.oc, ln.geom,
                     window_launch_dims(b, ln.geom)),
         torch.as_tensor(ln.origins, dtype=torch.int32, device=device))
        for ln in placed_layer(mapping).launches)


def sdk_placed(mapping: LayerMapping, x: torch.Tensor,
               kernel: torch.Tensor) -> torch.Tensor:
    """Convolve per the mapping's window list on the card.

    x (b, ic, i_h, i_w) pre-padded and kernel (k_h, k_w, ic // G, oc),
    CUDA tensors, summed in f32; returns (b, oc, o_h, o_w) in their
    result type, equal to ``cim_conv2d`` up to summation order.  One
    launch of ``sdk_placed_kernel`` per :func:`placed_layer` launch: a
    layer of one tile stores straight into its output, a layer of
    several into one slot a tile, summed after.  Counts
    ``sdk_placed.launches`` and, in ``sdk_placed.steps``, the mapping's
    window loads they ran (``mapping.cycles`` where the mapping owes no
    macro parallelism; a tile's channel passes are one contraction on
    the card).  ``sdk_placed.fallbacks`` counts the ``reference`` layers
    the card ran through ``cim_conv2d`` instead, because autograd would
    differentiate them (``exec/run.py::_layer_conv``).  No backward
    (:func:`_build.no_backward`)."""
    no_backward("sdk_placed", x, kernel)
    layer = mapping.layer
    ic_g = layer.ic // mapping.group
    if tuple(kernel.shape) != (layer.k_h, layer.k_w, ic_g, layer.oc):
        raise ValueError(f"kernel shape {tuple(kernel.shape)} != grouped "
                         f"layout {(layer.k_h, layer.k_w, ic_g, layer.oc)}")
    if tuple(x.shape[1:]) != (layer.ic, layer.i_h, layer.i_w):
        raise ValueError(f"input shape {tuple(x.shape)} != "
                         f"(b, {layer.ic}, {layer.i_h}, {layer.i_w})")
    for name, t in (("x", x), ("kernel", kernel)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs "
                             f"a CUDA tensor")
    if x.device != kernel.device:
        raise ValueError(f"x on {x.device}, kernel on {kernel.device}")
    dtype = torch.result_type(x, kernel)
    x = x.float().contiguous()
    kernel = kernel.float().contiguous()
    b = x.shape[0]
    n_tiles = len(mapping.tiles)
    placed = placed_layer(mapping)
    alloc = torch.empty if placed.covers_output else torch.zeros
    out = alloc((n_tiles, b, layer.oc, layer.o_h, layer.o_w),
                dtype=torch.float32, device=x.device)
    fn = _library().sdk_conv_placed
    for ln, geom, origins in _placed_args(mapping, b, x.device):
        launch(fn, x.device, ptr(x, "x"), ptr(kernel, "kernel"),
               ptr(out[ln.tile], "out"), ctypes.byref(geom),
               ptr(origins, "origins"), ic_g, ln.c_base)
    sdk_placed.launches += len(placed.launches)
    sdk_placed.steps += placed.steps
    return (out[0] if n_tiles == 1 else out.sum(dim=0)).to(dtype)


sdk_whole.launches = sdk_window.launches = sdk_placed.launches = 0
sdk_whole.steps = sdk_window.steps = sdk_placed.steps = 0
sdk_whole.blocks = sdk_placed.fallbacks = 0


def reset_counts() -> None:
    """Zero the three kernels' launch and step counts, the whole
    kernel's block count and the placed kernel's fall-backs."""
    for fn in (sdk_whole, sdk_window, sdk_placed):
        fn.launches = fn.steps = 0
    sdk_whole.blocks = sdk_placed.fallbacks = 0


def _tile_cuda(xt: torch.Tensor, kt: torch.Tensor, g: TileGeom,
               mode: str) -> torch.Tensor:
    return (sdk_window if mode == "window" else sdk_whole)(xt, kt, g)


# ---------------------------------------------------------------------------
# Host logic shared by the kernels and the plain version
# ---------------------------------------------------------------------------

TileFn = Callable[[torch.Tensor, torch.Tensor, TileGeom, str], torch.Tensor]


@dataclass(frozen=True)
class TileCall:
    """The operands of one (group, tile) launch."""

    group: int
    xt: torch.Tensor            # (b, ic_pad, i_h, i_w), channels padded
    kt: torch.Tensor            # (k_h, k_w, ic_pad, oc_pad), zero-padded
    geom: TileGeom
    mode: str                   # "whole" | "window"


def tile_calls(mapping: LayerMapping, x: torch.Tensor, kernel: torch.Tensor,
               block: str = "auto", vmem_budget: Optional[int] = None
               ) -> Tuple[TileCall, ...]:
    """Per (group, tile): the tile's kept channels padded to whole
    ``ic_t`` passes and the group's oc to whole ``oc_t`` passes with
    zeros, and the block mode it runs with.  A tile's pruned trailing
    channels are skipped, not shifted into the next tile's range."""
    if vmem_budget is None:
        vmem_budget = default_vmem_budget()
    layer = mapping.layer
    b = x.shape[0]
    g = mapping.group
    ic_g, oc_g = layer.ic // g, layer.oc // g
    if tuple(kernel.shape) != (layer.k_h, layer.k_w, ic_g, layer.oc):
        raise ValueError(f"kernel shape {tuple(kernel.shape)} != grouped "
                         f"layout {(layer.k_h, layer.k_w, ic_g, layer.oc)}")
    if tuple(x.shape[1:]) != (layer.ic, layer.i_h, layer.i_w):
        raise ValueError(f"input shape {tuple(x.shape)} != "
                         f"(b, {layer.ic}, {layer.i_h}, {layer.i_w})")
    x = x.float()
    kernel = kernel.float()
    geoms = [tile_geom(mapping, t) for t in mapping.tiles]
    modes = [resolve_block(block, b, gm, layer, vmem_budget)
             for gm in geoms]
    calls = []
    for gi in range(g):
        xg = x[:, gi * ic_g:(gi + 1) * ic_g]
        kg = kernel[..., gi * oc_g:(gi + 1) * oc_g]
        c_base = 0
        for tile, gm, mode in zip(mapping.tiles, geoms, modes):
            kept = tile.depth
            ic_pad, oc_pad = gm.ar_c * gm.ic_t, gm.ac_c * gm.oc_t
            xt = F.pad(xg[:, c_base:c_base + kept],
                       (0, 0, 0, 0, 0, ic_pad - kept))
            kt = F.pad(kg[:, :, c_base:c_base + kept],
                       (0, oc_pad - oc_g, 0, ic_pad - kept))
            calls.append(TileCall(gi, xt.contiguous(), kt.contiguous(), gm,
                                  mode))
            c_base += kept + tile.pruned_channels
    return tuple(calls)


def _sdk_conv(mapping: LayerMapping, x: torch.Tensor, kernel: torch.Tensor,
              tile_fn: TileFn, block: str, vmem_budget: Optional[int]
              ) -> torch.Tensor:
    """Run ``tile_fn`` on every :func:`tile_calls` entry, sum each result's
    channel-pass slots into its group, and assert that the steps run
    equal :func:`sdk_conv_cycles`."""
    layer = mapping.layer
    oc_g = layer.oc // mapping.group
    accs = [x.new_zeros((x.shape[0], oc_g, layer.o_h, layer.o_w),
                        dtype=torch.float32) for _ in range(mapping.group)]
    steps = 0
    for c in tile_calls(mapping, x, kernel, block, vmem_budget):
        res = tile_fn(c.xt, c.kt, c.geom, c.mode)
        steps += c.geom.steps
        accs[c.group] = accs[c.group] + res.sum(dim=0)[:, :oc_g]
    if steps != sdk_conv_cycles(mapping):
        raise AssertionError(f"{layer.name}: launched {steps} steps != "
                             f"sdk_conv_cycles {sdk_conv_cycles(mapping)}")
    return torch.cat(accs, dim=1)


def sdk_conv_plain(mapping: LayerMapping, x: torch.Tensor,
                   kernel: torch.Tensor, *, block: str = "auto",
                   vmem_budget: Optional[int] = None) -> torch.Tensor:
    """:func:`sdk_conv` with every tile computed by the plain PyTorch
    version, on whatever device ``x`` lies — the kernels' reference."""
    return _sdk_conv(mapping, x, kernel, tile_plain, block, vmem_budget)


def sdk_conv(mapping: LayerMapping, x: torch.Tensor, kernel: torch.Tensor,
             *, block: str = "auto",
             vmem_budget: Optional[int] = None) -> torch.Tensor:
    """Execute a convolution exactly as `mapping` prescribes.

    x (batch, ic, i_h, i_w) pre-padded, kernel (k_h, k_w, ic // G, oc) in
    grouped HWIO layout, output (batch, oc, o_h, o_w) f32; pruned channels
    are skipped.  ``block`` picks the tiling on the card: ``"whole"``
    (:func:`sdk_whole`), ``"window"`` (:func:`sdk_window`) or ``"auto"``
    (window whenever the whole-array working set exceeds ``vmem_budget``;
    ``None`` — :func:`default_vmem_budget`).  CUDA tensors launch the
    kernels; CPU tensors take :func:`sdk_conv_plain`'s arithmetic.  No
    backward (:func:`_build.no_backward`)."""
    no_backward("sdk_conv", x, kernel)
    if x.device.type == "cuda":
        tile_fn = _tile_cuda
    elif x.device.type == "cpu":
        tile_fn = tile_plain
    else:
        raise ValueError(f"sdk_conv: unsupported device {x.device}")
    return _sdk_conv(mapping, x, kernel, tile_fn, block, vmem_budget)


def sdk_conv_cycles(mapping: LayerMapping) -> int:
    """Total steps sdk_conv launches == the mapping's cycle count in the
    ceil-form convention, times the sequential group count."""
    total = 0
    for tile in mapping.tiles:
        _, _, ny, nx, _, _ = _tile_grid(mapping.layer, tile)
        _, ar_c, _, ac_c = mapping.tile_passes(tile)
        total += ar_c * ac_c * ny * nx
    return total * mapping.group
