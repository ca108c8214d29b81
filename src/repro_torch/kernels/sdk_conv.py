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
card: :func:`sdk_whole` reads the whole feature map from device memory,
:func:`sdk_window` stages one window patch at a time in shared memory,
double-buffered.  ``block="auto"`` picks the window kernel when the
whole-array working set exceeds the budget — the JAX package's rule,
kept so both packages resolve the same ``block`` per layer.

:func:`sdk_conv_plain` repeats the same per-(group, tile, window)
arithmetic in PyTorch.  :func:`sdk_conv` takes it only for tensors on
the CPU; for CUDA tensors it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.types import LayerMapping

#: Fallback ``block="auto"`` budget (bytes) when the environment does
#: not override it — the JAX package's VMEM budget, kept as the same
#: number so both packages pick the same block mode per layer.
DEFAULT_VMEM_BUDGET = 8 * 1024 * 1024
_VMEM_ENV_VAR = "REPRO_SDK_VMEM_BUDGET"

#: Shared memory one block may use on an H100 (232,448 bytes).
SMEM_LIMIT = 227 * 1024
#: Output elements a block should cover at least (its thread count).
_THREADS = 256
#: Blocks that fill the card about twice (132 SMs).
_TARGET_BLOCKS = 264
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
        "lim_y", "lim_x", "b_chunk", "run")]


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
    lib.sdk_conv_whole.argtypes = ptrs + [ctypes.c_void_p]
    lib.sdk_conv_whole.restype = ctypes.c_int
    lib.sdk_conv_window.argtypes = ptrs + [ctypes.c_int, ctypes.c_void_p]
    lib.sdk_conv_window.restype = ctypes.c_int
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


def _c_geom(xt: torch.Tensor, kt: torch.Tensor, g: TileGeom, b_chunk: int,
            run: int) -> SdkGeom:
    b, ic_pad, i_h, i_w = xt.shape
    return SdkGeom(b=b, ic_pad=ic_pad, i_h=i_h, i_w=i_w,
                   oc_pad=kt.shape[3], o_h=g.o_h, o_w=g.o_w, ar_c=g.ar_c,
                   ac_c=g.ac_c, ic_t=g.ic_t, oc_t=g.oc_t, k_h=g.k_h,
                   k_w=g.k_w, s=g.s, pw_h=g.pw_h, pw_w=g.pw_w, py=g.py,
                   px=g.px, step_y=g.step_y, step_x=g.step_x, nx=g.nx,
                   nw=g.nw, lim_y=g.lim_y, lim_x=g.lim_x, b_chunk=b_chunk,
                   run=run)


def _launch(fn, xt, kt, out, geom: SdkGeom, *extra) -> None:
    stream = torch.cuda.current_stream(xt.device).cuda_stream
    err = fn(ctypes.c_void_p(xt.data_ptr()), ctypes.c_void_p(kt.data_ptr()),
             ctypes.c_void_p(out.data_ptr()), ctypes.byref(geom), *extra,
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")


def whole_launch_dims(b: int, g: TileGeom) -> Tuple[int, int]:
    """(b_chunk, blocks) of the whole kernel: enough images per block to
    give it a thread per output element, up to the batch."""
    per_img = g.oc_t * g.py * g.px
    b_chunk = max(1, min(b, _THREADS // per_img))
    return b_chunk, g.steps * math.ceil(b / b_chunk)


def window_launch_dims(b: int, g: TileGeom) -> Tuple[int, int, int, int]:
    """(b_chunk, run, smem_bytes, blocks) of the window kernel.  Two patch
    slots of ``b_chunk`` images must fit the block's shared memory; a
    block walks ``run >= 2`` windows (when the raster has two) so the
    prefetch overlaps compute, longer runs only when there are more
    blocks than the card holds at once."""
    b_chunk = min(b, SMEM_LIMIT // (2 * 4 * g.patch_floats))
    if b_chunk < 1:
        raise ValueError(f"one window patch of {g.patch_floats} floats "
                         f"does not fit two shared-memory slots")
    chunks = math.ceil(b / b_chunk)
    passes = g.ar_c * g.ac_c
    run = min(g.nw, max(2, math.ceil(g.nw * passes * chunks
                                     / _TARGET_BLOCKS)))
    blocks = passes * math.ceil(g.nw / run) * chunks
    return b_chunk, run, 2 * 4 * b_chunk * g.patch_floats, blocks


def sdk_whole(xt: torch.Tensor, kt: torch.Tensor, g: TileGeom
              ) -> torch.Tensor:
    """Launch the whole kernel (replaces ``_sdk_kernel``) on one
    (group, tile); returns (ar_c, b, oc_pad, o_h, o_w).  Counts its
    launches in ``sdk_whole.launches`` and the grid steps (ci, oi, wi)
    they ran in ``sdk_whole.steps``."""
    _check_operands(xt, kt, g)
    b = xt.shape[0]
    out = torch.zeros((g.ar_c, b, kt.shape[3], g.o_h, g.o_w),
                      dtype=torch.float32, device=xt.device)
    b_chunk, _ = whole_launch_dims(b, g)
    lib = _library()
    with torch.cuda.device(xt.device):
        _launch(lib.sdk_conv_whole, xt, kt, out,
                _c_geom(xt, kt, g, b_chunk, 1))
    sdk_whole.launches += 1
    sdk_whole.steps += g.steps
    return out


def sdk_window(xt: torch.Tensor, kt: torch.Tensor, g: TileGeom
               ) -> torch.Tensor:
    """Launch the window kernel (replaces ``_sdk_kernel_blocked``) on one
    (group, tile); returns (ar_c, b, oc_pad, o_h, o_w).  Counts its
    launches in ``sdk_window.launches`` and the grid steps (ci, oi, wi)
    they ran in ``sdk_window.steps``."""
    _check_operands(xt, kt, g)
    b = xt.shape[0]
    out = torch.zeros((g.ar_c, b, kt.shape[3], g.o_h, g.o_w),
                      dtype=torch.float32, device=xt.device)
    b_chunk, run, smem, _ = window_launch_dims(b, g)
    lib = _library()
    with torch.cuda.device(xt.device):
        _launch(lib.sdk_conv_window, xt, kt, out,
                _c_geom(xt, kt, g, b_chunk, run), ctypes.c_int(smem))
    sdk_window.launches += 1
    sdk_window.steps += g.steps
    return out


sdk_whole.launches = sdk_window.launches = 0
sdk_whole.steps = sdk_window.steps = 0


def reset_counts() -> None:
    """Zero both kernels' launch and step counts."""
    for fn in (sdk_whole, sdk_window):
        fn.launches = fn.steps = 0


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
    kernels; CPU tensors take :func:`sdk_conv_plain`'s arithmetic."""
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
