"""The ``"matmul"`` plan executor: mapped-IR matmul layers on the matmul
kernels (port of ``repro/kernels/matmul_exec.py``).

A layer spec with ``op == "matmul"`` is the degenerate 1x1 conv
(``core.types.matmul_spec``): x carries M token positions along the
``i_h`` spatial axis and the D feature channels along the channel axis,
so the plan-level layout contract is unchanged — x ``(B, ic, M, 1)``,
kernel ``(1, 1, ic // G, oc)`` in the grouped conv layout every other
executor consumes (oc group-major, as ``F.conv2d(groups=G)``).  This
module adapts that layout onto the kernels with torch views and copies:

* ``G == 1`` — tokens flatten to one ``(B*M, D)`` operand for
  `kernels.tetris_matmul`;
* ``G > 1`` — the block-diagonal `kernels.grouped_matmul` computes
  exactly the G diagonal blocks, the paper's §III-B grouped-convolution
  win.

Like the sdk executor, this stands in for the mapped schedule: cycle
accounting stays with the ``LayerMapping`` (steps==cycles is asserted at
plan-compile time), and pruned channels follow the reference-executor
convention — zero them in the kernel; a dense matmul over zeroed rows
equals the skip.
"""
from __future__ import annotations

import torch

from .grouped_matmul import grouped_matmul
from .tetris_matmul import tetris_matmul


def _check(mapping, kernel: torch.Tensor) -> None:
    layer = mapping.layer
    if getattr(layer, "op", "conv") != "matmul":
        raise ValueError(
            f"{layer.name}: executor 'matmul' needs op='matmul' "
            f"(got op={getattr(layer, 'op', 'conv')!r})")
    d_g = layer.ic // mapping.group
    if tuple(kernel.shape) != (1, 1, d_g, layer.oc):
        raise ValueError(
            f"{layer.name}: kernel {tuple(kernel.shape)} != (1, 1, {d_g}, "
            f"{layer.oc}) — grouped conv layout, G={mapping.group}")


def matmul_layer(mapping, x: torch.Tensor,
                 kernel: torch.Tensor) -> torch.Tensor:
    """One mapped matmul layer: x (B, ic, M, 1), kernel
    (1, 1, ic//G, oc) -> (B, oc, M, 1) f32, G = ``mapping.group``."""
    _check(mapping, kernel)
    layer = mapping.layer
    g = mapping.group
    b = x.shape[0]
    m = layer.i_h
    d_g, f_g = layer.ic // g, layer.oc // g
    tok = x[..., 0]                                     # (B, ic, M)
    if g == 1:
        xm = tok.transpose(1, 2).reshape(b * m, layer.ic)
        y = tetris_matmul(xm, kernel[0, 0])
        return y.reshape(b, m, layer.oc).transpose(1, 2)[..., None]
    # channels are group-major on both sides: ic = (g, d_g) in x,
    # oc = (g, f_g) along the kernel's last axis
    xg = (tok.reshape(b, g, d_g, m).permute(1, 0, 3, 2)
          .reshape(g, b * m, d_g))
    wg = kernel[0, 0].reshape(d_g, g, f_g).transpose(0, 1)
    y = grouped_matmul(xg, wg)                          # (g, B*M, f_g)
    return (y.reshape(g, b, m, f_g).permute(1, 0, 3, 2)
            .reshape(b, layer.oc, m)[..., None])


def matmul_layer_ref(mapping, x: torch.Tensor,
                     kernel: torch.Tensor) -> torch.Tensor:
    """Einsum oracle of :func:`matmul_layer` — same layout, plain torch
    (the target of the executor equivalence tests and the oracle forward
    of ``execute_oracle``)."""
    _check(mapping, kernel)
    layer = mapping.layer
    g = mapping.group
    d_g, f_g = layer.ic // g, layer.oc // g
    tok = x[..., 0].transpose(1, 2)                     # (B, M, ic)
    xg = tok.reshape(*tok.shape[:2], g, d_g)
    wg = kernel[0, 0].reshape(d_g, g, f_g).transpose(0, 1)
    y = torch.einsum("bmgd,gdf->bmgf", xg.float(), wg.float())
    return y.reshape(*tok.shape[:2], layer.oc).transpose(1, 2)[..., None]
