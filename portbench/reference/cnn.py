"""A chain of grouped convolutions with the inferred glue between them,
in plain PyTorch.

Between layers the carry is fitted to the next layer's padded input: 2x2
max-pooled while it is at least twice that size, then centre-padded or
centre-cropped to it.  A layer whose input channels equal the previous
one's outputs chains; one whose input equals the previous input plus its
outputs concatenates the (cropped) input with the outputs.  The
activation follows every layer."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .pins import kept_mask
from .precision import exact_f32, operand

ACTIVATIONS = {"relu": F.relu, "none": lambda y: y}
#: images per block of the reference
ROWS = 1024


def fit_spatial(x: torch.Tensor, i_h: int, i_w: int) -> torch.Tensor:
    while x.shape[-2] >= 2 * i_h and x.shape[-1] >= 2 * i_w:
        x = F.max_pool2d(x, 2, 2)
    for dim, target in ((-2, i_h), (-1, i_w)):
        d = target - x.shape[dim]
        if d > 0:
            pad = [0, 0, d // 2, d - d // 2] if dim == -2 else \
                [d // 2, d - d // 2, 0, 0]
            x = F.pad(x, pad)
        elif d < 0:
            x = x.narrow(x.ndim + dim, (-d) // 2, target)
    return x


def center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    y0 = (x.shape[-2] - h) // 2
    x0 = (x.shape[-1] - w) // 2
    return x[..., y0:y0 + h, x0:x0 + w]


def _weights(cfg: dict, kernels, precision: str):
    out = []
    for layer, k in zip(cfg["layers"], kernels):
        pin = cfg["pins"][layer["name"]]
        mask = kept_mask(pin, layer["ic"] // pin["group"], k.device)
        w = (k.float() * mask[None, None, :, None]).permute(3, 2, 0, 1)
        out.append(operand(w.contiguous(), precision))
    return out


def _chain(cfg: dict, weights, x: torch.Tensor, precision: str):
    act = ACTIVATIONS[cfg.get("activation", "none")]
    layers = cfg["layers"]
    for i, (layer, w) in enumerate(zip(layers, weights)):
        xp = fit_spatial(x, layer["i_h"], layer["i_w"])
        y = F.conv2d(operand(xp, precision), w, stride=layer["stride"],
                     groups=cfg["pins"][layer["name"]]["group"])
        y = act(y)
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if nxt is None or nxt["ic"] == layer["oc"]:
            x = y
        elif nxt["ic"] == layer["ic"] + layer["oc"]:
            x = torch.cat([center_crop(xp, y.shape[-2], y.shape[-1]), y],
                          dim=1)
        else:
            raise ValueError(f"{layer['name']} (oc {layer['oc']}) does "
                             f"not chain into {nxt['name']} "
                             f"(ic {nxt['ic']})")
    return x


def forward(cfg: dict, traffic: dict, kernels, x: torch.Tensor, *,
            precision: str = "f32") -> torch.Tensor:
    """x (B, ic, i_h, i_w) -> the last layer's (B, oc, o_h, o_w), f32,
    in blocks of :data:`ROWS` images."""
    with torch.no_grad(), exact_f32():
        weights = _weights(cfg, kernels, precision)
        return torch.cat([_chain(cfg, weights, x[i:i + ROWS].float(),
                                 precision)
                          for i in range(0, x.shape[0], ROWS)])
