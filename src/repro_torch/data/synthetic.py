"""Seeded synthetic image classification (port of
``repro/data/synthetic.py::image_task``), the offline stand-in for
MNIST/CIFAR: class prototypes low-passed by a 3x3 depthwise mean, plus
per-sample noise.

Draws come from an explicit ``torch.Generator`` on its own device; the
JAX package draws from ``jax.random``, which torch cannot replay, so the
parity tests hand both packages the reference's draws as numpy.
``TokenStream`` is not ported yet (it belongs to the LM path).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def image_task(gen: torch.Generator, *, n_train: int, n_test: int,
               size: int, channels: int, num_classes: int,
               noise: float = 0.6) -> Tuple[torch.Tensor, ...]:
    """(xs, ys, xt, yt): ``n_train`` / ``n_test`` images (N, channels,
    size, size) f32 and int64 labels, on ``gen``'s device."""
    dev = gen.device
    protos = torch.randn((num_classes, channels, size, size), generator=gen,
                         device=dev)
    # low-pass the prototypes for spatial structure
    kernel = torch.full((channels, 1, 3, 3), 1.0 / 9.0, device=dev)
    protos = F.conv2d(protos, kernel, padding=1, groups=channels)

    def make(n):
        y = torch.randint(0, num_classes, (n,), generator=gen, device=dev)
        x = protos[y] + noise * torch.randn((n, channels, size, size),
                                            generator=gen, device=dev)
        return x, y

    xs, ys = make(n_train)
    xt, yt = make(n_test)
    return xs, ys, xt, yt
