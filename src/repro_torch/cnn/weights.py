"""Carry kernels across from the JAX package.

The JAX package's serving and test kernels are numpy-drawn arrays in
grouped HWIO layout ``(k_h, k_w, ic // G, oc)``; a matmul layer of a
lowered transformer takes the degenerate ``(1, 1, ic // G, oc)`` in the
same layout (oc group-major).  :func:`kernels_from_numpy` hands the same
values to the port, so both packages compute the same convolutions and
matmuls on the same weights; :func:`params_from_numpy` does the same
for the trainers' parameter trees (``init_cnn``'s ``convs[i].w/b`` and
``head.w/b``, ``train_plan``'s ``{"kernels", "head"}``)."""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def kernels_from_numpy(kernels: Sequence[np.ndarray],
                       device: DeviceLike = None) -> List[torch.Tensor]:
    """float32 tensors on ``device`` (default: the card), in the layout
    given — ``[np.asarray(k) for k in ks]`` of the JAX package's list,
    conv kernels and matmul kernels alike."""
    dev = resolve_device(device)
    return [torch.tensor(np.asarray(k, dtype=np.float32), device=dev)
            for k in kernels]


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A parameter tree of numpy arrays (dicts and lists, as
    ``jax.tree.map(np.asarray, params)`` of the JAX package's trainers
    gives it) as float32 leaf tensors on ``device`` (default: the card)
    that require grad, in the same structure."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return torch.tensor(np.asarray(t, dtype=np.float32), device=dev,
                            requires_grad=True)
    return conv(tree)
