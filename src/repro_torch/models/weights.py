"""Carry a JAX package parameter pytree across to the port.

``jax.random`` draws cannot be replayed with a ``torch.Generator``, so
the parity tests feed both packages the JAX package's ``init_params``
draws: :func:`params_from_numpy` takes that pytree as numpy arrays, leaf
by leaf, and keeps its nesting (``embed``, ``final_norm``, ``stages`` ->
tuple of units -> dicts stacked over ``n_units``)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import ArchConfig
from .transformer import init_params


def params_from_numpy(cfg: ArchConfig, tree: Dict[str, Any],
                      device=None) -> Dict[str, Any]:
    """``tree`` (dicts and tuples of numpy arrays) as torch tensors on
    ``device``, after checking its keys, nesting and every leaf's shape
    against the port's own init for ``cfg``."""
    def convert(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                raise ValueError(f"{path or 'params'}: expected the keys "
                                 f"{sorted(want)}")
            return {k: convert(want[k], got[k], f"{path}/{k}") for k in want}
        if isinstance(want, tuple):
            if not isinstance(got, (tuple, list)) or len(got) != len(want):
                raise ValueError(f"{path}: expected a sequence of "
                                 f"{len(want)}")
            return tuple(convert(w, g, f"{path}[{i}]")
                         for i, (w, g) in enumerate(zip(want, got)))
        arr = np.array(got)             # a writable copy (JAX's are not)
        if arr.shape != tuple(want.shape):
            raise ValueError(f"{path}: shape {arr.shape} != "
                             f"{tuple(want.shape)}")
        return torch.as_tensor(arr, device=device)

    return convert(init_params(cfg, device="meta"), tree, "")
