"""Carry kernels across from the JAX package.

The JAX package's serving and test kernels are numpy-drawn arrays in
grouped HWIO layout ``(k_h, k_w, ic // G, oc)``.  :func:`kernels_from_numpy`
hands the same values to the port, so both packages compute the same
convolutions on the same weights."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def kernels_from_numpy(kernels: Sequence[np.ndarray],
                       device: DeviceLike = None) -> List[torch.Tensor]:
    """float32 tensors on ``device`` (default: the card), in the layout
    given — ``[np.asarray(k) for k in ks]`` of the JAX package's list."""
    dev = resolve_device(device)
    return [torch.tensor(np.asarray(k, dtype=np.float32), device=dev)
            for k in kernels]
