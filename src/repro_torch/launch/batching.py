"""Batching helpers of the serving driver (port of the fixed-mode part
of ``repro/launch/batching.py``).  The coalescer, plan ladder and the
multi-replica transport of dynamic serving are not ported yet."""
from __future__ import annotations

import numpy as np
import torch


class InputRing:
    """Device-input feeder for the steady-state serve loop.

    The JAX package re-uploads a fresh buffer per step when the program
    consumes (donates) its input.  Torch has no donation, so the one
    buffer uploaded at construction is fed to every step and
    :meth:`next` is free; ``donated`` is always False."""

    def __init__(self, x_host, *, device: torch.device):
        self.donated = False
        self._dev = torch.as_tensor(np.asarray(x_host, np.float32),
                                    device=device)

    def next(self) -> torch.Tensor:
        """The device buffer to feed this step."""
        return self._dev
