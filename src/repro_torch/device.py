"""Device resolution for the port's entry points.

Every entry point (``serve``, ``compile_plan``, the CLI) runs on
``cuda`` unless its caller asks for another device; there is no silent
CPU fallback.  The tests pass ``device="cpu"`` explicitly."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card: ``cuda`` when one is present, else a
    ``RuntimeError`` — never the CPU.  An explicit device is taken as
    given (``"cuda"`` without a card raises too)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
