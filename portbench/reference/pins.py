"""The channels a configuration's pins keep, worked out again from the
file."""
from __future__ import annotations

import torch


def kept_mask(pin: dict, ic_group: int, device) -> torch.Tensor:
    """1.0 for each input channel of one group that a tile keeps, 0.0
    for its pruned ones: tiles cover the group's channels in order, each
    its kept channels followed by its pruned ones."""
    mask = torch.zeros(ic_group, dtype=torch.float32, device=device)
    base = 0
    for kept, pruned in pin["tiles"]:
        mask[base:base + kept] = 1.0
        base += kept + pruned
    if base != ic_group:
        raise ValueError(f"pinned tiles cover {base} channels of a group "
                         f"of {ic_group}")
    return mask
