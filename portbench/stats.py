"""Metric arithmetic of the benchmark, kept here so that the program
cannot change it.

:func:`percentile` is a copy of ``repro_torch.launch.batching.percentile``
(nearest rank)."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty sequence."""
    if not xs:
        raise ValueError("percentile of an empty sequence")
    if not 0 <= q <= 100:
        raise ValueError(f"q must be in [0, 100], got {q}")
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q / 100 * len(s)) - 1))]


def mean(xs: Sequence[float]) -> float:
    if not xs:
        raise ValueError("mean of an empty sequence")
    return sum(xs) / len(xs)
