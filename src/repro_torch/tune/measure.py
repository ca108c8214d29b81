"""Measurement primitive of the autotuner: interleaved rounds + medians.

Wall-clock on a shared CI box drifts — background load that lands during
candidate A's rounds but not candidate B's would hand B the win for
free.  Every measured comparison in this repo therefore runs
*interleaved rounds* (benchmarks/plan_bench.py introduced the shape):
round r times every candidate once, in a fixed order, so slow minutes
hit all of them equally; the per-candidate score is the **median**
round, which sheds the one-off spikes the mean would keep.

This module is that shape factored into a primitive (a copy of
``repro/tune/measure.py``): the search driver
(`repro_torch.tune.search`) uses it as its only way of looking at a
clock.  The clock is injectable — `autotune(clock=...)` threads it down
here — so the search is deterministically testable with a fake timer
(tests/test_torch_tune.py runs both packages on one).

Pure stdlib on purpose: no torch, no devices — callers pass closures
that already end in their device synchronize.
"""
from __future__ import annotations

import time
from typing import Callable, List, Sequence


def median(xs: Sequence[float]) -> float:
    """Upper median of a non-empty sequence (the ``sorted[n // 2]``
    convention every benchmark in this repo reports)."""
    if not xs:
        raise ValueError("median of an empty sequence")
    return sorted(xs)[len(xs) // 2]


def interleaved_rounds(fns: Sequence[Callable], rounds: int, *,
                       warmup: int = 1) -> List[list]:
    """Call every fn once per round, in order, for ``rounds`` rounds —
    after ``warmup`` untimed calls each (compile + steady the caches).
    Returns the per-fn list of return values, one per round.  Use this
    form when the measured quantity is the fn's *result* (serve_bench's
    images/s rates); use :func:`interleaved_medians` when it is the
    fn's wall-clock."""
    if rounds < 1:
        raise ValueError(f"need >= 1 round, got {rounds}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    for fn in fns:
        for _ in range(warmup):
            fn()
    outs: List[list] = [[] for _ in fns]
    for _ in range(rounds):
        for out, fn in zip(outs, fns):
            out.append(fn())
    return outs


def interleaved_medians(fns: Sequence[Callable], rounds: int = 5, *,
                        clock: Callable[[], float] = time.perf_counter,
                        warmup: int = 1) -> List[float]:
    """Median wall-clock SECONDS per fn over ``rounds`` interleaved
    rounds (``warmup`` untimed calls each, first).  ``clock`` is the
    timer — injectable, so searches built on this are testable without
    real time (the tests drive it with a fake)."""

    def timed(fn):
        def run():
            t0 = clock()
            fn()
            return clock() - t0
        return run

    return [median(ts) for ts in
            interleaved_rounds([timed(fn) for fn in fns], rounds,
                               warmup=warmup)]
