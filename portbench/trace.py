"""Reduce a ``torch.profiler`` trace (its exported Chrome trace) of the
device, and the benchmark's own host spans, to what the per-layer
metrics read.

The trace records the device only (kernels, copies, fills) and the CUDA
runtime's calls; recording every host operation would slow the host
and make the traced window read idler than an untraced one.  The host
spans are the benchmark's, timed on the host clock around its calls into
the program (:data:`HOST_SPANS`: take the next input of the ring,
dispatch the forward until its call returns, wait for the device).
They are placed on the trace's clock by the device synchronisations:
the end of each ``synchronize`` span is the end of a
``cudaDeviceSynchronize`` call in the trace (the median offset over the
run of calls whose offsets agree best; without such calls, the first
device event starts with the first dispatch).

The traced window runs from the first span's start to the last span's
end.  Device work is clipped to it; the busy time is the length of its
union.  An idle gap is a stretch of the window with no device work,
named after the host span that overlaps it most."""
from __future__ import annotations

import json
import statistics
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from .kernels import kernel_of

HOST_SPANS = ("ring", "dispatch", "synchronize")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC = "cudaDeviceSynchronize"
TOP = 10

#: (name, start, end): a host span, seconds on the host clock
Span = Tuple[str, float, float]


@dataclass
class TraceSummary:
    """What one traced window holds (seconds)."""

    window_s: float
    busy_s: float
    forwards: int
    #: device seconds by event name
    by_name: Dict[str, float] = field(default_factory=dict)
    #: device seconds by hand-written kernel (kernels.KERNELS); "other"
    #: for every other device event
    by_kernel: Dict[str, float] = field(default_factory=dict)
    #: every idle gap: (host span that overlaps it most, seconds)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:TOP]
        return {"device_ops": [[short(n), s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type, namespace noise and
    argument list, at most ``limit`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    name = name.split("(")[0].strip() or name
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _offset(events: List[dict], spans: Sequence[Span]) -> float:
    """Microseconds to add to a host time (in microseconds) to place it
    on the trace's clock."""
    syncs = sorted(e["ts"] + e["dur"] for e in events
                   if e.get("ph") == "X" and e.get("name") == SYNC)
    ends = [b * 1e6 for n, _, b in spans if n == "synchronize"]
    if ends and len(syncs) >= len(ends):
        # the profiler may add synchronisations of its own: take the run
        # of consecutive calls whose offsets agree best
        n = len(ends)
        fits = []
        for k in range(len(syncs) - n + 1):
            diffs = [s - h for s, h in zip(syncs[k:k + n], ends)]
            fits.append((max(diffs) - min(diffs), statistics.median(diffs)))
        return min(fits)[1]
    first = min((e["ts"] for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                default=None)
    starts = [a * 1e6 for n, a, _ in spans if n == "dispatch"]
    return first - starts[0] if first is not None and starts else 0.0


def summarize(events: List[dict], spans: Sequence[Span]) -> TraceSummary:
    """Reduce Chrome-trace events (``ts``/``dur`` in microseconds) and
    the host spans of the traced batches."""
    if not spans:
        raise ValueError("no host spans: the traced window ran no batch")
    off = _offset(events, spans)
    host = sorted((a * 1e6 + off, b * 1e6 + off, n) for n, a, b in spans)
    w0, w1 = host[0][0], max(b for _, b, _ in host)
    by_name: Dict[str, float] = defaultdict(float)
    by_kernel: Dict[str, float] = defaultdict(float)
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        device.append((a, b))
        by_name[e["name"]] += (b - a) * 1e-6
        by_kernel[kernel_of(e["name"]) or "other"] += (b - a) * 1e-6
    busy = _union(device)
    gaps, edge, j = [], w0, 0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            while j < len(host) and host[j][1] <= edge:
                j += 1
            best, name, k = 0.0, "between batches", j
            while k < len(host) and host[k][0] < a:
                ov = min(a, host[k][1]) - max(edge, host[k][0])
                if ov > best:
                    best, name = ov, host[k][2]
                k += 1
            gaps.append((name, (a - edge) * 1e-6))
        edge = max(edge, b)
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
        forwards=sum(1 for n, _, _ in spans if n == "synchronize"),
        by_name=dict(by_name), by_kernel=dict(by_kernel), gaps=gaps)


def load(path, spans: Sequence[Span]) -> TraceSummary:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"], spans)
