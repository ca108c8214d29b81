"""Put a traced window's device work under the program's own spans.

The program records host spans inside its forward while
``repro_torch.tracing`` records (forward, layer, executor call,
attention stage, glue stage, hand-written kernel launch).  Each device
event of the trace (kernel, copy, fill) is joined through
``args.correlation`` to the CUDA runtime or driver call that launched
it; that call's host start goes to the innermost program span that contains
it.  The spans are placed on the trace's clock with the benchmark's own
offset (``trace._offset``: ``time.perf_counter`` and
``time.perf_counter_ns`` are one clock), refined by :func:`launch_fit`
so that each hand-written kernel's launch call falls inside its
``kernel`` span.  The device time is then summed by (the layer's
executor, the stage that launched it, hand-written or not), by layer and
by glue stage.  An idle gap keeps the benchmark span's name
(``trace.summarize``) and adds the program span the host spent most of
it in, descending from the forward: ``dispatch/blk7.w1/exec``.

The benchmark's runs do not record program spans yet: ``harness._traced``
would turn the recorder on and ``trace.summarize`` hand the spans here.
Until then this module's command runs one cell's set-up and a traced
window with the recorder on, and prints what the per-layer metrics of
:func:`metrics` would read::

    python3 -m portbench.attribution --workload <cell> --seed <n> \\
        [--seconds 2] [--out chiprun_out/<file>.json]

from the root of a checkout.  Needs a CUDA device (exits 2 without
one).  The traced forwards run on one thread; spans of other threads
are not told apart here."""
from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace
from .kernels import kernel_of

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: how far (microseconds) a kernel span's launch call may lie from it
#: on the synchronisations' placement
PAIR_US = 1000.0
TOP = 10


@dataclass
class Attribution:
    """The traced window's device work by program span (seconds, summed
    over the window's ``forwards``)."""

    #: what ``trace.summarize`` reads from the same window
    summary: trace.TraceSummary
    #: device seconds of every event in the window
    device_s: float = 0.0
    #: (layer executor, stage kind, hand-written) -> device seconds; the
    #: stage is the innermost span other than a kernel launch ("forward"
    #: or "layer" where no stage span encloses the launch)
    by_stage: Dict[Tuple[Optional[str], str, bool], float] = field(
        default_factory=dict)
    #: layer name -> device seconds
    by_layer: Dict[str, float] = field(default_factory=dict)
    #: glue stage name (fit, layernorm, act, carry) -> device seconds
    by_glue: Dict[str, float] = field(default_factory=dict)
    #: device seconds whose launch no program span contains
    unclaimed_s: float = 0.0
    #: host seconds inside ``kernel`` spans, and their count
    kernel_host_s: float = 0.0
    launches: int = 0
    #: every idle gap: (benchmark span/program span, seconds)
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    #: max - min of the matched synchronisation offsets (microseconds)
    clock_residual_us: Optional[float] = None
    #: what :func:`launch_fit` added to that offset to place the program
    #: spans (microseconds), and the share of kernel spans that then
    #: hold the launch call of their kernel
    clock_shift_us: float = 0.0
    launch_fit_pct: Optional[float] = None

    @property
    def claimed_pct(self) -> Optional[float]:
        if self.device_s <= 0:
            return None
        return 100.0 * (1.0 - self.unclaimed_s / self.device_s)

    def stage_s(self, kind: str, executor: Optional[str] = None,
                hand_written: Optional[bool] = None) -> float:
        return sum(s for (ex, k, hw), s in self.by_stage.items()
                   if k == kind and executor in (None, ex)
                   and hand_written in (None, hw))

    def report(self) -> dict:
        layers = sorted(self.by_layer.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:TOP]
        forwards = max(self.summary.forwards, 1)
        per = 1e3 / forwards
        # idle time by the stage the host was in (the gap label's last
        # part; the benchmark span alone where no program span held it)
        idle: Dict[str, float] = defaultdict(float)
        for n, s in self.gaps:
            idle[n.rsplit("/", 1)[-1]] += s
        return {
            "claimed_pct": self.claimed_pct,
            "clock_residual_us": self.clock_residual_us,
            "clock_shift_us": self.clock_shift_us,
            "launch_fit_pct": self.launch_fit_pct,
            "launches_per_forward": self.launches / forwards,
            "stage_ms": sorted(([ex, k, hw, s * per] for (ex, k, hw), s
                                in self.by_stage.items()),
                               key=lambda r: -r[3]),
            "glue_ms": {n: s * per for n, s in sorted(self.by_glue.items())},
            "top_layers_ms": [[n, s * per] for n, s in layers],
            "idle_ms_by_stage": {k: s * per for k, s in sorted(
                idle.items(), key=lambda kv: -kv[1])},
            "idle_gaps": [[n, s] for n, s in gaps]}


def metrics(att: Attribution, unit: str) -> Dict[str, float]:
    """The per-layer metrics the spans give (ms a forward): for
    ``tokens``, ``layout_ms`` (not hand-written, launched in matmul
    executor calls and attention stages: the layout copies),
    ``glue_ms`` and ``launch_host_ms`` (host time in kernel launches);
    for ``images``, ``sdk_staging_ms`` (not hand-written, in sdk
    executor calls: pads, copies, fills, slot sums), ``reference_exec_ms``
    (all of the reference executor's calls), ``glue_ms`` and
    ``launch_host_ms``."""
    if att.summary.forwards == 0:
        return {}
    per = 1e3 / att.summary.forwards
    out = {f"glue_ms.{unit}": att.stage_s("glue") * per,
           f"launch_host_ms.{unit}": att.kernel_host_s * per}
    if unit == "tokens":
        out["layout_ms.tokens"] = per * (
            att.stage_s("exec", "matmul", False)
            + att.stage_s("attention", hand_written=False))
    elif unit == "images":
        out["sdk_staging_ms.images"] = per * att.stage_s("exec", "sdk", False)
        out["reference_exec_ms.images"] = per * att.stage_s("exec",
                                                            "reference")
    return dict(sorted(out.items()))


def clock_fit(events: List[dict], spans: Sequence[trace.Span]
              ) -> Optional[float]:
    """The spread (max - min, microseconds) of the synchronisation
    offsets ``trace._offset`` takes its median from; None where it
    matched none."""
    syncs = sorted(e["ts"] + e["dur"] for e in events
                   if e.get("ph") == "X" and e.get("name") == trace.SYNC)
    ends = [b * 1e6 for n, _, b in spans if n == "synchronize"]
    if not ends or len(syncs) < len(ends):
        return None
    n = len(ends)
    fits = []
    for k in range(len(syncs) - n + 1):
        diffs = [s - h for s, h in zip(syncs[k:k + n], ends)]
        fits.append((max(diffs) - min(diffs), statistics.median(diffs)))
    return min(fits)[0]


def launch_fit(events: List[dict], program_spans, off_us: float
               ) -> Tuple[float, Optional[float]]:
    """A finer placement of the program spans than the synchronisations
    give (their ends jitter by tens of microseconds, more than a kernel
    span lasts).  Each ``kernel`` span holds one launch call of a
    hand-written kernel; paired with the nearest such call in the trace,
    it bounds the shift to add to ``off_us`` (the call must lie inside
    the span).  Returns the middle of the shifts that satisfy the most
    pairs, and the share of kernel spans they satisfy (0.0 and None
    without kernel spans or launches of hand-written kernels)."""
    hw = {e["args"]["correlation"] for e in events
          if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS
          and "correlation" in e.get("args", {}) and kernel_of(e["name"])}
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                   and e.get("args", {}).get("correlation") in hw)
    kernels = [(s.start / 1e3 + off_us, s.end / 1e3 + off_us)
               for s in program_spans
               if s.kind == "kernel" and s.end is not None]
    if not calls or not kernels:
        return 0.0, None
    starts = [a for a, _ in calls]
    points = []
    for a, b in kernels:
        mid = (a + b) / 2
        j = bisect.bisect_left(starts, mid)
        near = min((calls[k] for k in (j - 1, j) if 0 <= k < len(calls)),
                   key=lambda c: abs(c[0] + c[1] - 2 * mid))
        lo, hi = near[1] - b, near[0] - a
        if lo <= hi and abs(near[0] + near[1] - 2 * mid) <= 2 * PAIR_US:
            points += [(lo, 0), (hi, 1)]
    best, n, stretch = 0, 0, (0.0, 0.0)
    points.sort()
    for k, (x, closes) in enumerate(points):
        n += -1 if closes else 1
        if n > best:
            best, stretch = n, (x, points[k + 1][0])
    return (stretch[0] + stretch[1]) / 2, 100.0 * best / len(kernels)


class _Tree:
    """The program spans on the trace's clock (microseconds), with the
    lookups the attribution needs."""

    def __init__(self, program_spans, off_us: float):
        spans = sorted((s for s in program_spans if s.end is not None),
                       key=lambda s: s.start)
        self.spans = spans
        self.start = [s.start / 1e3 + off_us for s in spans]
        self.end = [s.end / 1e3 + off_us for s in spans]
        index = {s.id: i for i, s in enumerate(spans)}
        self.parent = [index.get(s.parent, -1) for s in spans]
        self.children: Dict[int, List[int]] = defaultdict(list)
        for i, p in enumerate(self.parent):
            self.children[p].append(i)          # -1: the roots
        # per span: (stage kind, layer name, glue name)
        self.where = []
        for i, s in enumerate(spans):
            j = i if s.kind != "kernel" or self.parent[i] < 0 \
                else self.parent[i]
            stage = spans[j].kind
            k, layer = i, None
            while k >= 0 and layer is None:
                if spans[k].kind == "layer":
                    layer = spans[k].name
                k = self.parent[k]
            self.where.append((stage, layer,
                               spans[j].name if stage == "glue" else None))

    def innermost(self, t: float) -> int:
        """The innermost span that contains ``t``; -1 for none."""
        i = bisect.bisect_right(self.start, t) - 1
        while i >= 0 and self.end[i] < t:
            i = self.parent[i]
        return i

    def label(self, a: float, b: float) -> Optional[str]:
        """Where the host was during [a, b]: descending from the roots,
        the child that overlaps the gap most, while it overlaps more
        than its parent's own time (outside every child) does; its layer
        and kind (``blk7.w1/exec``, ``CNN8-3/glue.fit``, ``blk7.o/layer``
        for the layer's own time), or None where the gap lies mostly
        outside every span."""
        best, room = -1, b - a
        while True:
            ovs = [(min(b, self.end[c]) - max(a, self.start[c]), c)
                   for c in self.children.get(best, ())]
            ovs = [(ov, c) for ov, c in ovs if ov > 0]
            if not ovs:
                break
            most, pick = max(ovs, key=lambda t: t[0])
            if most < room - sum(ov for ov, _ in ovs):
                break
            best, room = pick, most
        if best < 0:
            return None
        s = self.spans[best]
        kind = {"glue": f"glue.{s.name}", "kernel": f"kernel.{s.name}"
                }.get(s.kind, s.kind)
        _, layer, _ = self.where[best]
        return "/".join(p for p in (layer, kind) if p)


def attribute(events: List[dict], spans: Sequence[trace.Span],
              program_spans) -> Attribution:
    """Reduce Chrome-trace events, the benchmark's host spans and the
    program's spans (``repro_torch.tracing.Span``) of one traced
    window."""
    base = trace.summarize(events, spans)
    off = trace._offset(events, spans)
    w0 = min(a for _, a, _ in spans) * 1e6 + off
    w1 = max(b for _, _, b in spans) * 1e6 + off
    shift, fit = launch_fit(events, program_spans, off)
    tree = _Tree(program_spans, off + shift)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    att = Attribution(summary=base,
                      clock_residual_us=clock_fit(events, spans),
                      clock_shift_us=shift, launch_fit_pct=fit)
    by_stage, by_layer, by_glue = (defaultdict(float), defaultdict(float),
                                   defaultdict(float))
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        device.append((a, b))
        s = (b - a) * 1e-6
        att.device_s += s
        t = launched.get(e.get("args", {}).get("correlation"))
        i = tree.innermost(t) if t is not None else -1
        if i < 0:
            att.unclaimed_s += s
            continue
        stage, layer, glue = tree.where[i]
        by_stage[(tree.spans[i].executor, stage,
                  kernel_of(e["name"]) is not None)] += s
        if layer is not None:
            by_layer[layer] += s
        if glue is not None:
            by_glue[glue] += s
    for i, sp in enumerate(tree.spans):
        if sp.kind == "kernel" and w0 <= tree.start[i] < w1:
            att.kernel_host_s += (tree.end[i] - tree.start[i]) * 1e-6
            att.launches += 1
    # the gaps as trace.summarize finds them, in its order
    busy = trace._union(device)
    edges, edge = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            edges.append((edge, a))
        edge = max(edge, b)
    if len(edges) != len(base.gaps):
        raise AssertionError(f"{len(edges)} gaps where trace.summarize "
                             f"found {len(base.gaps)}")
    for (name, g), (a, b) in zip(base.gaps, edges):
        where = tree.label(a, b)
        att.gaps.append((f"{name}/{where}" if where else name, g))
    att.by_stage, att.by_layer, att.by_glue = (dict(by_stage),
                                               dict(by_layer), dict(by_glue))
    return att


# ---------------------------------------------------------------------------
# One cell's traced window with the recorder on


def traced(forward, ring, device, seconds: float):
    """``harness._traced``'s window with the program's span recorder on:
    returns (trace events, benchmark spans, program spans)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    from . import harness
    spans: list = []
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(harness.TRACE_WARMUP):
                forward(ring[i % ring.shape[0]])
                harness.synchronize(device)
            with tracing.recording() as rec:
                harness._window(forward, ring, device, seconds, set(), spans)
            program = rec.drain()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, spans, program


def setup(root, name: str, seed: int, device):
    """A cell's forward and input ring, made as ``harness.run_cell``
    makes them, after its warm-up; returns (forward, ring, traffic)."""
    import torch

    from . import harness, program
    bench = harness.Bench.load(root)
    cell = bench.cell(name)
    cfg, traffic = bench.config(cell), bench.traffic(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mapping = program.build_mapping(cfg, traffic)
    program.check_pins(cfg, traffic, mapping)
    plan = program.compile_plan(mapping, traffic["batch"], device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kernels = harness.make_kernels(cfg, traffic, gen, device)
    ring = harness.make_ring(cfg, traffic, gen, device)
    forward = program.forward_fn(plan, kernels, cfg.get("activation", "none"))
    for i in range(harness.WARMUP):
        forward(ring[i % ring.shape[0]])
        harness.synchronize(device)
    return forward, ring, traffic


def main(argv=None) -> int:
    import argparse
    from pathlib import Path
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src")]
    os.environ.setdefault("REPRO_MAPPING_CACHE",
                          str(root / "portbench" / "cache" / "mapping"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the attribution reads the card's trace",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with torch.no_grad():
        forward, ring, traffic = setup(root, args.workload, args.seed, device)
        events, spans, prog = traced(forward, ring, device, args.seconds)
    att = attribute(events, spans, prog)
    base = att.summary
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device),
           "forwards": base.forwards, "seconds": time.perf_counter() - t0,
           "idle_pct": 100.0 * (1.0 - base.busy_s / base.window_s),
           f"torch_ops_ms.{traffic['unit']}":
               1e3 * base.by_kernel.get("other", 0.0) / base.forwards,
           "metrics": metrics(att, traffic["unit"]), **att.report()}
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
