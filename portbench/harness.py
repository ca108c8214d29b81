"""Run one cell of ``BENCHMARK.json`` once: set-up, the measured window,
the traced window (``trace=True``), the check against the plain
reference, and the result's line.

Set-up maps the configuration and compiles its plan (holding the
mapping to the configuration's pins), makes the weights and a ring of
input batches on the device from the seed, in a few large calls, and
runs :data:`WARMUP` forwards of the cell's one shape.  The window is a
closed loop with one client: each batch is one call of the compiled
forward on the next input of the ring, synchronised before it counts
as done, until ``seconds`` have passed.  A traced run then runs about
:data:`TRACE_S` more seconds of batches under ``torch.profiler``.  Once
the windows have closed and the peak memory is read, the program's
state is freed and the outputs of a sample of the window's batches,
drawn from the seed (always with the last), are compared with the
reference on the same weights and inputs."""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import random
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import counts, program, reference
from .reference.pins import kept_mask
from .trace import TraceSummary
from .trace import load as load_trace

#: forwards of set-up's warm-up (the first builds and loads the kernels)
WARMUP = 3
#: seconds of batches the traced window aims at, after
#: :data:`TRACE_WARMUP` forwards under the profiler
TRACE_S = 2.0
TRACE_WARMUP = 2
#: top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot give a result (no chip, a forbidden module, a
    mapping that differs from its pins, a cell the benchmark lacks)."""


# ---------------------------------------------------------------------------
# What BENCHMARK.json and the files beside it say


@dataclass
class Bench:
    """``BENCHMARK.json`` and the files it names, found under ``root``
    (the checkout)."""

    root: Path
    spec: dict

    @classmethod
    def load(cls, root: Path) -> "Bench":
        with open(root / "BENCHMARK.json") as f:
            return cls(root, json.load(f))

    @property
    def home(self) -> Path:
        return self.root / self.spec["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise Refused(f"BENCHMARK.json has no workload {name!r}")

    def config(self, cell: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise Refused(f"BENCHMARK.json has no config {cell['config']!r}")

    def traffic(self, cell: dict) -> dict:
        with open(self.home / "workloads" / f"{cell['name']}.json") as f:
            traffic = json.load(f)
        if (traffic["config"], traffic["traffic"]) != (cell["config"],
                                                      cell["traffic"]):
            raise Refused(f"workloads/{cell['name']}.json is "
                          f"{traffic['config']}/{traffic['traffic']}, "
                          f"BENCHMARK.json says {cell['config']}/"
                          f"{cell['traffic']}")
        return traffic

    def end_to_end(self, cell: dict) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str) -> Callable:
        """``metrics/<metric>.py``'s ``read``."""
        path = self.home / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


# ---------------------------------------------------------------------------
# What one run recorded; the metric readers read it


@dataclass
class RunRecord:
    cell: str
    config: dict
    traffic: dict
    seconds: float
    setup_s: float
    plan_s: float
    window_s: float
    #: per batch of the window: submit to synchronised, and submit to
    #: the return of the forward's call (before synchronising)
    latencies_s: List[float]
    dispatch_s: List[float]
    #: layer name -> the executor the program's plan runs it on
    executors: Dict[str, str]
    trace: Optional[TraceSummary] = None

    @property
    def batches(self) -> int:
        return len(self.latencies_s)

    @property
    def rows(self) -> int:
        return self.batches * self.traffic["batch"]

    @property
    def tokens(self) -> int:
        return self.rows * self.traffic.get("seq", 1)

    @property
    def unit(self) -> str:
        return self.traffic["unit"]

    def work(self) -> List[counts.Work]:
        return counts.forward_work(self.config, self.traffic)


# ---------------------------------------------------------------------------
# Weights and inputs, made on the device from the seed


def kernel_shapes(cfg: dict, traffic: dict):
    """(shape, std) of each mapped layer's kernel, grouped HWIO
    ``(k_h, k_w, ic // G, oc)``, std 1 / sqrt(fan-in of one group)."""
    out = []
    for _, pin, (_, _, k_h, k_w, ic, oc) in program.expected_layers(
            cfg, traffic):
        fan_in = k_h * k_w * ic // pin["group"]
        out.append(((k_h, k_w, ic // pin["group"], oc),
                    1.0 / math.sqrt(fan_in), pin))
    return out


def make_kernels(cfg: dict, traffic: dict, gen: torch.Generator,
                 device: torch.device) -> List[torch.Tensor]:
    """Every layer's kernel from one normal draw, scaled per layer, the
    pinned pruned channels zeroed."""
    shapes = kernel_shapes(cfg, traffic)
    sizes = [math.prod(s) for s, _, _ in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = []
    for (shape, std, pin), part in zip(shapes, flat.split(sizes)):
        k = part.view(shape).mul_(std)
        mask = kept_mask(pin, shape[2], device)
        if not bool(mask.all()):
            k.mul_(mask[None, None, :, None])
        out.append(k)
    return out


def input_shape(cfg: dict, traffic: dict) -> tuple:
    if cfg["kind"] == "cnn":
        i = cfg["input"]
        return (traffic["batch"], i["channels"], i["height"], i["width"])
    return (traffic["batch"], cfg["hidden_size"], traffic["seq"], 1)


def make_ring(cfg: dict, traffic: dict, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """``ring`` input batches, normal, in one draw."""
    return torch.randn((traffic["ring"],) + input_shape(cfg, traffic),
                       generator=gen, device=device)


# ---------------------------------------------------------------------------
# The run


def forbidden_modules() -> List[str]:
    """The top-level names in ``sys.modules`` that a run may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _samples(seed: int, expected: int, k: int) -> set:
    """Batch indices of the window whose outputs are kept for the
    check: the first and ``k - 1`` more drawn from the seed among the
    batches the window is expected to run (the last is added at its
    close)."""
    picks = {0}
    if expected > 1 and k > 1:
        picks |= set(random.Random(seed).sample(range(1, expected),
                                                min(k - 1, expected - 1)))
    return picks


@dataclass
class Check:
    """The comparison that decides ``correct``."""

    readings: List[float] = field(default_factory=list)
    shape_ok: bool = True

    @property
    def value(self) -> float:
        return max(self.readings) if self.readings else math.inf


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max |y - ref| / max |ref|; inf where y is not finite."""
    y = y.float()
    if not bool(torch.isfinite(y).all()):
        return math.inf
    return float((y - ref).abs().max() / ref.abs().max())


def compare(cfg: dict, traffic: dict, kernels, inputs: dict,
            outputs: dict, precision: str = "f32") -> Check:
    """Each kept output against the reference on its input."""
    check = Check()
    for i in sorted(outputs):
        ref = reference.forward(cfg, traffic, kernels, inputs[i],
                                precision=precision)
        y = outputs[i]
        if tuple(y.shape) != tuple(ref.shape):
            check.shape_ok = False
            check.readings.append(math.inf)
            continue
        check.readings.append(rel_err(y, ref))
        del ref
    return check


def _window(forward, ring: torch.Tensor, device, seconds: float,
            keep: set, spans: Optional[list] = None):
    """The closed loop; returns (latencies, dispatches, outputs kept,
    window seconds).  ``spans``, where given, gets each batch's host
    spans (``trace.Span``)."""
    lat, disp, kept = [], [], {}
    n_ring = ring.shape[0]
    i = 0
    t_start = time.perf_counter()
    while True:
        t_sub = time.perf_counter()
        x = ring[i % n_ring]
        t_ring = time.perf_counter()
        y = forward(x)
        t_disp = time.perf_counter()
        synchronize(device)
        t_done = time.perf_counter()
        lat.append(t_done - t_sub)
        disp.append(t_disp - t_ring)
        if spans is not None:
            spans += [("ring", t_sub, t_ring), ("dispatch", t_ring, t_disp),
                      ("synchronize", t_disp, t_done)]
        if i in keep:
            kept[i] = y
        last = (i, y)
        i += 1
        if t_done - t_start >= seconds:
            break
    kept[last[0]] = last[1]
    return lat, disp, kept, t_done - t_start


def _traced(forward, ring, device, seconds: float) -> TraceSummary:
    """About ``seconds`` of batches with ``torch.profiler`` recording the
    device (the host where there is no device), reduced."""
    from torch.profiler import ProfilerActivity, profile
    activity = (ProfilerActivity.CUDA if device.type == "cuda"
                else ProfilerActivity.CPU)
    spans: list = []
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[activity]) as prof:
            # the profiler's first launches carry its own start-up; the
            # window starts after them
            for i in range(TRACE_WARMUP):
                forward(ring[i % ring.shape[0]])
                synchronize(device)
            _window(forward, ring, device, seconds, set(), spans)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        return load_trace(path, spans)


@dataclass
class Result:
    correct: bool
    attempted: int
    metrics: dict
    device: dict
    check: Check
    limit: Optional[float]
    breakdown: Optional[dict] = None

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": 0, "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        value = self.check.value
        out["checks"] = {"rel_err": {
            "value": value if math.isfinite(value) else None,
            "limit": self.limit}}
        return out


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t0: float,
             forward_wrap: Optional[Callable] = None) -> Result:
    """One run of cell ``name``.  ``t0`` is the process's start on the
    ``time.perf_counter`` clock.  ``forward_wrap`` (tests only) wraps
    the timed forward, to plant a fault under it."""
    cell = bench.cell(name)
    cfg = bench.config(cell)
    traffic = bench.traffic(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_plan = time.perf_counter()
    mapping = program.build_mapping(cfg, traffic)
    try:
        program.check_pins(cfg, traffic, mapping)
    except program.PinMismatch as e:
        raise Refused(str(e)) from None
    plan = program.compile_plan(mapping, traffic["batch"], device)
    plan_s = time.perf_counter() - t_plan

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kernels = make_kernels(cfg, traffic, gen, device)
    ring = make_ring(cfg, traffic, gen, device)
    forward = program.forward_fn(plan, kernels,
                                 cfg.get("activation", "none"))
    if forward_wrap is not None:
        forward = forward_wrap(forward)

    with torch.no_grad():
        t_batch = 0.0
        for i in range(WARMUP):
            t = time.perf_counter()
            forward(ring[i % ring.shape[0]])
            synchronize(device)
            t_batch = time.perf_counter() - t
        keep = _samples(seed, max(1, int(seconds / max(t_batch, 1e-6))),
                        traffic["samples"])
        setup_s = time.perf_counter() - t0
        lat, disp, outputs, window_s = _window(forward, ring, device,
                                               seconds, keep)
        found = forbidden_modules()
        if found:
            raise Refused("loaded by the run: " + ", ".join(found))
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
        summary = (_traced(forward, ring, device, min(seconds, TRACE_S))
                   if trace else None)

    record = RunRecord(cell=name, config=cfg, traffic=traffic,
                       seconds=seconds, setup_s=setup_s, plan_s=plan_s,
                       window_s=window_s, latencies_s=lat, dispatch_s=disp,
                       executors=program.executors(plan), trace=summary)
    inputs = {i: ring[i % ring.shape[0]].clone() for i in outputs}
    del plan, mapping, forward, ring
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check = compare(cfg, traffic, kernels, inputs, outputs)
    limit = traffic["limits"]["rel_err"]
    correct = (limit is not None and check.shape_ok
               and check.value <= limit)

    metrics = {}
    wanted = bench.per_layer(cell) if trace else bench.end_to_end(cell)
    for m in wanted:
        value = bench.reader(m["name"])(record)
        if value is None:
            if not trace:
                raise Refused(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    return Result(correct=correct, attempted=record.batches,
                  metrics=metrics, device=dev, check=check, limit=limit,
                  breakdown=summary.breakdown() if summary else None)
