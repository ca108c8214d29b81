"""``sdk_placed_roofline`` on hand-built traces: the least time of the
layers the plan runs on the ``reference`` executor over the device time
of ``sdk_placed_kernel``; nothing without a trace or without an event of
the kernel; and on the CPU's traced run of a DenseNet-40 cell, which
launches no kernel, nothing."""
import json
import time

import pytest
import torch

from portbench import counts, harness
from portbench.trace import TraceSummary

from .conftest import ROOT, add_cell

PLACED = ("void (anonymous namespace)::sdk_placed_kernel<false>"
          "((anonymous namespace)::SdkGeom, float const*)")


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _record(cfg, batch, executors, trace):
    return harness.RunRecord(
        cell="test", config=cfg, traffic={"batch": batch, "unit": "images"},
        seconds=1.0, setup_s=1.0, plan_s=0.1, window_s=1.0,
        latencies_s=[0.01], dispatch_s=[0.005], executors=executors,
        trace=trace)


def _trace(by_name, forwards=4):
    return TraceSummary(window_s=1.0, busy_s=0.5, forwards=forwards,
                        by_name=by_name, by_kernel={"other": 0.5})


@pytest.fixture(scope="module")
def read():
    return harness.Bench.load(ROOT).reader("sdk_placed_roofline")


def test_reads_the_reference_layers_over_the_kernels_time(read):
    cfg = _config("densenet40")
    executors = {ly["name"]: ("reference" if i % 3 == 0 else "sdk")
                 for i, ly in enumerate(cfg["layers"])}
    by_name = {PLACED: 0.030, PLACED.replace("<false>", "<true>"): 0.010,
               "sdk_window_kernel": 0.2, "Memcpy DtoD": 0.1}
    run = _record(cfg, 4096, executors, _trace(by_name))
    least = 4 * sum(
        counts.conv_work(ly, cfg["pins"][ly["name"]], 4096).min_seconds()
        for ly in cfg["layers"] if executors[ly["name"]] == "reference")
    assert read(run) == pytest.approx(100.0 * least / 0.040)


def test_cnn8_reads_its_one_reference_layer(read):
    cfg = _config("cnn8")
    executors = {ly["name"]: "sdk" for ly in cfg["layers"]}
    executors["CNN8-2"] = "reference"
    run = _record(cfg, 8192, executors, _trace({PLACED: 0.0058}, 4))
    w = counts.conv_work(cfg["layers"][0], cfg["pins"]["CNN8-2"], 8192)
    # CNN8-2 at batch 8192 is bound by its bytes: 0.156 ms
    assert w.min_seconds() == pytest.approx(w.bytes / counts.PEAK_HBM_BYTES_S)
    assert w.min_seconds() == pytest.approx(1.562e-4, rel=1e-3)
    assert read(run) == pytest.approx(100.0 * 4 * w.min_seconds() / 0.0058)


@pytest.mark.parametrize("case", ["no trace", "no placed event",
                                  "no reference layer", "no forward"])
def test_reads_nothing(read, case):
    cfg = _config("cnn8")
    executors = {ly["name"]: "sdk" for ly in cfg["layers"]}
    executors["CNN8-2"] = "reference"
    trace = _trace({PLACED: 0.0058, "sdk_window_kernel": 0.02})
    if case == "no trace":
        trace = None
    elif case == "no placed event":
        trace = _trace({"sdk_window_kernel": 0.02, "sdk_whole_kernel": 0.01})
    elif case == "no reference layer":
        executors["CNN8-2"] = "sdk"
    else:
        trace = _trace({PLACED: 0.0058}, forwards=0)
    assert read(_record(cfg, 8192, executors, trace)) is None


def test_densenet40_cell_on_the_cpu(tiny):
    """The configuration file run as a cell at batch 2 on the CPU:
    correct, the pins accepted; the traced run reports the host metrics
    and leaves out the roofline, as the CPU launches no kernel."""
    root, _ = tiny
    cell = add_cell(root, _config("densenet40"),
                    {"traffic": "eval_b2", "unit": "images", "batch": 2,
                     "ring": 2, "samples": 2}, like="densenet40.eval_b4096")
    bench = harness.Bench.load(root)
    assert "sdk_placed_roofline" in {m["name"]
                                     for m in bench.per_layer(
                                         bench.cell(cell))}
    r = harness.run_cell(bench, cell, 2 ** 31 + 99, 0.3, True,
                         torch.device("cpu"), time.perf_counter())
    assert r.correct and r.check.value <= 2e-5
    assert set(r.metrics) == {"plan_s", "dispatch_ms.images", "mfu.images"}
