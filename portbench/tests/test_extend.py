"""A later change adds a cell and a metric by adding files and entries
only: the harness finds them by name and runs them with no other edit."""
import json
import time

import torch

from portbench import harness

from .conftest import add_cell, cnn8_config

P50 = '''"""batch_ms_p50 (ms): the median batch."""
from portbench.stats import percentile


def read(run):
    return 1e3 * percentile(run.latencies_s, 50)
'''


def test_new_cell_and_metric_without_editing_a_file(tiny):
    root, _ = tiny
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    # a new traffic mix of an existing configuration ...
    cell = add_cell(root, dict(cnn8_config(), name="cnn8-b3"),
                    {"traffic": "eval_b3", "unit": "images", "batch": 3,
                     "ring": 3, "samples": 2}, like="cnn8.eval_b8192")
    # ... and a new per-layer metric that only this cell reports
    (root / "portbench" / "metrics" / "batch_ms_p50.py").write_text(P50)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "batch_ms_p50", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "executor loop",
                              "moves": "images_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items()
               if "__pycache__" not in p.parts)

    bench = harness.Bench.load(root)
    r = harness.run_cell(bench, cell, 11, 0.2, True, torch.device("cpu"),
                         time.perf_counter())
    assert r.correct
    assert r.metrics["batch_ms_p50"]["value"] > 0
    assert r.metrics["batch_ms_p50"]["unit"] == "ms"
    r = harness.run_cell(bench, cell, 11, 0.2, False, torch.device("cpu"),
                         time.perf_counter())
    assert set(r.metrics) == {"images_per_s", "batch_ms_p95", "setup_s"}
