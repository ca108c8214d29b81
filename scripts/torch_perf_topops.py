"""The top (model function, aten op) pairs of one cell's step by HBM
traffic, per rank, from the port's dry run (the counterpart of
scripts/perf_topops.py; the eager step runs every unit, so no loop
multiplier is needed).  Analytic counts, not measurements.

    python scripts/torch_perf_topops.py --arch stablelm_1_6b \
        --shape prefill_32k
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
from repro_torch.configs import get_config                     # noqa: E402
from repro_torch.launch import dryrun                          # noqa: E402
from repro_torch.launch.mesh import PRODUCTION, _device_mesh   # noqa: E402
from repro_torch.launch.shapes import SHAPES                   # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--arch", required=True)
ap.add_argument("--shape", required=True, choices=list(SHAPES))
ap.add_argument("--multi", action="store_true")
ap.add_argument("--top", type=int, default=12)
a = ap.parse_args()

cfg = get_config(a.arch)
dims, axes = PRODUCTION[a.multi]
with dryrun.fake_group(math.prod(dims)):
    mesh = _device_mesh(dims, axes, "cpu")
    t, _, _, _ = dryrun.count_cell(cfg, SHAPES[a.shape], mesh)
rows = sorted(t.by_op.items(), key=lambda kv: -kv[1][1])
print(f"{'HBM/rank':>10s} {'calls':>7s} {'FLOPs/rank':>11s}  op  (group)")
for (group, op), (calls, nbytes, flops) in rows[:a.top]:
    print(f"{nbytes / 1e12:7.3f} TB {calls:7d} {flops / 1e12:8.3f} TF  "
          f"{op:34s} ({group})")
