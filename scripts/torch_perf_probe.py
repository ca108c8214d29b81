"""Perf probe of the port: run one cell's step on meta-backed DTensors
over a fake process group (launch.dryrun) and print its per-rank terms
on H100 constants and the top HBM, collective and FLOP contributors by
the model function that issued them (the counterpart of
scripts/perf_probe.py).  Analytic counts, not measurements.

    python scripts/torch_perf_probe.py --arch whisper_base \
        --shape decode_32k
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
ap.add_argument("--multi", action="store_true",
                help="the (2, 16, 16) pair of pods")
ap.add_argument("--top", type=int, default=14)
args = ap.parse_args()

cfg = get_config(args.arch)
shape = SHAPES[args.shape]
dims, axes = PRODUCTION[args.multi]
with dryrun.fake_group(math.prod(dims)):
    mesh = _device_mesh(dims, axes, "cpu")
    t, arg_b, _, secs = dryrun.count_cell(cfg, shape, mesh)
rt = dryrun.terms(cfg, shape, t, math.prod(dims))
coll = t.coll_bytes.get("total", 0.0)
print(f"{args.arch} {args.shape} on {'x'.join(map(str, dims))} (per rank, "
      f"H100 constants, analytic; the step ran in {secs:.1f} s on meta)")
print(f"flops/rank {t.flops / 1e12:.3f} TF | hbm/rank "
      f"{t.hbm_bytes / 1e12:.3f} TB | coll/rank {coll / 1e9:.2f} GB | "
      f"args/rank {arg_b / 1e9:.2f} GB | {t.ops} ops")
print(f"t_comp {rt.t_compute:.4f}s t_mem {rt.t_memory:.4f}s "
      f"t_coll {rt.t_coll:.4f}s ({rt.dominant})")
for title, d, unit, scale in (
        ("HBM groups", t.hbm_by_group, "TB", 1e12),
        ("collective groups", t.coll_by_group, "GB", 1e9),
        ("FLOP groups", t.flops_by_group, "TF", 1e12)):
    print(f"\n-- top {title} --")
    for g, b in sorted(d.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {b / scale:9.4f} {unit}  {g}")
