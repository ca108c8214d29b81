"""Render the port's dry-run tables from
results/torch_dryrun_{base,opt}/*.json (the counterpart of
scripts/roofline_report.py).  Every figure is a per-rank count of the
eager step on NVIDIA H100 SXM5 constants (launch/roofline.py): analytic,
not measured.

    python scripts/torch_roofline_report.py roofline [tag]  # per-cell terms
    python scripts/torch_roofline_report.py multi [tag]     # 2x16x16
    python scripts/torch_roofline_report.py compare         # base vs opt
    python scripts/torch_roofline_report.py dryrun [tag]    # run summary
    python scripts/torch_roofline_report.py status [tag]    # cell statuses
"""
import glob
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
HEADER = "per-rank counts, H100 constants, not measured"


def fmt_t(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def load(tag, mesh=None):
    recs = [json.loads(Path(p).read_text())
            for p in glob.glob(str(ROOT / "results" / tag / "*.json"))]
    recs = [r for r in recs if r["shape"] in ORDER]       # no cut cells
    if mesh:
        recs = [r for r in recs if r["mesh"] == mesh]
    recs.sort(key=lambda r: (r["arch"], ORDER[r["shape"]]))
    return recs


def roofline_table(tag="torch_dryrun_opt", mesh="16x16"):
    print(f"\n### Roofline — {tag}, mesh {mesh} ({HEADER})\n")
    print("| arch | shape | status | t_comp | t_mem | t_coll | dominant "
          "| useful/counted | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in load(tag, mesh):
        if r["status"] != "OK":
            reason = r.get("reason", r.get("error", ""))[:38]
            print(f"| {r['arch']} | {r['shape']} | {r['status']} "
                  f"({reason}) | | | | | | |")
            continue
        f = r["roofline"]
        print(f"| {r['arch']} | {r['shape']} | OK | "
              f"{fmt_t(f['t_compute'])} | {fmt_t(f['t_memory'])} | "
              f"{fmt_t(f['t_collective'])} | {f['dominant']} | "
              f"{f['useful_flops_fraction']:.3f} | "
              f"{f['roofline_fraction']:.4f} |")


def compare(mesh="16x16"):
    base = {(r["arch"], r["shape"]): r
            for r in load("torch_dryrun_base", mesh)}
    opt = {(r["arch"], r["shape"]): r
           for r in load("torch_dryrun_opt", mesh)}
    print(f"\n### Baseline vs optimized — mesh {mesh} (bound = max roofline "
          f"term, s/rank; {HEADER})\n")
    print("| arch | shape | base bound (dom) | opt bound (dom) | speedup "
          "| base frac | opt frac |")
    print("|---|---|---|---|---|---|---|")
    for key in sorted(base, key=lambda k: (k[0], ORDER[k[1]])):
        b, o = base[key], opt.get(key)
        if b["status"] != "OK" or not o or o["status"] != "OK":
            continue
        fb, fo = b["roofline"], o["roofline"]
        bb = max(fb["t_compute"], fb["t_memory"], fb["t_collective"])
        ob = max(fo["t_compute"], fo["t_memory"], fo["t_collective"])
        print(f"| {key[0]} | {key[1]} | {fmt_t(bb)} ({fb['dominant'][:4]}) "
              f"| {fmt_t(ob)} ({fo['dominant'][:4]}) | "
              f"{bb/ob if ob else 0:.2f}x | "
              f"{fb['roofline_fraction']:.4f} | "
              f"{fo['roofline_fraction']:.4f} |")


def dryrun_table(tag="torch_dryrun_opt"):
    print(f"\n### Dry-run summary — {tag} (both meshes; {HEADER})\n")
    print("| arch | shape | mesh | run_s (CPU, meta) | args GB/rank | "
          "coll GB/rank (AG/AR/RS/A2A) |")
    print("|---|---|---|---|---|---|")
    for r in load(tag):
        if r["status"] != "OK":
            continue
        c = r["collectives"]
        parts = "/".join(
            f"{c.get(k, 0)/1e9:.1f}" for k in
            ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"))
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
              f"{r.get('run_s', 0):.0f} | "
              f"{r['memory']['argument_bytes']/1e9:.2f} | {parts} |")


def status_table(tag="torch_dryrun_opt"):
    print(f"\n### Dry-run cell status — {tag} ({HEADER})\n")
    print("| arch | shape | mesh | status | run_s (CPU, meta) | note |")
    print("|---|---|---|---|---|---|")
    for r in load(tag):
        note = r.get("reason", r.get("error", ""))[:60]
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
              f"{r['status']} | {r.get('run_s', '')} | {note} |")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    tag = sys.argv[2] if len(sys.argv) > 2 else "torch_dryrun_opt"
    if which in ("roofline", "all"):
        roofline_table(tag)
    if which == "multi":
        roofline_table(tag, "2x16x16")
    if which in ("compare", "all"):
        compare()
    if which == "dryrun":
        dryrun_table(tag)
    if which == "status":
        status_table(tag)
