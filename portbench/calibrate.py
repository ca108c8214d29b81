"""Readings that set a cell's limit, on the chip, in one process: the
program's check on many seeds, the TF32 control on the same inputs, and
planted faults.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2] \
        [--out <file.jsonl>]

Each reading is a run of the cell (``harness.run_cell``, a short window
at the cell's own sizes) on a seed: ``program`` as the benchmark runs
it; ``control_tf32`` with the reference in TF32 in the program's place,
on the same weights and inputs; and the faults, planted under the timed
forward: ``stale`` (a forward hands back the previous batch's output),
``half_batch`` (the second half of the rows left out, the mean of the
first half put in their place) and ``altered`` (one value of each
output moved by 1 % of max |y|).  The benchmark's own runs run none of
these."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.run import ROOT, _environment  # noqa: E402


def stale(forward):
    prev = {}

    def wrapped(x):
        y = forward(x)
        out = prev.get("y", y)
        prev["y"] = y
        return out
    return wrapped


def half_batch(forward):
    def wrapped(x):
        y = forward(x).clone()
        h = max(1, y.shape[0] // 2)
        y[h:] = y[:h].mean(dim=0, keepdim=True)
        return y
    return wrapped


def altered(forward):
    def wrapped(x):
        y = forward(x).clone()
        j = random.Random(y.numel()).randrange(y.numel())
        y.view(-1)[j] += 0.01 * y.abs().max()
        return y
    return wrapped


FAULTS = {"stale": stale, "half_batch": half_batch, "altered": altered}


def control(bench, name: str, seed: int, device):
    """A ``forward_wrap`` putting the reference, in TF32, in the
    program's place, on the weights ``seed`` gives the cell."""
    import torch
    from portbench import harness, reference
    cell = bench.cell(name)
    cfg, traffic = bench.config(cell), bench.traffic(cell)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kernels = harness.make_kernels(cfg, traffic, gen, device)

    def wrap(_forward):
        return lambda x: reference.forward(cfg, traffic, kernels, x,
                                           precision="tf32")
    return wrap


def _ints(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from portbench import harness
    dev = torch.device("cuda", 0)
    bench = harness.Bench.load(ROOT)
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control_tf32", s, control(bench, args.workload, s, dev))
             for s in args.control_seeds]
    runs += [("fault_" + name, s, wrap) for s in args.fault_seeds
             for name, wrap in FAULTS.items()]
    with (open(args.out, "a") if args.out else contextlib.nullcontext()
          ) as out:
        for kind, seed, wrap in runs:
            r = harness.run_cell(bench, args.workload, seed, args.seconds,
                                 False, dev, time.perf_counter(),
                                 forward_wrap=wrap)
            line = json.dumps({"workload": args.workload, "kind": kind,
                               "seed": seed, "value": r.check.value,
                               "readings": r.check.readings,
                               "batches": r.attempted,
                               "device": r.device})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
            torch.cuda.empty_cache()
    print(json.dumps({"seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
