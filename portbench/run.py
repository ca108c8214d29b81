"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers compared with the reference, each beside its
limit, are the last lines of standard error.  Exits with 2 and prints no
result without a CUDA device (or with fewer than the cell asks for), and
with 1 where the run fails: a forbidden module loaded, a mapping that
differs from the configuration's pins, the program missing."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / "cache"


def _environment() -> None:
    """Fixed cache directories inside the checkout, and the program and
    the benchmark importable."""
    os.environ["REPRO_MAPPING_CACHE"] = str(CACHE / "mapping")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from portbench import harness

    try:
        bench = harness.Bench.load(ROOT)
        cell = bench.cell(args.workload)
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA devices, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        result = harness.run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  torch.device("cuda", 0), T0)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 1
    found = harness.forbidden_modules()
    if found:
        print("refused: loaded by the run: " + ", ".join(found),
              file=sys.stderr)
        return 1
    sys.stdout.flush()
    print(f"rel_err {result.check.value!r} limit {result.limit!r} "
          f"(max |y - ref| / max |ref| over {len(result.check.readings)} "
          f"batches: {result.check.readings})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result.line()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
