"""Training entry point (port of the ``--plan-net`` path of
``repro/launch/train.py``).

``--plan-net <network>`` trains a bench network (core/networks.py)
through the plan trainer: the network is mapped as the JAX package maps
it (TetrisG-SDK on 64x64 arrays, a 2x2 macro grid), compiled to a
chained NetworkPlan, and its kernels train through `execute_plan` with
rematerialization (``--remat off|auto|<bytes>``) and gradient
accumulation (``--accum K``) — `repro_torch.cnn.train.train_plan`.  It
runs on the card unless ``--device cpu`` is given.

    python -m repro_torch.launch.train --plan-net cnn8 --remat auto \
        --steps 2 --batch 2 --accum 2 --device cpu

The language-model path (``--arch``) is not ported yet (ROADMAP.md
queue 1, item 6) and raises.
"""
from __future__ import annotations

import argparse
import time


def plan_net_mapping(name: str):
    """``name`` (a key of core/networks.py's NETWORKS) mapped as the
    plan trainer maps it."""
    from ..core import ArrayConfig, MacroGrid, map_net, networks
    return map_net(name, networks.NETWORKS[name](), ArrayConfig(64, 64),
                   "TetrisG-SDK", MacroGrid(2, 2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan-net", default=None,
                    help="train this bench network through the plan "
                         "trainer (cnn/train.train_plan)")
    ap.add_argument("--remat", default="off",
                    help="plan trainer: off | auto | <peak budget bytes>")
    ap.add_argument("--accum", type=int, default=1,
                    help="plan trainer: microbatches per optimizer step")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.plan_net is None:
        raise NotImplementedError(
            f"--arch {args.arch}: the language-model training loop is not "
            f"ported yet (ROADMAP.md queue 1, item 6); use --plan-net")
    return _plan_main(args)


def _plan_main(args):
    """The --plan-net path: map the named network and train its kernels
    through the compiled plan (module docstring).  Returns the
    `PlanTrainResult`, the per-step losses and the per-step seconds."""
    from ..cnn.train import train_plan
    from ..core import networks
    if args.plan_net not in networks.NETWORKS:
        raise SystemExit(f"unknown network {args.plan_net!r} "
                         f"(have: {sorted(networks.NETWORKS)})")
    remat = None if args.remat == "off" else (
        args.remat if args.remat == "auto" else int(args.remat))
    net = plan_net_mapping(args.plan_net)
    t0 = time.time()
    losses: list = []
    step_times: list = []
    r = train_plan(net, steps=args.steps, batch=args.batch, lr=args.lr,
                   seed=args.seed, accum=args.accum, remat=remat,
                   losses=losses, step_times=step_times, device=args.device)
    for i, lv in enumerate(losses):
        if i % 10 == 0 or i == len(losses) - 1:
            print(f"step {i + 1:>5d}  loss {lv:.4f}", flush=True)
    print(f"done: {r.steps} steps in {time.time() - t0:.1f}s; "
          f"loss {r.first_loss:.4f} -> {r.final_loss:.4f}; "
          f"peak~{r.peak_mb:.0f}MB (unremat {r.unremat_peak_mb:.0f}MB, "
          f"{r.segments} segment(s), accum={r.accum}, "
          f"donated={r.donated})")
    return r, losses, step_times


if __name__ == "__main__":
    main()
