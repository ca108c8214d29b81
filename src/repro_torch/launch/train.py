"""Training entry point (port of ``repro/launch/train.py``).

``--arch <id>`` trains a language model of the registry end to end:
config -> init on the device -> TokenStream pipeline -> train step
(microbatched, each unit recomputed in the backward) -> CheckpointStore
(async writes, the last two kept) under the TrainSupervisor (heartbeats,
straggler log, restart-exact resume with ``--resume``).  Checkpoints go
to ``--ckpt-dir``/<config name>, by default under the temporary
directory.

    python -m repro_torch.launch.train --arch stablelm_1_6b --smoke \
        --steps 4 --batch 8 --seq 64 --device cpu [--resume]

``--plan-net <network>`` trains a bench network (core/networks.py)
through the plan trainer: the network is mapped as the JAX package maps
it (TetrisG-SDK on 64x64 arrays, a 2x2 macro grid), compiled to a
chained NetworkPlan, and its kernels train through `execute_plan` with
rematerialization (``--remat off|auto|<bytes>``) and gradient
accumulation (``--accum K``) — `repro_torch.cnn.train.train_plan`.

    python -m repro_torch.launch.train --plan-net cnn8 --remat auto \
        --steps 2 --batch 2 --accum 2 --device cpu

Both paths run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path
from typing import Any, List, NamedTuple, Optional


def plan_net_mapping(name: str):
    """``name`` (a key of core/networks.py's NETWORKS) mapped as the
    plan trainer maps it."""
    from ..core import ArrayConfig, MacroGrid, map_net, networks
    return map_net(name, networks.NETWORKS[name](), ArrayConfig(64, 64),
                   "TetrisG-SDK", MacroGrid(2, 2))


class LMRun(NamedTuple):
    """What ``--arch`` returns: the final state, the last step, each
    step's metrics (floats) and the supervisor's events."""
    state: Any
    last: int
    metrics: List[dict]
    events: List[str]


def main(argv=None, *, inject_failure_at: Optional[int] = None):
    """The CLI; ``inject_failure_at`` makes the ``--arch`` run lose its
    worker at that step (``TrainSupervisor.run``'s fault injection, for
    recovery drills: it raises ``WorkerLost``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
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
    if args.plan_net is not None:
        return _plan_main(args)
    return _arch_main(args, inject_failure_at)


def _arch_main(args, inject_failure_at: Optional[int]) -> LMRun:
    """The --arch path (module docstring)."""
    import torch
    from ..checkpoint import CheckpointStore
    from ..configs import get_config
    from ..data import ShardedDataPipeline, TokenStream
    from ..device import resolve_device
    from ..runtime import HeartbeatMonitor, TrainSupervisor
    from .steps import TrainConfig, init_train_state, make_train_step
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(microbatches=args.microbatches, peak_lr=args.lr,
                     warmup_steps=max(2, args.steps // 20),
                     total_steps=args.steps)
    step_fn = make_train_step(cfg, tc)

    ts = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                     global_batch=args.batch, seed=args.seed)
    pipe = ShardedDataPipeline(ts)
    store = CheckpointStore(Path(args.ckpt_dir) / cfg.name, keep=2,
                            async_save=True, device=dev)
    sup = TrainSupervisor(store=store, pipeline=pipe,
                          monitor=HeartbeatMonitor(1),
                          save_every=args.save_every)

    def wrapped(state, tokens):
        return step_fn(state, {"tokens": torch.as_tensor(tokens,
                                                         device=dev)})

    t0 = time.time()
    log: List[dict] = []
    fn = _metric_logger(wrapped, t0, log)
    try:
        if args.resume:
            like = init_train_state(cfg, None, device="meta")
            state, last = sup.resume(like, fn, steps=args.steps)
        else:
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            state = init_train_state(cfg, gen, dev)
            state, last = sup.run(state, fn, steps=args.steps,
                                  inject_failure_at=inject_failure_at)
    finally:
        store.wait()
    print(f"done: {last} steps in {time.time()-t0:.1f}s; "
          f"events={sup.events[-3:]}")
    return LMRun(state, last,
                 [{k: float(v) for k, v in m.items()} for m in log],
                 sup.events)


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


def _metric_logger(step_fn, t0, log: list, every: int = 10):
    """``step_fn`` that appends each step's metrics to ``log`` and prints
    the first step's and every ``every``-th."""
    counter = {"n": 0}

    def fn(state, batch):
        state, metrics = step_fn(state, batch)
        log.append(metrics)
        counter["n"] += 1
        if counter["n"] % every == 0 or counter["n"] == 1:
            print(f"step {counter['n']:>5d}  "
                  f"loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"({time.time()-t0:.0f}s)", flush=True)
        return state, metrics
    return fn


if __name__ == "__main__":
    main()
