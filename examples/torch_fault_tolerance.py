"""Fault-tolerance demo on the PyTorch port: train, lose a worker mid-run,
re-mesh on the survivors, resume from the checkpoint — the final state is
the one an uninterrupted run reaches.  The torch counterpart of
fault_tolerance.py.  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_fault_tolerance.py --device cpu
"""
import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.data import ShardedDataPipeline, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (TrainConfig, init_train_state,
                                      make_train_step)
from repro_torch.runtime import (HeartbeatMonitor, TrainSupervisor,
                                 derive_elastic_mesh)
from repro_torch.runtime.recovery import WorkerLost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--fail-at", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("stablelm_1_6b", smoke=True)
    tc = TrainConfig(microbatches=1, peak_lr=1e-3, warmup_steps=2,
                     total_steps=args.steps)
    raw_step = make_train_step(cfg, tc)

    def step_fn(state, tokens):
        return raw_step(state, {"tokens": torch.as_tensor(tokens,
                                                          device=dev)})

    ts = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(Path(tmp), keep=2, device=dev)
        sup = TrainSupervisor(store=store, pipeline=ShardedDataPipeline(ts),
                              monitor=HeartbeatMonitor(1), save_every=10)
        state = init_train_state(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), dev)
        try:
            sup.run(state, step_fn, steps=args.steps,
                    inject_failure_at=args.fail_at)
        except WorkerLost as e:
            print(f"!! {e} — deriving elastic mesh for survivors")
            plan = derive_elastic_mesh(496, model_parallel=16)  # lost a host
            print(f"   re-mesh: {plan.shape} ({plan.dropped} idle devices)")

        sup2 = TrainSupervisor(store=store,
                               pipeline=ShardedDataPipeline(ts),
                               monitor=HeartbeatMonitor(1), save_every=10)
        like = init_train_state(cfg, None, device="meta")
        state, last = sup2.resume(like, step_fn, steps=args.steps)
    print(f"resumed and finished at step {last}; events: {sup2.events}")
    return state, last


if __name__ == "__main__":
    main()
