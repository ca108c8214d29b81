"""Sharded, atomic, restart-exact checkpointing (port of
``repro/checkpoint/store.py``, in the JAX package's format).

Layout:  <dir>/step_<N>/
            shard_<k>.npz        the flat leaves, leaf i in shard i % k
                                 under the name ``a<i>``
            MANIFEST.json        leaf key -> shard, name, dtype, shape;
                                 the step and the caller's extra (the
                                 data cursor)
Writes are crash-safe: everything lands in step_<N>.tmp/, the MANIFEST is
written last, then the directory is atomically renamed.

Leaves are flattened as the JAX package flattens a pytree: dict keys in
sorted order, tuple and list entries by index, and each leaf keyed by its
path joined with ``/`` (``params/stages/0/0/attn/wq``).  So a checkpoint
written by one package restores in the other.  numpy cannot hold a
bfloat16 tensor, so a bf16 leaf is refused (a train state has none:
params, ``m`` and ``v`` are f32, ``step`` is int32).

Async mode: ``CheckpointStore(async_save=True)`` copies the state to host
memory synchronously and writes the files on a worker thread, so training
continues during the write.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..optim import tree_unflatten


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order and spelling."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    return [kv for k, v in items
            for kv in _flatten(v, f"{prefix}/{k}" if prefix else k)]


def _to_host(key: str, leaf) -> np.ndarray:
    """A leaf as a numpy array; a tensor's is a copy on every device (on
    the CPU ``.cpu()`` would share its storage)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"{key}: a bfloat16 tensor has no numpy dtype; "
                            f"checkpoint it in float32")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save_checkpoint(directory, step: int, state, *, extra: Optional[Dict]
                    = None, n_shards: int = 4) -> Path:
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    leaves = [(key, _to_host(key, leaf)) for key, leaf in _flatten(state)]
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": {},
                "n_shards": n_shards}
    shards: List[Dict[str, np.ndarray]] = [{} for _ in range(n_shards)]
    for i, (key, arr) in enumerate(leaves):
        shard = i % n_shards
        name = f"a{i}"
        shards[shard][name] = arr
        manifest["leaves"][key] = {"shard": shard, "name": name,
                                   "dtype": str(arr.dtype),
                                   "shape": list(arr.shape)}
    for k, data in enumerate(shards):
        np.savez(tmp / f"shard_{k}.npz", **data)
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # atomic publish
    return final


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and \
                not p.name.endswith(".tmp") and \
                (p / "MANIFEST.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory, like, *, step: Optional[int] = None,
                       device: DeviceLike = None, shardings=None
                       ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``like`` (a tree of tensors; ``meta``
    tensors give the shapes alone): (state with every leaf on
    ``resolve_device(device)`` in its stored dtype, step, extra)."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto a mesh (shardings) waits for meshes and "
            "sharding (ROADMAP.md queue 1, item 7)")
    dev = resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    out_leaves = []
    with contextlib.ExitStack() as stack:
        files = {k: stack.enter_context(np.load(d / f"shard_{k}.npz"))
                 for k in range(manifest["n_shards"])}
        for key, leaf in _flatten(like):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = files[meta["shard"]][meta["name"]]
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            out_leaves.append(torch.tensor(arr, device=dev))
    return tree_unflatten(like, out_leaves), step, manifest["extra"]


class CheckpointStore:
    """Keeps the last ``keep`` checkpoints; optional async writes;
    restores onto ``device``."""

    def __init__(self, directory, keep: int = 3, async_save: bool = False,
                 device: DeviceLike = None):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self.device = device
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state, extra: Optional[Dict] = None) -> None:
        # copy to the host synchronously (on the CPU too: the next step
        # must not change what the worker writes), write async if asked
        host_state = tree_unflatten(
            state, [_to_host(k, v) for k, v in _flatten(state)])
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_state, extra)

    def _write(self, step, state, extra):
        save_checkpoint(self.directory, step, state, extra=extra)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.directory.iterdir()
            if p.is_dir() and p.name.startswith("step_")
            and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)

    def restore_latest(self, like, shardings=None):
        return restore_checkpoint(self.directory, like,
                                  device=self.device, shardings=shardings)
