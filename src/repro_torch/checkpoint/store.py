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

Meshes: a state of ``DTensor`` leaves (an LM cell on a ``DeviceMesh``) is
gathered whole on every rank and written by rank 0 alone;
``restore_checkpoint(shardings=)`` reads each leaf on the host and sends
each rank only its shard by its ``launch.sharding.NamedSharding`` — on
another mesh than the one it was saved from, too (elastic resharding).
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


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _to_host(key: str, leaf) -> np.ndarray:
    """A leaf as a numpy array; a tensor's is a copy on every device (on
    the CPU ``.cpu()`` would share its storage), a ``DTensor``'s the
    whole tensor (a collective: every rank of its mesh takes part)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"{key}: a bfloat16 tensor has no numpy dtype; "
                            f"checkpoint it in float32")
        leaf = leaf.detach()
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _host_state(state):
    """(the state's leaves as numpy in its structure, whether rank 0
    alone writes them): a state holding ``DTensor``s is gathered on every
    rank and written once."""
    pairs = _flatten(state)
    sharded = any(_is_dtensor(leaf) for _, leaf in pairs)
    host = tree_unflatten(state, [_to_host(k, v) for k, v in pairs])
    import torch.distributed as dist
    skip = sharded and dist.is_initialized() and dist.get_rank() != 0
    return host, sharded, skip


def _barrier(sharded: bool) -> None:
    """After a sharded state's write, every rank waits for rank 0's."""
    import torch.distributed as dist
    if sharded and dist.is_initialized():
        dist.barrier()


def save_checkpoint(directory, step: int, state, *, extra: Optional[Dict]
                    = None, n_shards: int = 4) -> Path:
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    host, sharded, skip = _host_state(state)
    if not skip:
        _write_checkpoint(directory, step, host, extra, n_shards)
    _barrier(sharded)
    return final


def _write_checkpoint(directory: Path, step: int, state, extra, n_shards):
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
    tensors give the shapes alone): (state with every leaf in its stored
    dtype, step, extra).  ``shardings`` (optional, a tree of
    ``launch.sharding.NamedSharding`` in ``like``'s structure) places each
    leaf for the *current* mesh — elastic resharding: on a
    ``DeviceMesh`` each rank slices its own shard from the host array and
    sends only that to its device (``launch.sharding.place_host``), so no
    leaf is ever whole on a device; a leaf without one goes to
    ``resolve_device(device)``."""
    from ..launch.sharding import place_host
    flat_sh = (None if shardings is None
               else [s for _, s in _flatten(shardings)])
    dev = resolve_device(device) if shardings is None else None
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    pairs = _flatten(like)
    if flat_sh is not None and len(flat_sh) != len(pairs):
        raise ValueError(f"shardings hold {len(flat_sh)} leaves where the "
                         f"state has {len(pairs)}")
    out_leaves = []
    with contextlib.ExitStack() as stack:
        files = {k: stack.enter_context(np.load(d / f"shard_{k}.npz"))
                 for k in range(manifest["n_shards"])}
        for i, (key, leaf) in enumerate(pairs):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = files[meta["shard"]][meta["name"]]
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            if flat_sh is not None and flat_sh[i] is not None:
                out_leaves.append(place_host(arr, flat_sh[i]))
                continue
            dev = dev or resolve_device(device)
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
        # must not change what the worker writes), write async if asked;
        # a sharded state is written by rank 0 alone
        host_state, sharded, skip = _host_state(state)
        if skip:
            pass
        elif self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_state, extra)
        if not self.async_save:
            _barrier(sharded)

    def _write(self, step, state, extra):
        _write_checkpoint(self.directory, step, state, extra, 4)
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
