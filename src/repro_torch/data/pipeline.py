"""Sharded, restart-exact data pipeline (a copy of
``repro/data/pipeline.py``, which imports no JAX; the port keeps its
own).

Wraps a :class:`TokenStream` (or any ``batch_at(step, shard, n_shards)``
source) with:

* per-data-shard slicing — each data-parallel rank pulls only its shard;
* a monotone step cursor with ``skip_to(step)`` — restart-exact resume
  (checkpoint stores only the step number);
* host-side double-buffering (prefetch thread) so input generation
  overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class ShardedDataPipeline:
    def __init__(self, source, shard: int = 0, n_shards: int = 1,
                 prefetch: int = 2):
        self.source = source
        self.shard = shard
        self.n_shards = n_shards
        self.step = 0
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- restart-exact resume ------------------------------------------
    def skip_to(self, step: int) -> None:
        if self._thread is not None:
            raise RuntimeError("skip_to before starting prefetch")
        self.step = step

    # -- synchronous path ----------------------------------------------
    def next(self) -> np.ndarray:
        batch = self.source.batch_at(self.step, self.shard, self.n_shards)
        self.step += 1
        return batch

    # -- prefetching path ------------------------------------------------
    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step, self.shard, self.n_shards)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self) -> None:
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def next_prefetched(self) -> np.ndarray:
        if self._thread is None:
            return self.next()
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_prefetched()
