"""Seeded synthetic datasets (port of ``repro/data/synthetic.py``), the
offline stand-ins for MNIST/CIFAR and C4.

* :func:`image_task` — class prototypes low-passed by a 3x3 depthwise
  mean, plus per-sample noise.  Draws come from an explicit
  ``torch.Generator`` on its own device; the JAX package draws from
  ``jax.random``, which torch cannot replay, so the parity tests hand
  both packages the reference's draws as numpy.
* :class:`TokenStream` — a verbatim numpy copy of the JAX package's
  order-2 Markov token stream, so ``batch_at(step, shard, n_shards)``
  returns bit for bit its tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def image_task(gen: torch.Generator, *, n_train: int, n_test: int,
               size: int, channels: int, num_classes: int,
               noise: float = 0.6) -> Tuple[torch.Tensor, ...]:
    """(xs, ys, xt, yt): ``n_train`` / ``n_test`` images (N, channels,
    size, size) f32 and int64 labels, on ``gen``'s device."""
    dev = gen.device
    protos = torch.randn((num_classes, channels, size, size), generator=gen,
                         device=dev)
    # low-pass the prototypes for spatial structure
    kernel = torch.full((channels, 1, 3, 3), 1.0 / 9.0, device=dev)
    protos = F.conv2d(protos, kernel, padding=1, groups=channels)

    def make(n):
        y = torch.randint(0, num_classes, (n,), generator=gen, device=dev)
        x = protos[y] + noise * torch.randn((n, channels, size, size),
                                            generator=gen, device=dev)
        return x, y

    xs, ys = make(n_train)
    xt, yt = make(n_test)
    return xs, ys, xt, yt


@dataclass
class TokenStream:
    """Deterministic order-2 Markov LM stream.

    ``batch_at(step, shard, n_shards)`` returns the (local_batch, seq+1)
    token block for that step/shard — pure function of (seed, step,
    shard), which is what makes restart-exact data skipping trivial
    (runtime/recovery.py just replays the step counter).
    """

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_topics: int = 8
    _tables: np.ndarray = None  # lazily built (n_topics, V, V) cumulative

    def __post_init__(self):
        rs = np.random.RandomState(self.seed)
        v = min(self.vocab, 512)      # dense tables over a head vocabulary
        raw = rs.dirichlet(np.ones(v) * 0.05, size=(self.n_topics, v))
        self._tables = np.cumsum(raw, axis=-1)
        self._head_vocab = v

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> np.ndarray:
        if self.global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")
        local = self.global_batch // n_shards
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + step * 977 + shard) % (2 ** 31 - 1))
        topics = rs.randint(0, self.n_topics, size=local)
        u = rs.random_sample((local, self.seq_len + 1))
        tabs = self._tables[topics]               # (local, v, v)
        tok = rs.randint(0, self._head_vocab, size=local)
        out = np.empty((local, self.seq_len + 1), np.int32)
        idx = np.arange(local)
        for i in range(self.seq_len + 1):         # sequential in time only
            rows = tabs[idx, tok]                 # (local, v) cumulative
            tok = np.minimum((rows < u[:, i:i + 1]).sum(-1),
                             self._head_vocab - 1)
            out[:, i] = tok
        return out
