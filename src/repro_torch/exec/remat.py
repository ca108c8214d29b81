"""Segmentation pass: choose rematerialization boundaries for a plan.

A copy of the JAX package's pass: the planning is integer arithmetic on
the mapping and must match it byte for byte.  A plan segment is a
half-open layer range ``(s, e)``; a training forward checkpoints each
segment so only the segment boundary carries are saved for backward
and everything inside is recomputed.  `execute_plan` (exec/run.py) and
`cnn.models.apply_cnn` run each segment under
``torch.utils.checkpoint`` when autograd records the forward.

**Boundary rule.**  A cut is allowed after layer ``i`` only where the
carry is a plain chain: ``glue[i].kind == "chain"`` *and* no saved
residual/concat source is outstanding (the running ``save`` stack from
the glue pass is empty).  This is exactly the ISSUE's
concat-groups-never-split rule: inside a DenseNet block every layer's
output is saved for downstream concats, so the save stack only drains
at the 1x1 transitions — the block is atomic.  Cutting mid-group would
force a saved tensor to cross a checkpoint boundary, which a
single-carry segment interface cannot express.

**Selection.**  Greedy, in the style of chainer-compiler's
``recompute.cc`` (pick recompute sets from the graph's own per-node
memory estimates): walk the layers accumulating the memory-model bytes
(exec/memory.py) and cut at the *last allowed* boundary whenever the
running segment exceeds the budget.  Greedy-last keeps segments as
large as the budget allows, which minimizes recompute work; it can
only fail to meet the budget when a single atomic group already
exceeds it, in which case we cut as tight as legality allows and
report the achievable peak (callers decide whether a best-effort plan
is acceptable — `train_cnn` raises, the autotuner just measures it).

The ``remat`` argument accepted by `compile_plan` canonicalizes as:

* ``None`` / ``"off"`` — no segmentation (single segment, plan field
  stays ``None`` so PR-4-era plan hashes/describe output are
  unchanged).
* ``"auto"`` — budget from ``REPRO_TRAIN_MEM_BUDGET`` (bytes) if set,
  else ``sqrt``-style: aim for ~``ceil(sqrt(n_cuttable))`` segments,
  the classic O(sqrt n) checkpointing sweet spot.
* ``int`` — explicit peak budget in bytes.
* sequence of ints — explicit boundary layer indices (cut *after*
  each index); validated against the boundary rule, ValueError on an
  illegal cut.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple, Union

from . import memory as memlib

ENV_BUDGET = "REPRO_TRAIN_MEM_BUDGET"

RematSpec = Union[None, str, int, Sequence[int]]
Segments = Tuple[Tuple[int, int], ...]


def canonical_remat(remat: RematSpec):
    """Normalize a user remat spec to a hashable cache-key form:
    ``None`` (off), ``("auto", env_budget_or_None)``, ``("budget", n)``
    or ``("cuts", (i, ...))``.  The env budget is folded into the key
    so flipping REPRO_TRAIN_MEM_BUDGET never serves a stale plan."""
    if remat is None or remat == "off" or remat is False:
        return None
    if remat == "auto":
        env = os.environ.get(ENV_BUDGET)
        return ("auto", int(env) if env else None)
    if isinstance(remat, bool):  # guard True before int check
        raise ValueError("remat=True is ambiguous; use 'auto' or a budget")
    if isinstance(remat, int):
        if remat <= 0:
            raise ValueError(f"remat budget must be positive, got {remat}")
        return ("budget", remat)
    try:
        cuts = tuple(sorted(int(i) for i in remat))
    except TypeError:
        raise ValueError(f"bad remat spec: {remat!r}") from None
    return ("cuts", cuts)


def allowed_cuts(glue) -> Tuple[int, ...]:
    """Indices i where cutting after layer i is legal (boundary rule
    above): chain glue with an empty outstanding residual-save stack —
    mirroring `_check_explicit_glue`'s carry simulation, ``save=True``
    pushes and ``kind='residual'`` pops.  Concat glue never cuts (the
    never-split rule: the carry there is the concatenated block stack,
    the worst possible boundary).  The last layer is never a cut (a
    trailing empty segment is meaningless)."""
    saved = 0
    out = []
    for i, g in enumerate(glue[:-1] if glue else []):
        if g.save:
            saved += 1
        if g.kind == "residual":
            saved -= 1
        if g.kind == "chain" and saved == 0:
            out.append(i)
    return tuple(out)


def _segments_from_cuts(cuts: Sequence[int], n: int) -> Segments:
    segs, s = [], 0
    for c in cuts:
        segs.append((s, c + 1))
        s = c + 1
    segs.append((s, n))
    return tuple(segs)


def greedy_segments(mem, allowed: Sequence[int],
                    budget: int) -> Segments:
    """Greedy-last-cut segmentation under ``budget`` (module doc)."""
    n = len(mem)
    allowed = set(allowed)
    cuts = []
    start = 0
    running = 0
    last_ok: Optional[int] = None
    for i, m in enumerate(mem):
        running += m.total_bytes
        if running > budget and last_ok is not None and last_ok >= start:
            cuts.append(last_ok)
            start = last_ok + 1
            running = sum(x.total_bytes for x in mem[start:i + 1])
            last_ok = None
        if i in allowed:
            last_ok = i
    return _segments_from_cuts(cuts, n)


def _auto_budget(mem, allowed) -> int:
    """No env budget: target ~sqrt(n_layers) segments — the classic
    O(sqrt n) checkpointing sweet spot — by sizing the budget as
    total/ceil(sqrt(n)).  With fewer legal cuts than that (DenseNet:
    only the transitions), greedy simply uses every cut it has."""
    total = memlib.total_bytes(mem)
    want = max(2, math.ceil(math.sqrt(len(mem))))
    return max(1, total // want)


def plan_segments(mem, allowed: Sequence[int],
                  spec) -> Optional[Segments]:
    """Run the segmentation pass.  ``spec`` is `canonical_remat` output
    and ``allowed`` the legal cut indices (`allowed_cuts` for chained
    plans; every boundary for layerwise ones, where the model owns the
    glue); returns None for remat-off, else the segment tuple."""
    if spec is None:
        return None
    n = len(mem)
    allowed = tuple(allowed)
    kind = spec[0]
    if kind == "cuts":
        bad = [c for c in spec[1] if c not in allowed]
        if bad:
            raise ValueError(
                f"illegal remat boundaries {bad}: cuts are only allowed "
                f"after chain layers with no outstanding concat/residual "
                f"saves (allowed: {list(allowed)})")
        return _segments_from_cuts(spec[1], n)
    if kind == "auto":
        budget = spec[1] if spec[1] else _auto_budget(mem, allowed)
    else:
        budget = spec[1]
    return greedy_segments(mem, allowed, budget)
