"""Shared plan constants: prepared shifted-weight blocks across tiers
(port of ``repro/exec/constants.py``).

Every tier of a plan ladder — and, in fleet serving (launch/fleet.py),
every co-resident plan of the same network — executes the SAME
``NetworkMapping``.  Without constants each forward of each tier
re-derives the identical shifted-and-duplicated weight matrices
(`cnn/mapped_net._tile_weights`, the Fig 5 blocks) from the raw kernels:
the prep is batch-independent.

:func:`prepare_constants` materializes those blocks ONCE per network —
per tile, per congruent window shape, for every layer the plan
dispatches to the ``"mapped"`` executor — into a :class:`PlanConstants`
handle, memoized through ``core/memo.cached_constants`` keyed on the net
mapping (plus resolved executors and the caller's kernel token).
``execute_plan(constants=...)`` then feeds the blocks to any tier of any
ladder of that network: the mapped layers skip their weight prep, and
all tiers share one device copy.

``constant_counts`` mirrors ``exec/plan.compile_counts``: actual
materializations per cache key (hits do NOT count), the evidence that
constants materialize once per network, not once per tier.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..core import memo
from ..core.types import NetworkMapping
from .plan import NetworkPlan


@dataclass(frozen=True)
class PlanConstants:
    """Prepared constants for every plan compiled from one network
    mapping: ``weights[i]`` is layer i's per-tile/per-shape blocked
    shifted-weight matrices (`cnn/mapped_net.prepared_layer_weights`)
    when the plan runs that layer on the ``"mapped"`` executor, else
    ``None`` (the reference/sdk/matmul executors consume raw kernels).
    Valid for ANY batch/tier of the network — the blocks are input- and
    batch-independent."""

    net: NetworkMapping
    executors: Tuple[str, ...]
    weights: Tuple[Optional[Tuple], ...]


def _materialize(plan: NetworkPlan, kernels: Sequence) -> PlanConstants:
    from ..cnn.mapped_net import prepared_layer_weights
    if len(kernels) != len(plan.layers):
        raise ValueError(f"{len(kernels)} kernels for "
                         f"{len(plan.layers)} planned layers")
    weights = tuple(
        prepared_layer_weights(lp.mapping, k) if lp.executor == "mapped"
        else None
        for lp, k in zip(plan.layers, kernels))
    return PlanConstants(net=plan.net, executors=plan.executors,
                         weights=weights)


def prepare_constants(plan: NetworkPlan, kernels: Sequence, *,
                      token=None) -> PlanConstants:
    """Materialize (or fetch) the shared constants for ``plan``'s
    network, on the kernels' device.

    ``token`` identifies the kernel values (tensors are not hashable by
    value): with a token the handle is memoized in
    ``memo.cached_constants`` keyed on ``(net, resolved executors,
    token)``, so every tier of every ladder asking for the same
    network's constants gets the SAME handle and the blocks materialize
    once per network (``constant_counts`` is the per-key evidence).
    ``token=None`` builds an unshared handle — the caller owns its
    lifetime.  The handle serves ANY plan compiled from the same mapping
    with the same resolved executors, whatever its batch."""
    def build():
        if token is not None:
            _constant_counts.note((plan.net, plan.executors, token))
        return _materialize(plan, kernels)

    if token is None:
        return build()
    return memo.cached_constants(("consts", plan.net, plan.executors,
                                  token), build)


#: Actual materializations per (net, executors, token) — cache hits do
#: NOT count.
_constant_counts = memo.BoundedCounts(256)


def constant_counts(*, net: Optional[NetworkMapping] = None) -> dict:
    """Copy of the per-key materialization counters, optionally filtered
    to one network mapping — ``constant_counts(net=nm)`` of length 1
    with value 1 proves the network's constants were prepared once and
    shared across every tier that used them."""
    return {key: n for key, n in _constant_counts.items()
            if net is None or key[0] == net}
