"""Per-rank cost of an eager step, counted op by op: the port's
counterpart of ``repro/launch/hlo_analysis.py``.

The port has no HLO: a step runs eagerly, op by op.  :class:`OpCounter`
is a ``TorchDispatchMode`` entered around the step; it counts every
aten op this rank runs and every collective it issues, and returns the
same :class:`CostTotals` the JAX module derives from the partitioned
HLO text:

* ``flops``: ``torch.utils.flop_counter.flop_registry`` of each op
  (matmuls, convolutions, attention; elementwise ops count none, as
  HLO's ``dot``/``convolution`` count alone);
* ``hbm_bytes``: each op's operand and output bytes.  Eager torch fuses
  nothing, so this is the eager program's traffic: every elementwise op
  reads and writes memory, where XLA's count is post-fusion.  Views,
  ``detach``, ``empty`` and other ops that move no data are free; an
  in-place op reads its operands and writes its output; a gather
  (``index``, ``gather``, ``index_select``, ``embedding``) reads the rows
  it returns and its indices, not its whole source;
* ``coll_bytes``: the output bytes of each ``_c10d_functional``
  collective this rank issues, by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``broadcast``) plus ``total``;
  ``wait_tensor`` and the autograd wrappers are not counted.
  ``coll_link_bytes`` splits them by the slowest link each group spans
  (``roofline.link_of``);
* ``hbm_by_group``, ``coll_by_group`` (and ``flops_by_group``): the
  ``models/`` function that issued the op (``attention._attend_block``),
  else the innermost function of the port (``steps.loss_fn``); an op the
  autograd engine runs is grouped by its backward node
  (``bwd:MmBackward0``).  These stand for the HLO op-name groups.

``DTensor`` steps: the mode hands an op on ``DTensor`` operands back to
DTensor (``NotImplemented``, as ``CommDebugMode`` does), which runs it
as local ops on this rank's shards and the collectives its
redistributions need; the mode counts those.  So every figure is this
rank's own, with no scaling: a DTensor-level count would be global
(``FlopCounterMode`` counts the unsharded FLOPs on DTensors).  The
meta-tensor evaluations DTensor's sharding propagation runs (on
``FakeTensor``s) are not counted.  Plain tensors on one device count
the same way, on any device: ``meta`` (the dry run), the CPU or the
card.

Differences of form from the JAX module: no loop amplification is
needed, since the eager step runs every unit and every microbatch
(``lax.scan`` bodies are counted once in HLO); and the counts are of
the eager program, not of XLA's fused one.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from . import roofline

#: ``_c10d_functional`` collectives by the JAX module's kind names
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "shard_dim_alltoall": "all-to-all",      # DTensor's, on NCCL
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "c10d_functional", "_dtensor")
#: ops that move no data although their output is not a view
_FREE = {"empty", "empty_strided", "new_empty", "new_empty_strided",
         "empty_like", "_local_scalar_dense", "lift_fresh"}

#: gathers: they read the rows they return, not their whole source
#: (the JAX module charges a gather or slice twice its output)
_GATHERS = {"index", "gather", "index_select", "embedding"}

_MODELS = os.sep + os.path.join("repro_torch", "models") + os.sep
_PORT = os.sep + "repro_torch" + os.sep


@dataclass
class CostTotals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    # attribution: the issuing function -> bytes (for perf debugging)
    hbm_by_group: Dict[str, float] = field(default_factory=dict)
    coll_by_group: Dict[str, float] = field(default_factory=dict)
    flops_by_group: Dict[str, float] = field(default_factory=dict)
    #: collective bytes by the slowest link each group spans
    coll_link_bytes: Dict[str, float] = field(default_factory=dict)
    #: (group, aten op) -> [calls, hbm bytes, flops]
    by_op: Dict[Tuple[str, str], list] = field(default_factory=dict)
    ops: int = 0


def _bump(d: dict, key, value: float) -> None:
    d[key] = d.get(key, 0.0) + value


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts this rank's ops and collectives into :attr:`totals` while
    it is entered (module docstring).  ``device_type`` (``"cuda"``,
    ``"meta"``; None: every op) keeps the ops that touch a tensor on
    that device: the host-side bookkeeping of a step on the card (the
    RNG state ``torch.utils.checkpoint`` saves, a scalar made on the
    CPU) moves no device memory."""

    def __init__(self, device_type=None):
        super().__init__()
        self.device_type = device_type
        self.totals = CostTotals()
        self._labels: dict = {}
        self._links: dict = {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._fake, self._dtensor = FakeTensor, DTensor
        self._flops = flop_registry

    # -- attribution --------------------------------------------------
    def _label(self, code) -> str:
        """The group a frame's code names: ``module.function`` under
        ``repro_torch/models/`` (rank 2), elsewhere in the port (rank 1),
        else '' (rank 0)."""
        got = self._labels.get(code)
        if got is None:
            path = code.co_filename
            name = (os.path.splitext(os.path.basename(path))[0] + "."
                    + code.co_name)
            rank = (0 if path == __file__ else 2 if _MODELS in path
                    else 1 if _PORT in path else 0)
            got = self._labels[code] = (rank, name if rank else "")
        return got

    def _group(self) -> str:
        node = torch._C._current_autograd_node()
        if node is not None:
            return "bwd:" + node.name()
        port = None
        f = sys._getframe(2)
        while f is not None:
            rank, name = self._label(f.f_code)
            if rank == 2:
                return name
            if rank == 1 and port is None:
                port = name
            f = f.f_back
        return port or "<other>"

    def _link(self, group) -> str:
        """The slowest link of a collective's group (its name or the
        process group)."""
        if group not in self._links:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            pg = (_resolve_process_group(group) if isinstance(group, str)
                  else group)
            self._links[group] = roofline.link_of(
                dist.get_process_group_ranks(pg))
        return self._links[group]

    # -- the mode -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented       # DTensor runs it as local ops
        out = func(*args, **kwargs)
        if any(issubclass(t, self._fake) for t in types) or any(
                isinstance(t, self._fake) for t in _tensors(out)):
            return out                  # sharding propagation's meta run
        if self.device_type is not None and not any(
                t.device.type == self.device_type
                for t in _tensors((args, kwargs, out))):
            return out                  # host-side bookkeeping
        namespace = func.namespace
        name = func._schema.name.split("::")[-1]
        if namespace in _COLL_NAMESPACES:
            kind = COLLECTIVES.get(name)
            if kind is not None:
                self._collective(kind, func, args, kwargs, out)
            return out
        if name in _FREE or self._is_view(func, args, out):
            return out
        outs = sum(_nbytes(t) for t in _tensors(out))
        if name in _GATHERS:        # the rows read, the indices, the out
            nbytes = 2 * outs + sum(_nbytes(t) for t in _tensors(
                (args[1:], kwargs)))
        else:
            nbytes = outs + sum(_nbytes(t) for t in _tensors((args, kwargs)))
        flop_fn = self._flops.get(func._overloadpacket)
        flops = (float(flop_fn(*args, **kwargs, out_val=out))
                 if flop_fn is not None else 0.0)
        self._record(func, nbytes, flops)
        return out

    @staticmethod
    def _is_view(func, args, out) -> bool:
        """Whether ``func`` moved no data: it writes none of its operands
        and each output shares its storage with an operand (a view, an
        alias, ``_unsafe_view``, a ``contiguous`` that copied nothing).
        The view metadata is set above this mode's dispatch key, so the
        storages are compared."""
        if any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments):
            return False
        outs = _tensors(out)
        ins = {t.untyped_storage()._cdata for t in _tensors(args)}
        return bool(outs) and all(t.untyped_storage()._cdata in ins
                                  for t in outs)

    def _record(self, func, nbytes: float, flops: float) -> str:
        t = self.totals
        group = self._group()
        t.ops += 1
        t.hbm_bytes += nbytes
        t.flops += flops
        _bump(t.hbm_by_group, group, nbytes)
        if flops:
            _bump(t.flops_by_group, group, flops)
        row = t.by_op.setdefault((group, str(func._overloadpacket)),
                                 [0, 0.0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += flops
        return group

    def _collective(self, kind: str, func, args, kwargs, out) -> None:
        moved = sum(_nbytes(t) for t in _tensors(out))
        nbytes = moved + sum(_nbytes(t) for t in _tensors((args, kwargs)))
        group = self._record(func, nbytes, 0.0)
        t = self.totals
        _bump(t.coll_bytes, kind, moved)
        _bump(t.coll_by_group, group, moved)
        import torch.distributed as dist
        groups = [a for a in list(args) + list(kwargs.values())
                  if isinstance(a, (str, dist.ProcessGroup))]
        _bump(t.coll_link_bytes, self._link(groups[-1]), moved)

    def __exit__(self, *exc):
        self.totals.coll_bytes["total"] = sum(
            v for k, v in self.totals.coll_bytes.items() if k != "total")
        return super().__exit__(*exc)


def analyze(fn, *args, device_type=None, **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`CostTotals`), counting the
    ops on ``device_type`` (:class:`OpCounter`)."""
    with OpCounter(device_type) as counter:
        out = fn(*args, **kwargs)
    return out, counter.totals
