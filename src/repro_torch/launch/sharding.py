"""Sharding rules (port of ``repro/launch/sharding.py``): the LM
production mesh's param, optimizer, cache and batch specs, and the CIM
macro grid's.

A spec (:class:`P`) names, for each dimension of a tensor, the mesh axis
or axes that split it, or None — the JAX package's ``PartitionSpec``,
entry for entry (``tuple(jax_spec) == tuple(port_spec)``).  The LM
policy (baseline, as the JAX package's):

* params: 2-D sharded — FSDP over the data axes x TP over 'model'.
  Attention projections shard heads over 'model' when divisible, else
  head_dim (e.g. qwen's 40 heads on a 16-way axis); MoE experts shard
  over 'model' when divisible (EP), else d_ff (TP fallback, mixtral 8e).
* optimizer state: the same spec as its param (elementwise ops).
* batch: over the data axes ('pod' folds in); replicated when the batch
  doesn't divide (long_500k's batch=1).
* KV caches: batch over the data axes, sequence over 'model'; recurrent
  states shard their widest dim.

Specs derive from tree *paths*: the block group name ('attn', 'mlp',
'moe', 'rec', 'ssd', 'cross') plus the leaf name are the contract, so
the same rules cover every arch.  A path names dict keys as they are and
tuple entries as ``"[i]"``, as JAX names its sequence keys.

:func:`placements` turns a spec into ``DTensor`` placements on a
``DeviceMesh``; :func:`distribute` places a tree of full tensors by a
tree of :class:`NamedSharding`.  On a mesh of one device that is not a
``DeviceMesh`` (``launch.mesh.make_host_mesh``) the tensors stay plain,
on that device: what the single-card cells run.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple, Optional, TYPE_CHECKING, Tuple

from .mesh import axis_names, axis_sizes, data_axes

if TYPE_CHECKING:       # annotation-only: keep the LM stack out of the
    from ..models.config import ArchConfig   # CNN/mapped_net imports


class P(tuple):
    """A partition spec: per tensor dimension None, an axis name, or a
    tuple of axis names (major to minor).  A one-name tuple is stored as
    the bare name, as JAX stores it."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec bound to a mesh (JAX's ``NamedSharding``)."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def placements(spec, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: per mesh dimension
    ``Shard(d)`` where the spec names that axis at tensor dim ``d``, else
    ``Replicate()``.  A dim named under several axes is sharded by each,
    the first (major) axis first, which is DTensor's order over mesh
    dims, so the axes must come in mesh order.  An axis of size 1 splits
    nothing and is ``Replicate()`` (the same local tensor; DTensor
    refuses to reshape a dim sharded even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    used = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or used & set(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names} or used twice")
        used |= set(idx)
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def mesh_device(mesh):
    """The device this process's shards live on: a ``DeviceMesh``'s device
    type (the current card on ``cuda``), or a one-device mesh's device."""
    import torch
    if is_device_mesh(mesh):
        if mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(mesh.device_type)
    devs = getattr(mesh, "device_list", None)
    if devs is None or len(devs) != 1:
        raise ValueError(f"{mesh!r}: an LM step runs on a DeviceMesh or "
                         f"on a mesh of one device")
    return devs[0]


def place(x, sharding: Optional[NamedSharding]):
    """A full tensor placed by ``sharding``: a ``DTensor`` on a
    ``DeviceMesh`` (every rank passes the same full value), the plain
    tensor moved to the device of a one-device mesh; anything else that is
    not a tensor (an int position) as it is."""
    import torch
    if sharding is None or not isinstance(x, torch.Tensor):
        return x
    mesh = sharding.mesh
    if is_device_mesh(mesh):
        from torch.distributed.tensor import DTensor, distribute_tensor
        if isinstance(x, DTensor):
            return x.redistribute(mesh, sharding.placements)
        return distribute_tensor(x.to(mesh_device(mesh)), mesh,
                                 sharding.placements)
    return x.to(mesh_device(mesh))


def local_part(shape, mesh, placements):
    """(local shape, global offset) of this rank's shard of a tensor of
    global ``shape`` placed by ``placements`` on a ``DeviceMesh``."""
    import torch
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(torch.Size(shape), mesh,
                                                 placements)


def from_local(local, mesh, placements, shape, stride=None):
    """The ``DTensor`` of global ``shape`` (contiguous ``stride`` unless
    given) whose shard on this rank is ``local``, unchecked: every rank
    passes its own part (:func:`local_part`)."""
    import torch
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    if stride is None:
        stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def place_host(full, sharding: NamedSharding):
    """A full value (a numpy array, or a tensor on any device), the same
    on every rank, placed by ``sharding`` without its whole reaching a
    device: on a ``DeviceMesh`` each rank copies only its local shard,
    sliced where the value lies, to its device and wraps it as the
    ``DTensor`` (``jax.device_put`` of a host array); on a one-device
    mesh the value goes whole to that device, as :func:`place` sends
    it."""
    import torch
    mesh = sharding.mesh
    if not is_device_mesh(mesh):
        return place(full if isinstance(full, torch.Tensor)
                     else torch.tensor(full), sharding)
    pl = sharding.placements
    local, offset = local_part(full.shape, mesh, pl)
    part = full[tuple(slice(o, o + n) for o, n in zip(offset, local))]
    dev = mesh_device(mesh)
    part = (part.to(dev, copy=True) if isinstance(part, torch.Tensor)
            else torch.tensor(part, device=dev))
    return from_local(part, mesh, pl, full.shape)


def move(x, placements):
    """``DTensor`` ``x`` redistributed to ``placements`` on its mesh, or
    ``x`` itself where they are its own: a redistribute that moves
    nothing still turns its gradient into its input's placements, so it
    would all-reduce a partial gradient that should flow on (to the
    FSDP gather's backward, a reduce-scatter)."""
    if list(x.placements) == list(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def gather_uneven(x, dim: int, size: Optional[int] = None):
    """A ``DTensor`` split on ``dim`` over a mesh dim whose size does not
    divide ``size`` (default: the dim's own), gathered over that mesh
    dim (DTensor will not flatten or view such a split: mamba2's 24 heads
    on a 16-way "model" axis, q's heads grouped by 8 kv heads there);
    anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    size = x.shape[dim] if size is None else size
    sizes = x.device_mesh.shape
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and size % sizes[i] else p
          for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def constrain(x, sharding: Optional[NamedSharding]):
    """``jax.lax.with_sharding_constraint``: a ``DTensor`` redistributed
    to ``sharding``; a plain tensor (one device) as it is."""
    from torch.distributed.tensor import DTensor
    if sharding is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(sharding.mesh, sharding.placements)


def gather_fsdp(tree):
    """The FSDP gather at use: each ``DTensor`` leaf of ``tree``
    redistributed to ``Replicate()`` over the data axes ("pod", "data"),
    its "model" split kept; plain tensors, and leaves split over no data
    axis of more than one rank, as they are (a (1, 1) mesh changes
    nothing).  The backward of the ``redistribute`` takes a gradient back
    to the leaf's placements (a reduce-scatter over the data axes).

    Against a weight split over "data" on d_model, DTensor's own
    strategies keep the weight and move the activations: a rank would
    multiply the whole microbatch against a d_model slice and all-reduce
    the partial products.  GSPMD gathers the weight instead, which this
    does: a product then runs as x (batch split) @ w (model split)."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(_, x):
        if not isinstance(x, DTensor):
            return x
        names = axis_names(x.device_mesh)
        return move(x, [Replicate() if names[i] in ("pod", "data") else p
                        for i, p in enumerate(x.placements)])
    return map_with_path(one, tree)


def partial_reducer(mesh, dims):
    """``reduce(t, op)``: a local tensor all-reduced (``op`` "max" or
    "sum") over the mesh dims ``dims``, through a ``Partial`` placement
    (differentiable where ``op`` is "sum"); None where ``dims`` is
    empty.  What combines a softmax over shards of its row (the
    split-keys decode, the vocab-split loss)."""
    if not dims:
        return None
    from torch.distributed.tensor import Partial, Replicate

    def reduce(t, op):
        pl = [Partial(op) if i in dims else Replicate()
              for i in range(mesh.ndim)]
        return from_local(t.contiguous(), mesh, pl, t.shape).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()
    return reduce


class DictKey(NamedTuple):
    """A dict entry of a tree path (JAX's ``DictKey``)."""
    key: object


class SequenceKey(NamedTuple):
    """A tuple or list entry of a tree path (JAX's ``SequenceKey``)."""
    idx: int


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists, the path
    a tuple of :class:`DictKey` and :class:`SequenceKey`
    (``jax.tree_util.tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (DictKey(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (SequenceKey(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _zip_map(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a tree and its same-structured tree of
    shardings; a None or :class:`NamedSharding` in place of a subtree
    applies to all of it."""
    if shardings is None or isinstance(shardings, NamedSharding):
        return map_with_path(lambda _, x: fn(x, shardings), tree)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, v, s)
                          for v, s in zip(tree, shardings))
    return fn(tree, shardings)


def distribute(tree, shardings):
    """A tree of full tensors placed leaf by leaf by ``shardings`` (a tree
    of the same structure, or one :class:`NamedSharding` for all):
    ``jax.device_put(tree, shardings)``."""
    return _zip_map(place, tree, shardings)


def zeros(tree, shardings):
    """Zeros in the shapes and dtypes of ``tree`` (``meta`` tensors),
    made placed by ``shardings``: on a ``DeviceMesh`` each rank makes its
    own shards alone, so no full tensor is ever made."""
    import torch

    def one(a, s):
        mesh = s.mesh
        if is_device_mesh(mesh):
            from torch.distributed import tensor as dt
            return dt.zeros(tuple(a.shape), dtype=a.dtype, device_mesh=mesh,
                            placements=s.placements)
        return torch.zeros(tuple(a.shape), dtype=a.dtype,
                           device=mesh_device(mesh))
    return _zip_map(one, tree, shardings)


def _stacked(names: Tuple[str, ...]) -> bool:
    """Whether a param leaf is stacked over its stage's units (dim 0)."""
    return "stages" in names or "enc_stages" in names


class Placer:
    """Places the params by ``shardings`` (:func:`param_shardings`) part
    by part, as ``models.transformer.init_params(place=)`` draws them: a
    leaf stacked over the units is placed unit by unit (each unit's
    shard by the spec without its leading None) into its local stack,
    which becomes the ``DTensor`` once its last unit is in.  So a rank
    holds no more than one block in full beside its shards: what lets a
    model place that does not fit one device whole.  Each part is cut to
    this rank's shard where it was drawn (:func:`place_host`): no
    collective scatters it.  :meth:`tree` places a tree of full tensors
    (weights carried as numpy) the same way."""

    def __init__(self, shardings):
        self.by_path = {}
        map_with_path(lambda p, s: self.by_path.__setitem__(
            _path_names(p), s), shardings)
        self.units = {}

    def __call__(self, path, tree, u=None, n=None):
        return map_with_path(
            lambda p, x: self._leaf(tuple(path) + _path_names(p), x, u, n),
            tree)

    def tree(self, full):
        """A tree of full tensors (on any device) placed leaf by leaf."""
        def one(p, x):
            names = _path_names(p)
            if not _stacked(names):
                return self._leaf(names, x)
            for u in range(x.shape[0]):
                out = self._leaf(names, x[u], u, x.shape[0])
            return out
        return map_with_path(one, full)

    def _leaf(self, names, x, u=None, n=None):
        s = self.by_path[names]
        if u is None:
            return place_host(x, s)
        assert not s.spec or s.spec[0] is None, (names, s.spec)
        part = place_host(x, NamedSharding(s.mesh, P(*s.spec[1:])))
        local = part.to_local() if is_device_mesh(s.mesh) else part
        if u == 0:
            self.units[names] = local.new_empty((n,) + tuple(local.shape))
        self.units[names][u].copy_(local)
        if u < n - 1:
            return None
        stack = self.units.pop(names)
        if not is_device_mesh(s.mesh):
            return stack
        return from_local(stack, s.mesh, s.placements,
                          (n,) + tuple(x.shape))


def constrain_tree(tree, shardings):
    """:func:`constrain` leaf by leaf (a jitted function's
    ``out_shardings``)."""
    return _zip_map(constrain, tree, shardings)


_VIEWS: dict = {}


def compute_mesh(mesh):
    """The mesh an LM step computes on: a ``DeviceMesh`` with a "pod" axis
    viewed as ("data", "model"), "pod" folded into "data" (the pod axis
    is pure data parallelism); any other mesh as it is.  The view holds
    the same ranks in the same order, so a tensor split over ("pod",
    "data") has the same local shards split over its "data"
    (:func:`rewrap`).  DTensor's sharding propagation searches strategies
    exponentially in the mesh's dims: a (2, 1, 2) mesh took minutes a
    train step on the CPU, its (2, 2) view seconds."""
    if not is_device_mesh(mesh) or "pod" not in axis_names(mesh):
        return mesh
    if mesh not in _VIEWS:
        from torch.distributed.device_mesh import DeviceMesh
        if axis_names(mesh) != ("pod", "data", "model"):
            raise ValueError(f"{axis_names(mesh)}: a pod mesh is (pod, "
                             f"data, model)")
        ranks = mesh.mesh.reshape(-1, axis_sizes(mesh)["model"])
        _VIEWS[mesh] = DeviceMesh(mesh.device_type, ranks,
                                  mesh_dim_names=("data", "model"))
    return _VIEWS[mesh]


def view_spec(spec, mesh) -> P:
    """``spec`` on :func:`compute_mesh`'s view of ``mesh``: ("pod",
    "data") becomes "data"."""
    if compute_mesh(mesh) is mesh:
        return P(*spec)

    def one(e):
        if e is None or e == "model":
            return e
        if tuple(e) != ("pod", "data"):
            raise ValueError(f"spec {spec}: pod and data split apart")
        return "data"
    return P(*(one(e) for e in spec))


def view_shardings(shardings, mesh):
    """A tree of shardings on ``mesh`` moved to its compute view."""
    view = compute_mesh(mesh)
    if view is mesh:
        return shardings
    return map_with_path(
        lambda _, s: NamedSharding(view, view_spec(s.spec, mesh)),
        shardings)


def rewrap(tree, mesh):
    """The ``DTensor`` leaves of ``tree`` moved between a pod mesh and its
    :func:`compute_mesh` view (``mesh``: the one to move to), keeping
    their local shards: no data moves.  A split over "data" of the view
    is a split over both "pod" and "data"; other leaves as they are."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(_, x):
        if not isinstance(x, DTensor):
            return x
        src = axis_names(x.device_mesh)
        if ("pod" in src) == ("pod" in axis_names(mesh)):
            return x
        pl = dict(zip(src, x.placements))
        if "pod" in src:            # to the view
            sizes = axis_sizes(x.device_mesh)
            split = {pl[a] for a in ("pod", "data") if sizes[a] > 1}
            if len(split) > 1:
                raise ValueError(f"placements {x.placements}: pod and "
                                 f"data split apart")
            new = [split.pop() if split else pl["data"], pl["model"]]
        else:                       # back to the pod mesh
            sizes = axis_sizes(mesh)
            new = [pl["data"] if sizes[a] > 1 else Replicate()
                   for a in ("pod", "data")] + [pl["model"]]
        return from_local(x.to_local(), mesh, new, x.shape, x.stride())
    return map_with_path(one, tree)


@contextlib.contextmanager
def spmd(mesh):
    """Where the operands are ``DTensor``s on a ``DeviceMesh``, the model
    code's plain tensors (masks, positions, scalar constants) take part as
    replicated values (``implicit_replication``); elsewhere nothing."""
    if mesh is None or not is_device_mesh(mesh):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def _path_names(path) -> Tuple[str, ...]:
    names = []
    for e in path:
        if hasattr(e, "key"):
            names.append(str(e.key))
        elif hasattr(e, "idx"):
            names.append(f"[{e.idx}]")
    return tuple(names)


def _prod(sizes: dict, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def param_spec(names: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               cfg: ArchConfig) -> P:
    sizes = axis_sizes(mesh)
    dp = data_axes(mesh)
    name = names[-1]
    group = next((n for n in reversed(names[:-1])
                  if n in ("attn", "cross", "mlp", "moe", "rec", "ssd")),
                 None)
    stacked = "stages" in names or "enc_stages" in names
    off = 1 if stacked else 0
    lead = (None,) * off

    def mdl(i: int):
        return "model" if shape[i] % sizes["model"] == 0 else None

    def fsdp(i: int):
        return dp if shape[i] % _prod(sizes, dp) == 0 else None

    # --- top level ---
    if name == "embed":
        return P(mdl(0), fsdp(1))
    if name == "head":
        return P(fsdp(0), mdl(1))

    # --- attention (incl. cross) ---
    if group in ("attn", "cross"):
        if name in ("wq", "wk", "wv"):          # (L, D, H, dh)
            if mdl(off + 1):
                return P(*lead, fsdp(off), "model", None)
            return P(*lead, fsdp(off), None, mdl(off + 2))
        if name in ("bq", "bk", "bv"):          # (L, H, dh)
            if mdl(off):
                return P(*lead, "model", None)
            return P(*lead, None, mdl(off + 1))
        if name == "wo":                        # (L, H, dh, D)
            if mdl(off):
                return P(*lead, "model", None, fsdp(off + 2))
            return P(*lead, None, mdl(off + 1), fsdp(off + 2))
        if name in ("w_uk", "w_uv"):            # (L, dl, H, dh)
            return P(*lead, fsdp(off), mdl(off + 1), None)
        if name == "w_dkv":                     # (L, D, dl)
            return P(*lead, fsdp(off), mdl(off + 1))
        if name == "w_kr":                      # (L, D, dr)
            return P(*lead, fsdp(off), None)

    # --- MoE ---
    if group == "moe":
        if name in ("wi", "wg"):                # (L, E, D, F)
            if mdl(off):
                return P(*lead, "model", fsdp(off + 1), None)
            return P(*lead, None, fsdp(off + 1), mdl(off + 2))
        if name == "wo":                        # (L, E, F, D)
            if mdl(off):
                return P(*lead, "model", None, fsdp(off + 2))
            return P(*lead, None, mdl(off + 1), fsdp(off + 2))
        if name == "router":                    # (L, D, E)
            return P(*lead, fsdp(off), None)
        if name in ("shared_wi", "shared_wg"):  # (L, D, Fs)
            return P(*lead, fsdp(off), mdl(off + 1))
        if name == "shared_wo":                 # (L, Fs, D)
            return P(*lead, mdl(off), fsdp(off + 1))

    # --- dense MLP ---
    if group == "mlp":
        if name in ("wi", "wg"):                # (L, D, F)
            return P(*lead, fsdp(off), mdl(off + 1))
        if name == "wo":                        # (L, F, D)
            return P(*lead, mdl(off), fsdp(off + 1))

    # --- RG-LRU recurrent block ---
    if group == "rec":
        if name in ("wx", "wgate"):             # (L, D, W)
            return P(*lead, fsdp(off), mdl(off + 1))
        if name in ("wr", "wi"):                # (L, W, W)
            return P(*lead, fsdp(off), mdl(off + 1))
        if name == "wout":                      # (L, W, D)
            return P(*lead, mdl(off), fsdp(off + 1))
        if name == "conv_w":                    # (L, K, W)
            return P(*lead, None, mdl(off + 1))
        if name == "lam":                       # (L, W)
            return P(*lead, mdl(off))

    # --- SSD (mamba2) ---
    if group == "ssd":
        if name in ("wx", "wz", "wbc", "wdt"):  # (L, D, X)
            return P(*lead, fsdp(off), mdl(off + 1))
        if name == "wout":                      # (L, di, D)
            return P(*lead, mdl(off), fsdp(off + 1))
        if name == "conv_w":                    # (L, K, X)
            return P(*lead, None, mdl(off + 1))

    # norms, scalars, small vectors: replicate
    return P(*((None,) * len(shape)))


def param_shardings(cfg: ArchConfig, params_shape, mesh):
    """A :class:`NamedSharding` for every leaf of ``params_shape`` (a tree
    of tensors; ``meta`` tensors give the shapes alone)."""
    def one(path, leaf):
        names = _path_names(path)
        spec = param_spec(names, tuple(leaf.shape), mesh, cfg)
        assert len(spec) <= len(leaf.shape), (names, leaf.shape, spec)
        return NamedSharding(mesh, spec)
    return map_with_path(one, params_shape)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_dim(mesh, b: int):
    dp = data_axes(mesh)
    return dp if b % _prod(axis_sizes(mesh), dp) == 0 else None


def batch_spec(mesh, b: int, ndim: int) -> P:
    return P(batch_dim(mesh, b), *((None,) * (ndim - 1)))


def cache_spec(names: Tuple[str, ...], shape, mesh, cfg: ArchConfig) -> P:
    sizes = axis_sizes(mesh)
    name = names[-1]
    bd = batch_dim(mesh, shape[1])      # dim 0 is the n_units stack

    def mdl(i: int):
        return "model" if shape[i] % sizes["model"] == 0 else None

    if name in ("k", "v"):              # (U, B, L, Hkv, dh)
        return P(None, bd, mdl(2), None, None)
    if name in ("ckv", "kr"):           # (U, B, L, X)
        return P(None, bd, mdl(2), None)
    if name == "state":                 # (U, B, H, P, N)
        return P(None, bd, None, None, mdl(4))
    if name == "h":                     # (U, B, W)
        return P(None, bd, mdl(2))
    if name == "conv":                  # (U, B, K-1, X)
        return P(None, bd, None, mdl(3))
    return P(*((None,) * len(shape)))


def cache_shardings(cfg: ArchConfig, cache_shape, mesh):
    def one(path, leaf):
        return NamedSharding(mesh, cache_spec(_path_names(path),
                                              tuple(leaf.shape), mesh, cfg))
    return map_with_path(one, cache_shape)


def opt_shardings(param_sh, mesh):
    rep = NamedSharding(mesh, P())
    return {"m": param_sh, "v": param_sh, "step": rep}


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# CIM macro-grid specs (cnn/mapped_net.py)
# ---------------------------------------------------------------------------

Spec = Tuple[str, ...]


def macro_pass_specs(mesh=None) -> Tuple[Spec, Spec, Spec]:
    """(patch, weight, out) specs of one macro-grid super-step of the
    mapped executor on a ("row", "col") — or ("data", "row", "col") —
    mesh (`launch.mesh.make_macro_mesh`).

    The operands of ``mapped_net._macro_step`` lead with the macro axes:
    patches (sub_r, b, ...) split over "row" (each macro row holds one
    channel-pass block), weights (sub_r, sub_c, ...) over both macro
    axes (each macro holds its own ic_t x oc_t block), and the output
    (sub_c, b, ...) over "col" after the cross-row partial-sum
    reduction.  With a "data" axis the batch dimension of the patches
    and the output also splits over it; the weights are replicated
    across "data" and the reduction stays over "row"."""
    if mesh is not None and "data" in mesh.axis_names:
        return ("row", "data"), ("row", "col"), ("col", "data")
    return ("row",), ("row", "col"), ("col",)


def macro_mesh_fits(mesh, sub_r: int, sub_c: int,
                    batch: Optional[int] = None) -> bool:
    """The mesh axes must divide the macro axes — and, on a mesh with a
    "data" axis, the batch must divide that axis."""
    if (mesh is None
            or sub_r % mesh.shape["row"]
            or sub_c % mesh.shape["col"]):
        return False
    if "data" in mesh.axis_names:
        return batch is not None and batch % mesh.shape["data"] == 0
    return True
