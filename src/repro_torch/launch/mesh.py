"""Device meshes (port of ``repro/launch/mesh.py``): the CIM macro mesh
and the LM production mesh.

*The macro mesh.*  A macro mesh realises the paper's P-macro grid as
devices: axes ("row", "col"), where "row" carries channel passes and
"col" oc passes — the axis correspondence of ``TileMapping.cycles`` —
optionally behind a leading "data" axis whose replicas of the macro grid
each serve a slice of the batch.  The mapped executor runs one
super-step of the macro grid over such a mesh
(`cnn.mapped_net._macro_step`): each mesh coordinate gets its own
operand shards on its own device, and the cross-row partial sums are
added on the input's device.

The macro mesh is a single-controller value, not a ``torch.distributed``
``DeviceMesh``: one process binds it to ``execute_plan(plan, ks, x,
mesh=mesh)``, as the JAX package binds its ``shard_map`` mesh; no
process group is made.  :class:`Mesh` is small, frozen and hashable: its
axis names, its sizes in axis order, and its devices in row-major order.
Entries may repeat — ``[torch.device("cuda", 0)] * 8`` runs the whole
sharded path on one card, the shards one after another.

``devices=None`` means every visible card and raises ``RuntimeError``
without one, as `device.resolve_device` does; a mesh never falls back to
the CPU on its own.  ``"cuda"`` is normalised to ``cuda:0`` so meshes
over the same cards compare and hash equal.

*The production mesh.*  The LM configs shard FSDP x TP over a (16, 16)
("data", "model") pod or a (2, 16, 16) ("pod", "data", "model") pair of
pods.  In torch that is SPMD: one process a rank, the parameters held as
``DTensor`` shards on a ``torch.distributed`` ``DeviceMesh``.
:func:`make_production_mesh` builds that ``DeviceMesh`` over an
initialised process group of exactly its world size and raises
otherwise; it never builds a smaller mesh on its own.  The spec
functions (`launch.sharding`) read any mesh only through
:func:`axis_names` and :func:`axis_sizes`, so they take a
``DeviceMesh``, a :class:`Mesh` (``make_host_mesh``'s 1x1 mesh, on
which the single-card cells run on plain tensors) or any object with
``axis_names`` and a ``shape`` dict.

This module imports torch only where it makes or checks devices: the
pure-Python batching, fleet and router modules import it for
:func:`pad_to_data_axis`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

#: The macro mesh's axes, in order: a data axis, then the macro grid.
MACRO_AXES = ("data", "row", "col")


def normalise_device(d):
    """``torch.device`` with an explicit index for a card (``"cuda"`` ->
    ``cuda:0``); the CPU stays ``cpu``."""
    import torch
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {d}")
    return d


@dataclass(frozen=True)
class Mesh:
    """Devices laid out over named axes.  ``sizes[i]`` is the size of
    ``axis_names[i]``; ``device_list`` holds ``prod(sizes)`` devices in
    row-major order over the axes."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_list: Tuple[object, ...]

    def __post_init__(self):
        names, sizes = tuple(self.axis_names), tuple(int(s)
                                                      for s in self.sizes)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} / sizes {sizes} mismatch")
        if min(sizes, default=0) < 1:
            raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
        devs = tuple(normalise_device(d) for d in self.device_list)
        if len(devs) != math.prod(sizes):
            raise ValueError(f"{len(devs)} devices for a mesh of shape "
                             f"{sizes}")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "device_list", devs)

    @property
    def shape(self) -> dict:
        """``{axis: size}`` in axis order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def devices(self) -> np.ndarray:
        """The devices as an object array of the mesh's shape."""
        arr = np.empty(len(self.device_list), dtype=object)
        arr[:] = list(self.device_list)
        return arr.reshape(self.sizes)

    def device_at(self, coord: dict):
        """The device at mesh coordinate ``{axis: index}``."""
        flat = 0
        for name, size in zip(self.axis_names, self.sizes):
            flat = flat * size + int(coord[name])
        return self.device_list[flat]

    def coords(self):
        """Every coordinate ``{axis: index}``, row-major."""
        for idx in np.ndindex(*self.sizes):
            yield dict(zip(self.axis_names, (int(i) for i in idx)))


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a :class:`Mesh` (the port's
    meshes are its own values; a JAX mesh or any other object is an
    invalid mesh here)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise ValueError(f"invalid mesh {mesh!r}: expected None or a "
                         f"repro_torch.launch.mesh.Mesh")


def visible_devices(device=None) -> list:
    """The device list a mesh builds over by default: every visible card
    for ``None`` or a card (``RuntimeError`` without one), the one CPU
    for ``"cpu"``."""
    import torch
    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_list(devices) -> list:
    if devices is None:
        return visible_devices(None)
    return [normalise_device(d) for d in devices]


def _mesh(devices: list, data: int, mr: int, mc: int) -> Mesh:
    devs = tuple(devices[:data * mr * mc])
    if data > 1:
        return Mesh(MACRO_AXES, (data, mr, mc), devs)
    return Mesh(("row", "col"), (mr, mc), devs)


def make_host_mesh(device=None) -> Mesh:
    """Degenerate 1x1 ("data", "model") mesh on one device (the default:
    the first card)."""
    return Mesh(("data", "model"), (1, 1), (visible_devices(device)[0],))


#: the production meshes' (shape, axes): one pod, and a pair of pods
#: whose "pod" axis is pure data parallelism over the slow links
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                 device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the initialised
    process group, which must hold exactly ``prod(shape)`` ranks; on the
    card (``device_type`` None or ``"cuda"``) the group must have the NCCL
    backend."""
    import torch.distributed as dist
    from ..device import resolve_device
    n = math.prod(shape)
    need = (f"a {shape} {axes} mesh needs an initialised torch.distributed "
            f"process group of {n} ranks")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{need}; none is initialised "
                           f"(torch.distributed.init_process_group)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"{need}; the group has "
                           f"{dist.get_world_size()}")
    dtype = resolve_device(device_type).type
    if dtype == "cuda" and "nccl" not in str(dist.get_backend()):
        raise RuntimeError(f"{need} with the NCCL backend on the card; the "
                           f"group's backend is {dist.get_backend()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dtype, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The (16, 16) ("data", "model") ``DeviceMesh``, or (2, 16, 16)
    ("pod", "data", "model") with ``multi_pod``, on the card unless
    ``device_type`` names the CPU.  Raises ``RuntimeError`` unless a
    process group of 256 (512) ranks is initialised."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return _device_mesh(shape, axes, device_type)


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in order (a ``DeviceMesh``'s
    ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` in axis order, of a ``DeviceMesh`` (whose
    ``shape`` is a tuple), a :class:`Mesh` or any object with
    ``axis_names`` and a ``shape`` dict."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes(mesh) -> tuple:
    """Axes that carry the batch dimension (pod folds into data)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def make_macro_mesh(sub_r: int, sub_c: int, devices=None, *,
                    data: int = 1) -> Optional[Mesh]:
    """Mesh realising a CIM macro (sub-)grid: axes ("row", "col"), with a
    leading "data" axis of size ``data`` when ``data > 1``.

    The (row, col) shape maximises mr*mc over pairs with mr | sub_r,
    mc | sub_c and data*mr*mc <= len(devices) (the macro axes must divide
    the mesh axes; leftover macros stay batched on each device),
    preferring taller meshes on ties.  Returns None when only a
    degenerate 1x1x1 mesh fits — callers then run the single-device
    batched path."""
    if data < 1:
        raise ValueError(f"data axis must be >= 1, got {data}")
    devices = _device_list(devices)
    n = len(devices) // data
    if n < 1:
        return None
    best = (1, 1)
    for mr in (d for d in range(min(sub_r, n), 0, -1) if sub_r % d == 0):
        for mc in (d for d in range(1, min(sub_c, n // mr) + 1)
                   if sub_c % d == 0):
            if mr * mc > best[0] * best[1]:
                best = (mr, mc)
    mr, mc = best
    if data * mr * mc <= 1:
        return None
    return _mesh(devices, data, mr, mc)


def make_serving_mesh(sub_r: int, sub_c: int, batch: int,
                      devices=None) -> Optional[Mesh]:
    """Macro mesh for throughput serving: as many devices as the
    (sub_r, sub_c) macro grid can absorb, then the largest "data" axis
    the remaining devices afford (clamped to ``batch``).  A batch the
    data axis does not divide pads to the next multiple
    (:func:`pad_to_data_axis`).  None when only one device is usable."""
    devices = _device_list(devices)
    base = make_macro_mesh(sub_r, sub_c, devices)
    per_replica = len(base.device_list) if base is not None else 1
    d = max(1, min(len(devices) // per_replica, batch))
    best = make_macro_mesh(sub_r, sub_c, devices, data=d)
    return best if best is not None else base


def net_macro_grid(net_mapping) -> tuple:
    """(gr, gc) macro sub-grid every layer of a ``NetworkMapping`` can
    shard onto: the gcd of the per-layer sub-grids."""
    gr = gc = 0
    for m in net_mapping.layers:
        gr = math.gcd(gr, m.sub_grid.r)
        gc = math.gcd(gc, m.sub_grid.c)
    return max(gr, 1), max(gc, 1)


def serving_mesh_for(net_mapping, batch: int,
                     devices=None) -> Optional[Mesh]:
    """Largest mesh every layer of a ``NetworkMapping`` can shard onto:
    its macro axes divide each layer's sub-grid (gcd across layers),
    leftover devices stack along "data"."""
    gr, gc = net_macro_grid(net_mapping)
    return make_serving_mesh(gr, gc, batch, devices=devices)


def mesh_split(mesh) -> Optional[Tuple[int, int, int]]:
    """Canonical ``(data, row, col)`` split of a macro or serving mesh
    (``None`` for the single-device path) — the hashable, picklable form
    the autotuner searches over and persists; :func:`mesh_from_split`
    rebuilds the live mesh."""
    if mesh is None:
        return None
    shape = mesh.shape
    return (int(shape.get("data", 1)), int(shape.get("row", 1)),
            int(shape.get("col", 1)))


def mesh_from_split(split, devices=None) -> Optional[Mesh]:
    """Live mesh realising a ``(data, row, col)`` split, or None (the
    single-device path) for ``split=None``, a degenerate 1x1x1 split, or
    too few devices to realise it — a split tuned with more devices
    serves on one instead of failing."""
    if split is None:
        return None
    data, mr, mc = (int(s) for s in split)
    if min(data, mr, mc) < 1:
        raise ValueError(f"mesh split must be >= 1 per axis, got {split}")
    if data * mr * mc <= 1:
        return None
    devices = _device_list(devices)
    if data * mr * mc > len(devices):
        return None
    return _mesh(devices, data, mr, mc)


def mesh_split_candidates(net_mapping, batch: int, devices=None) -> tuple:
    """Distinct ``(data, row, col)`` splits of the devices the autotuner
    measures against each other: for every "data" replica count the
    largest macro realisation of the net's common sub-grid, plus the
    pure data-parallel split and ``None`` (the single-device path).
    ``data`` is clamped to ``batch``.  Always holds ``None``; on one
    device that is all there is."""
    devices = _device_list(devices)
    gr, gc = net_macro_grid(net_mapping)
    splits = [None]
    top_data = max(1, min(len(devices), max(batch, 1)))
    for data in range(1, top_data + 1):
        s = mesh_split(make_macro_mesh(gr, gc, devices, data=data))
        if s is not None and s not in splits:
            splits.append(s)
    pure = (top_data, 1, 1)
    if pure[0] > 1 and pure not in splits:
        splits.append(pure)
    return tuple(splits)


def data_axis_size(mesh) -> int:
    """Size of the mesh's "data" axis (1 when absent or without a
    mesh)."""
    if mesh is None or "data" not in mesh.axis_names:
        return 1
    return int(mesh.shape["data"])


def pad_to_data_axis(batch: int, mesh) -> int:
    """Smallest batch >= ``batch`` the mesh's "data" axis divides — the
    plan batch a ragged request batch pads to."""
    d = data_axis_size(mesh)
    return -(-batch // d) * d


@functools.lru_cache(maxsize=64)
def _platform(mesh: Mesh) -> str:
    kinds = {d.type for d in mesh.device_list}
    return kinds.pop() if len(kinds) == 1 else "mixed"


def mesh_platform(mesh) -> Optional[str]:
    """Device type the mesh's devices share (``"cuda"`` or ``"cpu"``),
    ``"mixed"`` when they differ, None without a mesh.  A plan refuses a
    mesh whose platform is not its own device type."""
    if mesh is None:
        return None
    return _platform(mesh)


def mesh_tag(mesh) -> str:
    """``"2x2x1"``-style shape tag of a mesh (the CLI's ``mesh=``)."""
    return "x".join(str(s) for s in mesh.sizes)
