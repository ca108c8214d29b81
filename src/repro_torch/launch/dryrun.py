"""Multi-pod dry run: every (arch x shape x mesh) cell's step on
meta-backed ``DTensor``s over a fake 256- or 512-rank process group,
counted op by op; records the per-rank memory, cost, collectives and
roofline terms on H100 terms (port of ``repro/launch/dryrun.py``).

The JAX module lowers and compiles each cell on 512 placeholder host
devices.  The port has no compiler: it runs ``launch.shapes.build_cell``'s
step eagerly, once, on ``DTensor``s whose local shards are ``meta``
tensors (shapes and dtypes, no storage), over a
``torch.testing._internal.distributed.fake_pg`` group whose collectives
move nothing.  So nothing is allocated on any device, at full size.
``launch.op_analysis.OpCounter`` counts this rank's FLOPs, bytes and
collectives as the step runs, and ``launch.roofline`` turns them into
H100 terms.  The (2, 16, 16) mesh computes on its (32, 16) view
(``launch.sharding.compute_mesh``), as every cell does.  DTensor issues
an all-to-all on a CPU mesh as an all-gather and a chunk (gloo has
none); the dry run issues it as on the card's NCCL group, so the
collective bytes are the card's.

Run it as its own process (``python -m repro_torch.launch.dryrun ...``):
it initialises the default process group.  A cell fails loudly: its
record says ``FAIL`` with the traceback, and nothing falls back to real
tensors.

Results are cached as JSON under ``results/torch_dryrun_{opt,base}/``
keyed by (arch, shape, mesh); the sweep is restartable (skips cached
cells).

Usage:
    python -m repro_torch.launch.dryrun --arch whisper_base \\
        --shape decode_32k
    python -m repro_torch.launch.dryrun --sweep --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..configs import ARCH_IDS, canon, get_config
from ..models import common
from ..models import transformer as T
from . import roofline as rl
from . import sharding as sh
from .mesh import PRODUCTION, _device_mesh
from .op_analysis import OpCounter
from .shapes import SHAPES, build_cell, cell_supported

RESULTS = Path(__file__).resolve().parents[3] / "results"
#: what the port cannot derive on meta tensors
MEMORY_NOTE = ("argument/output bytes are this rank's local shards; an "
               "eager step has no compiled temp or code buffer, and its "
               "peak is not derived on meta tensors")


def cell_path(arch: str, shape: str, mesh_name: str,
              tag: str = "torch_dryrun") -> Path:
    return RESULTS / tag / f"{canon(arch)}__{shape}__{mesh_name}.json"


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process rank 0),
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        sh._VIEWS.clear()           # views of this group's meshes
        dist.destroy_process_group()


@contextlib.contextmanager
def nccl_all_to_all():
    """DTensor's shard-to-shard redistribution issued as the card's
    ``_dtensor.shard_dim_alltoall`` (an all-to-all) on the CPU mesh too,
    where DTensor falls back to an all-gather and a chunk for gloo.  A
    torch without that seam is left as it is."""
    from torch.distributed.tensor import placement_types
    original = getattr(placement_types, "shard_dim_alltoall", None)
    if original is None or not hasattr(torch.ops._dtensor,
                                       "shard_dim_alltoall"):
        yield
        return

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            mesh.get_group(mesh_dim).group_name)
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = original


def meta_arg(a, sharding):
    """An abstract arg (a ``meta`` tensor) as what the step takes: a
    ``DTensor`` on the sharding's ``DeviceMesh`` whose local shard is a
    ``meta`` tensor of its placement's shape."""
    local, _ = sh.local_part(a.shape, sharding.mesh, sharding.placements)
    return sh.from_local(torch.empty(local, dtype=a.dtype, device="meta"),
                         sharding.mesh, sharding.placements, a.shape)


def meta_args(shape, args, in_shardings):
    """:func:`meta_arg` over a cell's args; a decode position is the
    cache's last slot, as ``launch.shapes.materialize`` sets it."""
    real = sh._zip_map(meta_arg, args, in_shardings)
    if shape.mode == "decode":
        real = tuple(real[:3]) + (shape.seq - 1,)
    return real


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of a tree's tensors."""
    from torch.distributed.tensor import DTensor
    n = 0
    for x in T.tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x._local_tensor
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n


def count_cell(cfg, shape, mesh, *, optimized: bool = True,
               microbatches: Optional[int] = None):
    """(CostTotals, argument bytes, output bytes, seconds) of one run of
    the cell's step on meta args over ``mesh``."""
    fn, args, ins, _ = build_cell(cfg, shape, mesh, optimized=optimized,
                                  microbatches=microbatches)
    real = meta_args(shape, args, ins)
    t0 = time.time()
    with nccl_all_to_all(), OpCounter("meta") as counter:
        out = fn(*real)
    return (counter.totals, local_bytes(real), local_bytes(out),
            time.time() - t0)


def terms(cfg, shape, totals, chips: int) -> rl.RooflineTerms:
    n_params = T.count_params(cfg)
    n_active = T.count_params(cfg, active_only=True)
    return rl.RooflineTerms(
        flops_per_chip=totals.flops, bytes_per_chip=totals.hbm_bytes,
        coll_link_bytes=dict(totals.coll_link_bytes), chips=chips,
        model_flops_total=rl.model_flops(cfg, shape, n_params, n_active),
        compute_dtype=rl.dtype_name(common.COMPUTE_DTYPE))


def _top(d: dict, n: int = 12) -> dict:
    return dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             force: bool = False, optimized: bool = True,
             tag: str = "torch_dryrun", *,
             mesh_shape: Optional[Sequence[int]] = None,
             smoke: bool = False, seq: Optional[int] = None,
             batch: Optional[int] = None, write: bool = True) -> dict:
    """The cell's record, from the cache unless ``force`` (``write``
    False: neither read nor written).  The JAX module's cells are (arch,
    shape, single or multi pod); the port's also take another ("data",
    "model") ``mesh_shape``, the ``smoke`` config, and another ``seq`` or
    ``batch`` (named in the record's file)."""
    if mesh_shape is None:
        dims, axes = PRODUCTION[bool(multi_pod)]
    else:
        dims = tuple(int(d) for d in mesh_shape)
        axes = PRODUCTION[len(dims) == 3][1]
    mesh_name = "x".join(str(d) for d in dims)
    cut = "".join(f"-{k}{v}" for k, v in (
        ("smoke", "" if smoke else None), ("seq", seq), ("batch", batch))
        if v is not None)
    out_path = cell_path(arch, shape_name + cut, mesh_name, tag)
    if write and out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, seq=seq or shape.seq,
                                batch=batch or shape.batch)
    record = {"arch": arch, "shape": shape_name + cut, "mesh": mesh_name,
              "status": "?", "ts": time.time()}
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        record.update(status="SKIP", reason=reason)
        if write:
            _write(out_path, record)
        return record

    try:
        chips = math.prod(dims)
        with fake_group(chips):
            mesh = _device_mesh(dims, axes, "cpu")
            totals, arg_b, out_b, run_s = count_cell(
                cfg, shape, mesh, optimized=optimized)
        coll = dict(totals.coll_bytes)
        rt = terms(cfg, shape, totals, chips)
        record.update(
            status="OK", run_s=round(run_s, 1), chips=chips,
            n_params=T.count_params(cfg),
            n_active_params=T.count_params(cfg, active_only=True),
            memory={"argument_bytes": arg_b, "output_bytes": out_b,
                    "temp_bytes": None, "code_bytes": None,
                    "note": MEMORY_NOTE},
            cost={"flops": totals.flops, "bytes accessed": totals.hbm_bytes},
            collectives=coll,
            collective_links=dict(totals.coll_link_bytes),
            ops=totals.ops,
            hbm_by_group=_top(totals.hbm_by_group),
            coll_by_group=_top(totals.coll_by_group),
            flops_by_group=_top(totals.flops_by_group),
            roofline={
                "t_compute": rt.t_compute,
                "t_memory": rt.t_memory,
                "t_collective": rt.t_coll,
                "dominant": rt.dominant,
                "model_flops": rt.model_flops_total,
                "useful_flops_fraction": rt.useful_flops_fraction,
                "roofline_fraction": rt.roofline_fraction,
                "compute_dtype": rt.compute_dtype,
                "constants": "NVIDIA H100 SXM5 80GB data sheet "
                             "(launch/roofline.py), analytic",
            },
        )
    except Exception as e:   # record failures — they are bugs to fix
        record.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    if write:
        _write(out_path, record)
    return record


def _write(path: Path, record: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(record, indent=1, default=str))
    tmp.rename(path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="disable beyond-paper optimizations (SPerf)")
    ap.add_argument("--tag", default=None,
                    help="results subdir (default torch_dryrun_opt/"
                         "torch_dryrun_base)")
    args = ap.parse_args(argv)
    tag = args.tag or ("torch_dryrun_base" if args.baseline
                       else "torch_dryrun_opt")

    archs = ARCH_IDS if (args.sweep or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.sweep or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                t0 = time.time()
                r = run_cell(arch, shape, mp, force=args.force,
                             optimized=not args.baseline, tag=tag)
                dom = r.get("roofline", {}).get("dominant", "-")
                print(f"{arch:22s} {r['shape']:12s} {r['mesh']:8s} "
                      f"{r['status']:4s} dom={dom:10s} "
                      f"({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
