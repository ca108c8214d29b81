"""The port's side of test_torch_lm_mesh.py: gloo ranks on the CPU, one
process a rank, each building a ``DeviceMesh`` through
``launch.mesh._device_mesh`` (the helper ``make_production_mesh`` uses)
and running ``launch.shapes.build_cell``'s cells on ``DTensor``s.

Each rank writes its local shards, keyed ``<leaf path>@<coordinate>``,
and the whole outputs to ``<out>/rank<r>.npz``; the test holds them to
the JAX package's shards at the same mesh coordinate.  This module
imports no JAX: the ranks import it by name."""
import contextlib
import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

#: the cases: mesh shape and axes, config, (seq, batch) of the train
#: cell (2 microbatches) and, where given, of a prefill cell.  qwen's 8
#: smoke heads do not divide a model axis of 3, so its train cell takes
#: the context-parallel path (seq 24: 3 divides the q rows) and its
#: attention params the head_dim fallback; mixtral's train cell on the
#: pod mesh gathers its experts at use.  On (2, 2) the train cell runs
#: once more without its policies ("baseline": f32 scores)
CASES = {
    "2x2": {"shape": (2, 2), "axes": ("data", "model"),
            "arch": "stablelm_1_6b", "train": (16, 4), "prefill": (16, 4),
            "baseline": True},
    "2x1x2": {"shape": (2, 1, 2), "axes": ("pod", "data", "model"),
              "arch": "mixtral_8x7b", "train": (16, 4)},
    "1x3": {"shape": (1, 3), "axes": ("data", "model"),
            "arch": "qwen1_5_32b", "train": (24, 4)},
}
MICROBATCHES = 2
SEED = 0
#: the decode cases (test_torch_lm_mesh_decode.py), all on one (1, 4)
#: ("data", "model") mesh: (seq, batch) of the decode cell.  mixtral's 2
#: smoke kv heads do not divide "model" (its ring cache of the 16-token
#: window views the heads); mamba2 decodes at batch 1, so nothing splits
#: over "data" and the greedy token is an argmax over vocab-split logits.
#: The caches split their sequence over "model", which the split-keys
#: decode keeps: mixtral's ring, whisper-base's self and cross caches,
#: deepseek-v2-lite's compressed MLA cache
DECODE_MESH = {"shape": (1, 4), "axes": ("data", "model")}
DECODE_CASES = {"mixtral_8x7b": (64, 4), "mamba2_130m": (64, 1),
                "whisper_base": (64, 4), "deepseek_v2_lite_16b": (64, 4)}
#: the train state restored onto the 2x2 mesh of the same four ranks
RESTORE_ARCH = "stablelm_1_6b"
#: the families held in test_torch_lm_mesh_families.py, each on a (2, 2)
#: ("data", "model") mesh (so the weights are gathered over "data" at
#: use): (seq, batch) of the train cell (2 microbatches) and the
#: prefill.  deepseek-v2-lite's MLA and its MoE (local experts: d_ff
#: split under the train cell's policy, the experts split in the
#: prefill); whisper-base's encoder and cross-attention; mamba2's SSD
#: (seq a multiple of its 32-token chunk); recurrentgemma's RG-LRU
#: beside windowed MQA, whose one kv head "model" does not divide (the
#: query heads split, each rank reading the kv head); internvl2's vision
#: prefix (8 of the seq's positions).  Two launches of four ranks ("a",
#: "b") at once
FAMILY_MESH = {"shape": (2, 2), "axes": ("data", "model")}
FAMILY_CASES = {
    "deepseek_v2_lite_16b": {"launch": "a", "train": (16, 4),
                             "prefill": (16, 4)},
    "whisper_base": {"launch": "a", "train": (16, 4), "prefill": (16, 4)},
    "mamba2_130m": {"launch": "b", "train": (32, 4), "prefill": (32, 4)},
    "recurrentgemma_9b": {"launch": "b", "train": (16, 4),
                          "prefill": (16, 4)},
    "internvl2_26b": {"launch": "b", "train": (16, 4), "prefill": (16, 4)},
}


#: the SSD chunks of mamba2's prefill on the (2, 2) mesh, each through
#: ssd_chunk's local-shard route against ssd_chunk_plain's DTensor ops
#: (tolerance relative to each output's max): the chunk's inputs as the
#: cell placed them, and redistributed to the heads split over "model"
#: with the batch over "data"; and three cases of synthetic inputs
#: (x (B, S, H, P), G groups, chunk) that the route redistributes first:
#: heads that straddle a group (6 heads in 3 groups, 3 a rank), an
#: uneven batch split (3 over "data") and a Partial over "data" (each
#: rank on it holding half of x)
SSD_RTOL = 1e-6
SSD_SYNTHETIC = {"straddling": ((4, 32, 6, 8), 3, 16),
                 "uneven": ((3, 32, 6, 8), 1, 16),
                 "partial": ((4, 32, 4, 8), 1, 16)}
SSD_CASES = ("as_placed", "heads_over_model", *SSD_SYNTHETIC)


def family_archs(launch: str) -> list:
    """The families launch ``launch`` runs."""
    return [a for a, c in FAMILY_CASES.items() if c["launch"] == launch]


def family_case(arch: str) -> dict:
    """A family's case as :func:`cell` takes it."""
    return {"arch": arch, **FAMILY_MESH, **FAMILY_CASES[arch]}


def f32_compute():
    """Both packages' compute type switched to f32 (the tests' tight
    comparisons); the cells' policies keep their bf16 scores."""
    import repro_torch.models.common as common
    common.COMPUTE_DTYPE = torch.float32


def cell(case: dict, mode: str, mesh, optimized: bool = True,
         weights=None):
    """(fn, placed args, config) of the case's cell on ``mesh``; the
    params drawn from ``SEED``, or carried from ``weights`` (numpy)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import shapes
    cfg = get_config(case["arch"], smoke=True)
    seq, batch = case[mode]
    spec = shapes.ShapeSpec(f"smoke_{mode}", seq, batch, mode)
    fn, args, ins, _ = shapes.build_cell(
        cfg, spec, mesh, optimized=optimized,
        microbatches=MICROBATCHES if mode == "train" else None)
    return fn, shapes.materialize(cfg, spec, args, ins, seed=SEED,
                                  weights=weights), cfg


def local_shards(prefix: str, tree, out: dict) -> None:
    """Each DTensor leaf's local shard under ``<prefix>/<path>@<coord>``
    (paths spelled as the checkpoints spell them)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.store import _flatten
    for key, leaf in _flatten(tree):
        if isinstance(leaf, DTensor):
            coord = ",".join(str(c) for c in leaf.device_mesh.get_coordinate())
            out[f"{prefix}/{key}@{coord}"] = leaf.to_local().detach().float(
                ).numpy()


def whole(prefix: str, tree, out: dict) -> None:
    """Each leaf whole (a collective for a DTensor) under
    ``<prefix>/<path>``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.store import _flatten
    for key, leaf in _flatten(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if isinstance(leaf, torch.Tensor):
            out[f"{prefix}/{key}"] = leaf.detach().float().numpy()


def _ssd_gap(mesh, args: tuple, chunk: int) -> tuple:
    """(worst gap relative to each output's max, bitwise, the placements
    the route ran on) of ``ssd_chunk`` (the local-shard route) against
    ``ssd_chunk_plain`` on the same DTensors (its DTensor ops, under the
    cells' ``spmd``; an uneven split gathered first, as DTensor flattens
    none)."""
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch import sharding as sh
    x, _, _, b, _ = args
    ran = sc.local_placements(x.placements, mesh.shape, x.shape[0],
                              x.shape[2], b.shape[2])
    even = []
    for t in args:
        for dim in (0, 2)[:t.ndim]:
            t = sh.gather_uneven(t, dim)
        even.append(t)
    with sh.spmd(mesh):
        got = sc.ssd_chunk(*args, chunk=chunk)
        want = sc.ssd_chunk_plain(*even, chunk=chunk)
    worst, same = 0.0, True
    for g, w in zip(got, want):
        g, w = g.full_tensor(), w.full_tensor()
        same = same and bool(torch.equal(g, w))
        worst = max(worst, float((g - w).abs().max() / w.abs().max()))
    return worst, same, str(ran)


def _ssd_synthetic(mesh, shape: tuple, groups: int, name: str) -> tuple:
    """The inputs of a synthetic SSD case, the same values on every rank
    (a generator seeded from ``SEED``), placed as the case says."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch import sharding as sh
    bsz, s, h, p = shape
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(shape, generator=g)
    dt = torch.rand((bsz, s, h), generator=g) * 0.5
    a_log = torch.randn(h, generator=g) * 0.5
    b, c = (torch.randn((bsz, s, groups, p), generator=g) for _ in "bc")
    heads = {"straddling": [Shard(0), Shard(2)],
             "uneven": [Shard(0), Shard(2)],
             "partial": [Replicate(), Shard(2)]}[name]
    rest = [Shard(0), Replicate()]

    def placed(full, pl):
        local, off = sh.local_part(full.shape, mesh, pl)
        part = full[tuple(slice(o, o + n) for o, n in zip(off, local))]
        return sh.from_local(part, mesh, pl, full.shape)
    xd = placed(x, heads)
    if name == "partial":           # half of x on each rank over "data"
        xd = sh.from_local(xd.to_local() * 0.5, mesh,
                           [Partial(), heads[1]], x.shape)
    return (xd, placed(dt, heads), placed(a_log, [Replicate()] * 2),
            placed(b, rest), placed(c, rest))


def _ssd_checks(mesh, recorded: list, got: dict, prefix: str) -> None:
    """Each case of ``SSD_CASES`` under ``<prefix>/ssd/<case>``: the gap
    and bitwise flag, and the placements the route ran on; the recorded
    chunks (``(args, chunk)`` of the prefill's calls) give the first
    two, the worst over the calls."""
    from torch.distributed.tensor import Shard
    from repro_torch.launch.sharding import move
    cases = {"as_placed": [(a, k) for a, k in recorded],
             "heads_over_model": [
                 ((move(x, [Shard(0), Shard(2)]),
                   move(dt, [Shard(0), Shard(2)]), a_log, b, c), k)
                 for (x, dt, a_log, b, c), k in recorded]}
    for name, (shape, groups, chunk) in SSD_SYNTHETIC.items():
        cases[name] = [(_ssd_synthetic(mesh, shape, groups, name), chunk)]
    for name, calls in cases.items():
        gaps = [_ssd_gap(mesh, args, chunk) for args, chunk in calls]
        got[f"{prefix}/ssd/{name}/gap"] = np.array(
            [max(g for g, _, _ in gaps), all(s for _, s, _ in gaps)])
        got[f"{prefix}/ssd/{name}/placements"] = np.array(
            sorted({pl for _, _, pl in gaps}))


@contextlib.contextmanager
def without_flip_strategy():
    """DTensor without a sharding strategy for ``aten.flip``, as the torch
    the card runs (2.11) ships it: this torch's entries for it taken out
    of the propagator (and its cache cleared), then put back.  A
    ``DTensor`` flip then raises ``NotImplementedError``, as there."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.flip.default
    saved = {}
    for name in ("op_strategy_funcs", "op_single_dim_strategy_funcs",
                 "op_to_schema_info_for_single_dim_strategy", "op_to_rules",
                 "op_to_schema_info"):
        table = getattr(prop, name, None)
        if isinstance(table, dict) and op in table:
            saved[name] = table.pop(op)
    prop.propagate_op_sharding.cache_clear()
    try:
        yield
    finally:
        for name, entry in saved.items():
            getattr(prop, name)[op] = entry
        prop.propagate_op_sharding.cache_clear()


def _init(rank: int, world: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)


def _step_rank(rank: int, world: int, name: str, out: str) -> None:
    from repro_torch.launch import mesh as M
    from repro_torch.models import attention
    case = CASES[name]
    _init(rank, world, out)
    f32_compute()
    mesh = M._device_mesh(case["shape"], case["axes"], "cpu")
    # record the context-parallel redistributes the cell makes
    cp_placements = []
    original = attention._cp_constrain

    def recording(qb, k, v):
        qb, k, v = original(qb, k, v)
        if attention._CP_AXIS.get() is not None:
            cp_placements.append(str(qb.placements))
        return qb, k, v
    attention._cp_constrain = recording
    got = {}
    fn, (state, batch), cfg = cell(case, "train", mesh)
    local_shards("in/state", state, got)
    local_shards("in/batch", batch, got)
    new_state, metrics = fn(state, batch)
    local_shards("out/state", new_state, got)
    whole("out/state", new_state, got)
    whole("out/metrics", metrics, got)
    if case.get("baseline"):
        fn, args, _ = cell(case, "train", mesh, optimized=False)
        base_state, base_metrics = fn(*args)
        whole("base/state", base_state, got)
        whole("base/metrics", base_metrics, got)
    if "prefill" in case:
        # the params as numpy from the test's weights checkpoint (the
        # values the JAX run restores), placed leaf by leaf
        from repro_torch.checkpoint import restore_checkpoint
        from repro_torch.models.transformer import init_params, tree_map
        like = {"params": init_params(cfg, device="meta")}
        saved, _, _ = restore_checkpoint(
            Path(out).parent / f"weights_{case['arch']}", like, device="cpu")
        weights = tree_map(lambda t: t.numpy(), saved["params"])
        fn, (params, pbatch), _ = cell(case, "prefill", mesh,
                                       weights=weights)
        local_shards("in/prefill_batch", pbatch, got)
        token, cache = fn(params, pbatch)
        local_shards("out/cache", cache, got)
        whole("out/token", {"t": token}, got)
        whole("out/cache", cache, got)
    from repro_torch.checkpoint import save_checkpoint
    save_checkpoint(f"{out}/ckpt", 1, new_state)
    np.savez(f"{out}/rank{rank}.npz", **got)
    meta = {"coord": mesh.get_coordinate(), "cp": cp_placements}
    Path(f"{out}/rank{rank}.json").write_text(json.dumps(meta))
    dist.destroy_process_group()


def _restore_rank(rank: int, world: int, name: str, out: str) -> None:
    """Restore the checkpoint the case's step launch saved (in
    ``<out>/../port_<name>/ckpt``) onto ``derive_elastic_mesh(world,
    model_parallel=2)``'s mesh."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import init_train_state
    from repro_torch.runtime.recovery import derive_elastic_mesh
    case = CASES[name]
    _init(rank, world, out)
    plan = derive_elastic_mesh(world, model_parallel=2)
    mesh = M._device_mesh(plan.shape, plan.axes, "cpu")
    cfg = get_config(case["arch"], smoke=True)
    like = init_train_state(cfg, None, "meta")
    psh = sh.param_shardings(cfg, like["params"], mesh)
    shardings = {"params": psh, "opt": sh.opt_shardings(psh, mesh)}
    state, step, _ = restore_checkpoint(
        Path(out).parent / f"port_{name}" / "ckpt", like, shardings=shardings)
    got = {}
    local_shards("restored", state, got)
    whole("restored", state, got)
    np.savez(f"{out}/rank{rank}.npz", **got)
    meta = {"coord": mesh.get_coordinate(), "step": step,
            "shape": list(plan.shape), "axes": list(plan.axes)}
    Path(f"{out}/rank{rank}.json").write_text(json.dumps(meta))
    dist.destroy_process_group()


def decode_cell(arch: str, mesh, out: str):
    """(fn, placed args) of ``arch``'s smoke decode cell on ``mesh``: the
    params, f32 cache and token the test saved (``weights_<arch>``,
    ``decode_<arch>.npz``), each rank sending only its shards to its
    device (``sharding.place_host``)."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.configs import get_config
    from repro_torch.launch import shapes
    from repro_torch.launch import sharding as sh
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import tree_unflatten
    cfg = get_config(arch, smoke=True)
    seq, batch = DECODE_CASES[arch]
    spec = shapes.ShapeSpec("smoke_decode", seq, batch, "decode")
    fn, args, ins, _ = shapes.build_cell(cfg, spec, mesh)
    like = {"params": init_params(cfg, device="meta")}
    params, _, _ = restore_checkpoint(Path(out).parent / f"weights_{arch}",
                                      like, shardings={"params": ins[0]})
    data = np.load(Path(out).parent / f"decode_{arch}.npz")
    cache = tree_unflatten(args[1], [
        sh.place_host(data[f"cache/{k}"], s)
        for (k, _), (_, s) in zip(_flatten(args[1]), _flatten(ins[1]))])
    token = sh.place_host(data["token"], ins[2])
    return fn, (params["params"], cache, token, seq - 1)


def _decode_rank(rank: int, world: int, name: str, out: str) -> None:
    """The decode cases on the (1, 4) mesh, then the restore of the
    test's train state onto a (2, 2) mesh of the same ranks, counting
    what reaches ``sharding.place`` and ``DTensor.from_local``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import init_train_state
    _init(rank, world, out)
    f32_compute()
    got = {}
    mesh = M._device_mesh(DECODE_MESH["shape"], DECODE_MESH["axes"], "cpu")
    for arch in DECODE_CASES:
        fn, args = decode_cell(arch, mesh, out)
        token, cache = fn(*args)
        whole(f"{arch}/token", {"t": token}, got)
        whole(f"{arch}/cache", cache, got)
        local_shards(f"{arch}/cache", cache, got)
    mesh22 = M._device_mesh((2, 2), ("data", "model"), "cpu")
    cfg = get_config(RESTORE_ARCH, smoke=True)
    like = init_train_state(cfg, None, "meta")
    psh = sh.param_shardings(cfg, like["params"], mesh22)
    placed, built = [], []
    place, from_local = sh.place, DTensor.from_local
    sh.place = lambda x, s: (placed.append(list(x.shape)), place(x, s))[1]
    DTensor.from_local = staticmethod(lambda local, *a, **k: (
        built.append([list(local.shape), list(k["shape"])]),
        from_local(local, *a, **k))[1])
    try:
        state, step, _ = restore_checkpoint(
            Path(out).parent / "restore_ckpt", like,
            shardings={"params": psh, "opt": sh.opt_shardings(psh, mesh22)})
    finally:
        sh.place, DTensor.from_local = place, from_local
    local_shards("restored", state, got)
    whole("restored", state, got)
    np.savez(f"{out}/rank{rank}.npz", **got)
    meta = {"coord": mesh.get_coordinate(),
            "coord22": mesh22.get_coordinate(), "step": step,
            "placed": placed, "built": built}
    Path(f"{out}/rank{rank}.json").write_text(json.dumps(meta))
    dist.destroy_process_group()


def _family_cells(arch: str, mesh, out: str, got: dict, recorded: list,
                  local_calls: list) -> None:
    """One family's train step and prefill on ``mesh`` into ``got``
    (:func:`_families_rank`)."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models.transformer import init_params, tree_map
    case = family_case(arch)
    fn, (state, batch), cfg = cell(case, "train", mesh)
    like = {"params": init_params(cfg, device="meta")}
    saved, _, _ = restore_checkpoint(
        Path(out).parent / f"weights_{arch}", like, device="cpu")
    weights = tree_map(lambda t: t.numpy(), saved["params"])
    local_shards(f"{arch}/in/state", state, got)
    local_shards(f"{arch}/in/batch", batch, got)
    new_state, metrics = fn(state, batch)
    local_shards(f"{arch}/out/state", new_state, got)
    whole(f"{arch}/out/state", new_state, got)
    whole(f"{arch}/out/metrics", metrics, got)
    fn, (params, pbatch), _ = cell(case, "prefill", mesh, weights=weights)
    local_shards(f"{arch}/in/prefill_batch", pbatch, got)
    recorded.clear()
    local_calls.clear()
    token, cache = fn(params, pbatch)
    got[f"{arch}/ssd/calls"] = np.array([len(recorded), len(local_calls)])
    if recorded:
        _ssd_checks(mesh, recorded, got, arch)
    local_shards(f"{arch}/out/cache", cache, got)
    whole(f"{arch}/out/token", {"t": token}, got)
    whole(f"{arch}/out/cache", cache, got)


def _families_rank(rank: int, world: int, name: str, out: str) -> None:
    """The families of launch ``name`` (``FAMILY_CASES``) one after
    another on the (2, 2) mesh, as :func:`_step_rank` runs a case: the
    train step on the params drawn from ``SEED`` (placed block by block),
    then the prefill on the same params carried as numpy from the test's
    checkpoint (``weights_<arch>``); every key under ``<arch>/``.  The
    prefill's SSD chunks (mamba2) are recorded and checked on the
    local-shard route (:func:`_ssd_checks`), with the count of chunks
    and of the route's calls under ``<arch>/ssd/calls``."""
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch import mesh as M
    from repro_torch.models import ssm
    _init(rank, world, out)
    f32_compute()
    mesh = M._device_mesh(FAMILY_MESH["shape"], FAMILY_MESH["axes"], "cpu")
    got = {}
    # record the prefill's SSD chunks and the local-shard route's calls
    recorded, local_calls = [], []
    chunk_fn, local_fn = ssm.ssd_chunk, sc.ssd_chunk_local

    def recording(x, dt, a_log, b, c, *, chunk):
        recorded.append(((x, dt, a_log, b, c), chunk))
        return chunk_fn(x, dt, a_log, b, c, chunk=chunk)

    def counting(*a, **k):
        local_calls.append(1)
        return local_fn(*a, **k)
    ssm.ssd_chunk, sc.ssd_chunk_local = recording, counting
    # the card's torch (2.11) has no DTensor strategy for flip, which
    # cumsum's backward reaches: neither has this run
    with without_flip_strategy():
        for arch in family_archs(name):
            _family_cells(arch, mesh, out, got, recorded, local_calls)
    np.savez(f"{out}/rank{rank}.npz", **got)
    Path(f"{out}/rank{rank}.json").write_text(
        json.dumps({"coord": mesh.get_coordinate()}))
    dist.destroy_process_group()


WORKERS = {"step": _step_rank, "restore": _restore_rank,
           "decode": _decode_rank, "families": _families_rank}


def _entry(rank: int, world: int, kind: str, name: str, out: str) -> None:
    try:
        WORKERS[kind](rank, world, name, out)
    except BaseException:
        Path(f"{out}/rank{rank}.err").write_text(traceback.format_exc())
        raise


def start(kind: str, name: str, world: int, out):
    """Start ``world`` gloo ranks of ``kind`` ("step", "restore" or
    "decode") for the case ``name`` into ``out``; :func:`finish` waits
    for them, so launches that do not depend on each other run at
    once."""
    import torch.multiprocessing as mp
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "store").unlink(missing_ok=True)     # a fresh rendezvous
    ctx = mp.start_processes(_entry, args=(world, kind, name, str(out)),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, kind, name, world, out


def finish(launched) -> list:
    """Wait for a :func:`start`'s ranks; returns each rank's (npz,
    meta)."""
    ctx, kind, name, world, out = launched
    try:
        while not ctx.join():
            pass
    except Exception as e:
        errs = [p.read_text() for p in sorted(out.glob("rank*.err"))]
        raise AssertionError(f"{kind} {name}: a rank failed:\n"
                             + "\n".join(errs)) from e
    return [(dict(np.load(out / f"rank{r}.npz")),
             json.loads((out / f"rank{r}.json").read_text()))
            for r in range(world)]


def launch(kind: str, name: str, world: int, out) -> list:
    """:func:`start` and :func:`finish` in one."""
    return finish(start(kind, name, world, out))


if __name__ == "__main__":          # one case by hand: kind name world out
    sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src")]
    launch(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
    print("ok", os.listdir(sys.argv[4]))
