"""The port's dry run (repro_torch.launch.dryrun) and the production-mesh
repairs it needs, on fake process groups in-process (as
test_torch_sharding.py's ``fake_group``).

``run_cell`` runs a cell's step on meta-backed ``DTensor``s: nothing is
allocated, at full size.  Three cells that failed before the repairs:
mixtral-8x7b smoke decode on a (1, 4) ("data", "model") group, whose 2
kv heads do not divide "model" (the ring decode's head view); mamba2
smoke decode at batch 1 there (the greedy argmax over vocab-split
logits); and whisper-base decode_32k at full size on the 256-rank pod,
whose 8 heads take the head_dim fallback (the q/k/v projections).  The
full-size train cells stay out of the test run (stablelm's takes
minutes).  A checkpoint restored onto a fake 2x2 mesh sends each rank
only its shard: no leaf passes whole through ``sharding.place`` or to a
device.  test_torch_lm_mesh_decode.py holds the repaired cells' values
to the JAX package on gloo ranks."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import dryrun                           # noqa: E402
from repro_torch.launch import mesh as t_mesh                   # noqa: E402
from repro_torch.launch import sharding as sh                   # noqa: E402


def _ok(record: dict) -> dict:
    assert record["status"] == "OK", record.get("traceback", record)
    return record


@pytest.mark.parametrize("arch,batch", [("mixtral_8x7b", 4),
                                        ("mamba2_130m", 1)])
def test_smoke_decode_on_a_model_axis_of_four(arch, batch):
    """The decode cell on a fake (1, 4) group: mixtral's 2 kv heads and
    mamba2's batch 1 ran into DTensor's refusals before the repairs; both
    are counted now, and the greedy token is the first maximum over the
    vocab-split shards."""
    r = _ok(dryrun.run_cell(arch, "decode_32k", mesh_shape=(1, 4),
                            smoke=True, seq=64, batch=batch, write=False))
    assert r["mesh"] == "1x4" and r["chips"] == 4
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes accessed"] > 0
    assert r["collectives"]["total"] > 0
    assert r["memory"]["temp_bytes"] is None and r["memory"]["note"]
    assert "steps._sharded_argmax" in r["coll_by_group"]


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_ssd_cells_with_heads_split_unevenly(shape):
    """mamba2 smoke's 4 SSD heads on a 3-way "model" axis: DTensor will
    not flatten the uneven split in the chunked scan's einsums, so
    ``ssd_chunked`` gathers the heads first; the prefill's ``ssd_chunk``
    takes its plain version on meta tensors (no kernel there)."""
    r = _ok(dryrun.run_cell("mamba2_130m", shape, mesh_shape=(1, 3),
                            smoke=True, seq=64, batch=2, write=False))
    assert r["cost"]["flops"] > 0


def test_whisper_decode_32k_at_full_size_on_the_pod():
    """whisper-base decode_32k on the (16, 16) pod of a fake 256-rank
    group at full size: its 8 heads take the head_dim fallback, which the
    q/k/v projections now compute on local shards.  The record carries
    the JAX module's keys, the H100 roofline and no allocation: the
    arguments are this rank's shards."""
    from repro_torch.launch import roofline as rl
    r = _ok(dryrun.run_cell("whisper_base", "decode_32k", write=False))
    assert r["mesh"] == "16x16" and r["chips"] == 256
    for key in ("n_params", "n_active_params", "memory", "cost",
                "collectives", "roofline"):
        assert key in r
    f = r["roofline"]
    assert f["t_compute"] == pytest.approx(
        r["cost"]["flops"] / rl.PEAK_FLOPS["bf16"])
    assert f["t_memory"] == pytest.approx(
        r["cost"]["bytes accessed"] / rl.HBM_BW)
    assert f["t_collective"] == pytest.approx(
        r["collective_links"]["network"] / rl.LINK_BW["network"])
    assert f["dominant"] in ("compute", "memory", "collective")
    assert "attention._local_product" in r["flops_by_group"]
    # the cache dominates the arguments: (U, 128, 32768, 8, 64) k and v
    # bf16 of the decoder's 6 units split 16 ways over "data" and "model"
    cache = 2 * 2 * 6 * 128 * 32768 * 8 * 64 * 2 // 256
    assert cache < r["memory"]["argument_bytes"] < 2 * cache
    # the split-keys decode: each rank attends to its shard of the cache
    # (self and cross), so the all-gathers a token are the weights' and
    # the small vectors', not the cache (6.4 GB before the repair)
    assert r["collectives"]["all-gather"] < 0.01 * cache
    assert "attention._attend_block" in r["coll_by_group"]
    json.dumps(r)


def _collectives(monkeypatch):
    """Record every collective the op counter sees as (kind, the ranks
    of its group, output bytes)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from repro_torch.launch import op_analysis as oa
    seen = []
    original = oa.OpCounter._collective

    def record(self, kind, func, args, kwargs, out):
        group = [a for a in list(args) + list(kwargs.values())
                 if isinstance(a, (str, dist.ProcessGroup))][-1]
        pg = (_resolve_process_group(group) if isinstance(group, str)
              else group)
        seen.append((kind, tuple(dist.get_process_group_ranks(pg)),
                     sum(t.numel() * t.element_size()
                         for t in oa._tensors(out))))
        return original(self, kind, func, args, kwargs, out)
    monkeypatch.setattr(oa.OpCounter, "_collective", record)
    return seen


SMOKE_TRAIN = dict(smoke=True, seq=64, batch=8, write=False)


@pytest.mark.parametrize("arch,mesh_shape", [
    ("stablelm_1_6b", (2, 2)), ("stablelm_1_6b", (4, 1)),
    ("deepseek_v2_lite_16b", (4, 1))])
def test_fsdp_gathers_the_weights_at_use(arch, mesh_shape, monkeypatch):
    """The stablelm smoke train cell on fake (2, 2) and (4, 1) groups:
    each unit's weights, the embedding and the head are gathered over
    "data" at use (``sharding.gather_fsdp``), so the ranks share the
    work: counted FLOPs a rank x chips within 1.3x of the (1, 1) count
    (before the repair 1.23x and 1.91x, each rank multiplying whole
    microbatches against d_model slices), and no all-reduce over the
    data axis has an activation's size (the products' partial sums).
    deepseek-v2-lite's experts too: the MoE policy's own gather moves
    only their "model" split after the FSDP gather (gathering them
    again made the backward all-reduce every expert's gradient)."""
    one = _ok(dryrun.run_cell(arch, "train_4k", mesh_shape=(1, 1),
                              **SMOKE_TRAIN))
    seen = _collectives(monkeypatch)
    r = _ok(dryrun.run_cell(arch, "train_4k", mesh_shape=mesh_shape,
                            **SMOKE_TRAIN))
    assert r["cost"]["flops"] * r["chips"] <= 1.3 * one["cost"]["flops"]
    cfg = get_config(arch, smoke=True)
    data, model = mesh_shape
    # rank 0's data group: ranks 0, model, 2 model, ...
    data_group = tuple(range(0, data * model, model))
    activation = 8 * 64 // data * cfg.d_model * 2      # bf16 (B, S, D)
    reduces = [b for kind, ranks, b in seen
               if kind == "all-reduce" and ranks == data_group]
    assert max(reduces, default=0) < activation, sorted(reduces)[-4:]
    assert any(kind == "reduce-scatter" and ranks == data_group
               for kind, ranks, _ in seen)        # the gradients


def test_query_heads_split_past_the_kv_heads(monkeypatch):
    """mixtral smoke's 8 query heads on a 4-way "model" axis that does not
    divide its 2 kv heads, train cell on a fake (2, 4) group: each rank
    attends with its 2 query heads to the kv head they read, on local
    tensors (``attention._local_heads``); DTensor could not view the
    split heads as (kv heads, group), gathered them forward and refused
    the gradient's view back (the pod's train_4k cells of mixtral,
    deepseek-67b, internvl2 and mistral-large once the weights were
    gathered).  Counted FLOPs a rank x chips within 1.3x of one
    device's."""
    from repro_torch.models import attention
    calls = []
    original = attention._local_heads
    monkeypatch.setattr(attention, "_local_heads", lambda *a, **k: (
        calls.append(1), original(*a, **k))[1])
    kw = dict(smoke=True, seq=16, batch=4, write=False)
    one = _ok(dryrun.run_cell("mixtral_8x7b", "train_4k", mesh_shape=(1, 1),
                              **kw))
    assert not calls
    r = _ok(dryrun.run_cell("mixtral_8x7b", "train_4k", mesh_shape=(2, 4),
                            **kw))
    assert calls
    assert r["cost"]["flops"] * r["chips"] <= 1.3 * one["cost"]["flops"]


@pytest.mark.parametrize("mesh_shape,seq", [((1, 8), 36), ((2, 8), 20)])
def test_moe_on_local_experts_with_the_capacity_split_unevenly(mesh_shape,
                                                               seq):
    """The deepseek-v2-lite smoke train cell on a fake group whose
    "model" axis does not divide the MoE capacity (one chunk of seq
    tokens: 36 or 20 slots on 8 ranks) but divides d_ff: each rank routes
    every token and runs its d_ff slice on local tensors
    (``moe._local_experts``).  DTensor's own combine einsum split the
    capacity unevenly and refused to flatten it (the dry run's one FAIL,
    train_4k on the pod)."""
    from repro_torch.models.moe import capacity
    cfg = get_config("deepseek_v2_lite_16b", smoke=True)
    assert capacity(cfg.moe, min(cfg.moe.chunk, seq)) % mesh_shape[1]
    assert cfg.moe.d_ff % mesh_shape[1] == 0
    r = _ok(dryrun.run_cell("deepseek_v2_lite_16b", "train_4k",
                            mesh_shape=mesh_shape, smoke=True, seq=seq,
                            batch=4, write=False))
    assert "moe.expert_ffn" in r["flops_by_group"]


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "deepseek_v2_lite_16b"])
def test_gradients_keep_their_params_placements(arch, monkeypatch):
    """On a fake (2, 2) group the train step's gradients reach AdamW with
    each parameter's placements (the optimizer state is placed alike):
    the FSDP gather's backward reduce-scatters them back over "data",
    and the local experts' partial gradients are reduced to their
    weights' placements."""
    import dataclasses
    from repro_torch.launch import shapes, steps
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import tree_leaves
    cfg = get_config(arch, smoke=True)
    spec = dataclasses.replace(shapes.SHAPES["train_4k"], seq=64, batch=8)
    seen = []
    original = steps.adamw_update

    def record(params, grads, *a):
        seen.extend((p.placements, g.placements) for p, g in
                    zip(tree_leaves(params), tree_leaves(grads)))
        return original(params, grads, *a)
    monkeypatch.setattr(steps, "adamw_update", record)
    with dryrun.fake_group(4):
        mesh = t_mesh._device_mesh((2, 2), ("data", "model"), "cpu")
        dryrun.count_cell(cfg, spec, mesh)
    assert len(seen) == len(tree_leaves(init_params(cfg, device="meta")))
    assert all(p == g for p, g in seen), sorted(
        {str(x) for x in seen if x[0] != x[1]})


def test_sweep_skips_and_records(tmp_path, monkeypatch):
    """The CLI writes one record a cell under its tag (``--baseline``:
    ``torch_dryrun_base``); a full-attention arch at long_500k is a SKIP,
    as in the JAX module.  ``run_cell`` writes a cut cell's record under
    a name that says the cut, and reuses it unless forced."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    for flags, tag in (([], "torch_dryrun_opt"),
                       (["--baseline"], "torch_dryrun_base")):
        dryrun.main(["--arch", "stablelm_1_6b", "--shape", "long_500k"]
                    + flags)
        path = tmp_path / tag / "stablelm_1_6b__long_500k__16x16.json"
        assert json.loads(path.read_text())["status"] == "SKIP"
    kw = dict(mesh_shape=(1, 4), smoke=True, seq=64, batch=1,
              optimized=False, tag="torch_dryrun_base")
    first = _ok(dryrun.run_cell("mamba2_130m", "decode_32k", **kw))
    rec = tmp_path / "torch_dryrun_base" / \
        "mamba2_130m__decode_32k-smoke-seq64-batch1__1x4.json"
    assert json.loads(rec.read_text())["ts"] == first["ts"]
    assert dryrun.run_cell("mamba2_130m", "decode_32k", **kw) == \
        json.loads(rec.read_text())


def test_all_to_all_is_counted_as_the_card_issues_it():
    """On the fake CPU group DTensor would redistribute Shard(0) to
    Shard(1) by an all-gather and a chunk (gloo has no all-to-all); the
    dry run issues the card's all-to-all, whose output is this rank's
    new (4, 128) f32 shard: 2,048 bytes, not the 32,768 gathered."""
    from types import SimpleNamespace
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    from repro_torch.launch import op_analysis as oa
    with dryrun.fake_group(16):
        mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
        x = dryrun.meta_arg(torch.empty(64, 128, device="meta"),
                            SimpleNamespace(mesh=mesh,
                                            placements=(Shard(0),)))

        def step():
            return x.redistribute(mesh, [Shard(1)])
        _, gloo = oa.analyze(step, device_type="meta")
        with dryrun.nccl_all_to_all():
            _, card = oa.analyze(step, device_type="meta")
    assert gloo.coll_bytes == {"all-gather": 32768.0, "total": 32768.0}
    assert card.coll_bytes == {"all-to-all": 2048.0, "total": 2048.0}


@pytest.fixture
def fake_2x2():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield t_mesh._device_mesh((2, 2), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_restore_sends_each_rank_only_its_shard(tmp_path, fake_2x2,
                                                monkeypatch):
    """A stablelm smoke train state restored onto a fake 2x2 mesh: no
    leaf goes through ``sharding.place``, every local tensor built is
    this rank's shard (smaller than the leaf wherever its spec splits
    it), and each equals its slice of the saved array bitwise."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch.steps import init_train_state
    from repro_torch.models.transformer import tree_leaves
    cfg = get_config("stablelm_1_6b", smoke=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    save_checkpoint(tmp_path / "ck", 3, state)
    mesh = fake_2x2
    like = init_train_state(cfg, None, "meta")
    psh = sh.param_shardings(cfg, like["params"], mesh)
    shardings = {"params": psh, "opt": sh.opt_shardings(psh, mesh)}
    placed, built = [], []
    original = DTensor.from_local
    monkeypatch.setattr(sh, "place", lambda x, s: placed.append(x.shape))
    monkeypatch.setattr(DTensor, "from_local", staticmethod(
        lambda local, *a, **k: (built.append(
            (tuple(local.shape), tuple(k["shape"]))),
            original(local, *a, **k))[1]))
    got, step, _ = restore_checkpoint(tmp_path / "ck", like,
                                      shardings=shardings)
    assert step == 3 and not placed
    assert len(built) == len(tree_leaves(state))
    split = [(loc, full) for loc, full in built if loc != full]
    assert len(split) > len(built) // 3
    for loc, full in split:
        assert np.prod(loc) < np.prod(full)
    from repro_torch.checkpoint.store import _flatten
    for (key, want), (_, have), (_, s) in zip(
            _flatten(state), _flatten(got), _flatten(shardings)):
        assert isinstance(have, DTensor)
        assert have.placements == s.placements
        part = want.numpy()
        for d, entry in enumerate(s.spec):
            for axis in ((entry,) if isinstance(entry, str) else
                         (entry or ())):
                part = np.split(part, 2, axis=d)[0]   # coordinate (0, 0)
        np.testing.assert_array_equal(have.to_local().numpy(), part,
                                      err_msg=key)


def test_dry_run_counts_equal_a_real_step(tmp_path):
    """The CPU form of chip_smoke.py phase 22: the stablelm smoke train
    cell on a (1, 1) DeviceMesh of a world-1 gloo group, run on real
    tensors under the op counter, counts the same FLOPs, bytes, ops and
    collectives as the dry run's meta path over a fake world-1 group."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.launch import shapes
    from repro_torch.launch.op_analysis import OpCounter
    cfg = get_config("stablelm_1_6b", smoke=True)
    spec = dataclasses.replace(shapes.SHAPES["train_4k"], seq=32, batch=2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = t_mesh._device_mesh((1, 1), ("data", "model"), "cpu")
        fn, args, ins, _ = shapes.build_cell(cfg, spec, mesh,
                                             microbatches=1)
        real = shapes.materialize(cfg, spec, args, ins, seed=0)
        with OpCounter("cpu") as counter:
            fn(*real)
    finally:
        sh._VIEWS.clear()
        dist.destroy_process_group()
    with dryrun.fake_group(1):
        mesh = t_mesh._device_mesh((1, 1), ("data", "model"), "cpu")
        meta, _, _, _ = dryrun.count_cell(cfg, spec, mesh, microbatches=1)
    got = counter.totals
    assert got.flops == meta.flops > 0
    assert got.hbm_bytes == meta.hbm_bytes > 0
    assert got.ops == meta.ops
    assert got.coll_bytes == meta.coll_bytes == {"total": 0}
    assert got.by_op == meta.by_op
