"""The five LM families the first gloo cases left out, sharded on gloo
ranks (tests/_torch_lm_mesh.py, kind "families") against the JAX
package's ``build_cell`` jitted on forced host devices: MLA and the
MoE on local experts (deepseek-v2-lite-16b), SSD's train and prefill
(mamba2-130m), RG-LRU beside windowed gqa (recurrentgemma-9b), the
encoder-decoder (whisper-base) and the vision prefix (internvl2-26b),
each at its smoke config on a (2, 2) ("data", "model") mesh, so each
unit's weights are gathered over "data" at use; recurrentgemma's one kv
head does not divide "model", so its query heads split past it.

This module draws each family's params and batches on one device (the
port's one-device run, also held), saves them as a checkpoint and an
npz, and starts two gloo launches of four ranks at once beside one JAX
subprocess on 4 of 8 forced host devices (``AxisType.Auto``), then runs
the one-device cells while they work.  Both
packages compute in f32; the cells keep their policies (bf16 scores,
inner remat, the norm policy, the MoE gather).  The JAX program is
compiled with ``--xla_allow_excess_precision=false``, so it rounds the
bf16 scores' softmax chain where it is written, as the port does (as
test_torch_zoo.py holds the bf16 families): with XLA's default it keeps
f32 across those roundings, and whisper-base's decoder wq moments then
move 3.96e-2 of their max from the port's, one device against one
device (2.68e-2 as written).  Held at
test_torch_lm_mesh.py's tolerances: the loss and gradient norm
``LOSS_RTOL``, the Adam moments ``MOMENT_RTOL`` of a leaf's max, the
new params within Adam's sign-flip bound; the prefill's greedy tokens
equal and its cache within ``CACHE_RTOL`` of its max, whole and each
rank's shard against the JAX shard at its coordinate."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_mesh as LM                                    # noqa: E402
from repro_torch.checkpoint import save_checkpoint             # noqa: E402
from repro_torch.checkpoint.store import _flatten              # noqa: E402
from repro_torch.launch import mesh as t_mesh                  # noqa: E402
from test_torch_lm_mesh import (CACHE_RTOL, LOSS_RTOL,         # noqa: E402
                                MOMENT_RTOL, ROOT, _check_step, _close,
                                _leaf_keys, check_leaf)

ARCHS = list(LM.FAMILY_CASES)

REFERENCE = r'''
import json, sys
import numpy as np, jax, jax.numpy as jnp
import repro.models.common as common
from repro.checkpoint.store import restore_checkpoint
from repro.configs import get_config
from repro.launch import shapes
from repro.models import transformer as T
from repro.optim import adamw_init
common.COMPUTE_DTYPE = jnp.float32
out_dir, m, cases = (sys.argv[1], json.loads(sys.argv[2]),
                     json.loads(sys.argv[3]))

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

def shards(prefix, tree, got):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        for s in leaf.addressable_shards:
            c = np.argwhere(mesh.devices == s.device)[0]
            got[f"{prefix}/{key(path)}@" + ",".join(str(int(i)) for i in c)] = \
                np.asarray(s.data, np.float32)

def whole(prefix, tree, got):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got[f"{prefix}/{key(path)}"] = np.asarray(leaf, np.float32)

def batch(data, mode):
    return {k.split("/")[1]: jnp.asarray(
        data[k], jnp.int32 if k.endswith("tokens") else jnp.bfloat16)
        for k in data.files if k.startswith(mode + "/")}

mesh = jax.make_mesh(tuple(m["shape"]), tuple(m["axes"]),
                     devices=jax.devices()[:int(np.prod(m["shape"]))],
                     axis_types=(jax.sharding.AxisType.Auto,)
                     * len(m["shape"]))
got = {}
for arch, case in cases.items():
    cfg = get_config(arch, smoke=True)
    like = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
    params, _, _ = restore_checkpoint(f"{out_dir}/weights_{arch}",
                                      {"params": like})
    params = params["params"]
    data = np.load(f"{out_dir}/batch_{arch}.npz")
    seq, b = case["train"]
    spec = shapes.ShapeSpec("smoke_train", seq, b, "train")
    fn, args, ins, outs = shapes.build_cell(cfg, spec, mesh, microbatches=2)
    state = {"params": params, "opt": adamw_init(params)}
    state, tb = jax.device_put((state, batch(data, "train")), ins)
    shards(f"{arch}/in/state", state, got)
    shards(f"{arch}/in/batch", tb, got)
    new_state, metrics = jax.jit(fn, in_shardings=ins,
                                 out_shardings=outs)(state, tb)
    shards(f"{arch}/out/state", new_state, got)
    whole(f"{arch}/out/state", new_state, got)
    whole(f"{arch}/out/metrics", metrics, got)
    seq, b = case["prefill"]
    spec = shapes.ShapeSpec("smoke_prefill", seq, b, "prefill")
    fn, args, ins, outs = shapes.build_cell(cfg, spec, mesh)
    p, pb = jax.device_put((params, batch(data, "prefill")), ins)
    shards(f"{arch}/in/prefill_batch", pb, got)
    token, cache = jax.jit(fn, in_shardings=ins, out_shardings=outs)(p, pb)
    shards(f"{arch}/out/cache", cache, got)
    whole(f"{arch}/out/token", {"t": token}, got)
    whole(f"{arch}/out/cache", cache, got)
np.savez(f"{out_dir}/ref_families.npz", **got)
print("REFERENCE-OK")
'''


def _numpy(batch: dict, mode: str) -> dict:
    """A batch as numpy under ``<mode>/<key>`` (bf16 embeddings as f32:
    exact)."""
    return {f"{mode}/{k}": (v.numpy() if v.dtype == torch.int32
                            else v.float().numpy()) for k, v in batch.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX outputs, {arch: the rank outputs}, {arch: one-device
    outputs})."""
    import repro_torch.models.common as common
    old = common.COMPUTE_DTYPE
    common.COMPUTE_DTYPE = torch.float32
    try:
        out = tmp_path_factory.mktemp("lm_mesh_families")
        host = t_mesh.make_host_mesh("cpu")
        cells = {}
        for arch in ARCHS:
            case = LM.family_case(arch)
            cells[arch] = [LM.cell(case, mode, host)[:2]
                           for mode in ("train", "prefill")]
            (_, (state, batch)), (_, (_, pbatch)) = cells[arch]
            save_checkpoint(out / f"weights_{arch}", 1,
                            {"params": state["params"]})
            np.savez(out / f"batch_{arch}.npz", **_numpy(batch, "train"),
                     **_numpy(pbatch, "prefill"))
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                             "--xla_allow_excess_precision=false",
                   JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([str(ROOT / "src")]
                                              + sys.path))
        jax_run = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, str(out),
             json.dumps(LM.FAMILY_MESH), json.dumps(LM.FAMILY_CASES)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        world = int(np.prod(LM.FAMILY_MESH["shape"]))
        launched = {name: LM.start("families", name, world,
                                   out / f"port_{name}")
                    for name in sorted({c["launch"]
                                        for c in LM.FAMILY_CASES.values()})}
        # the one-device runs while the ranks and the JAX run work
        single = {arch: {mode: fn(*args) for mode, (fn, args) in
                         zip(("train", "prefill"), cells[arch])}
                  for arch in ARCHS}
        ranks = {}
        for name, launch in launched.items():
            got = LM.finish(launch)
            ranks.update({arch: got for arch in LM.family_archs(name)})
        stdout, stderr = jax_run.communicate(timeout=600)
        assert "REFERENCE-OK" in stdout, stderr[-4000:]
    finally:
        common.COMPUTE_DTYPE = old
    return dict(np.load(out / "ref_families.npz")), ranks, single


def _coord(meta) -> str:
    return ",".join(str(i) for i in meta["coord"])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_shards_equal_jax_shards(run, arch):
    """Each rank's local shard of the placed params, Adam state, train
    batch (embeddings included) and prefill batch equals the JAX shard
    at its mesh coordinate, bitwise, on every coordinate."""
    ref, ranks, _ = run
    assert len({_coord(meta) for _, meta in ranks[arch]}) == \
        int(np.prod(LM.FAMILY_MESH["shape"])) == len(ranks[arch])
    keys = _leaf_keys(ref, f"{arch}/in/")
    assert any("prefill_batch" in k for k in keys)
    for got, meta in ranks[arch]:
        for key in keys:
            want = ref[f"{key}@{_coord(meta)}"]
            have = got[f"{key}@{_coord(meta)}"]
            assert have.shape == want.shape, key
            np.testing.assert_array_equal(have, want, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_sharded_and_one_device(run, arch):
    """The train cell with its policies: the loss, gradient norm and the
    whole new state against the JAX sharded run and the port's
    one-device run; each rank's shards of the new state against the JAX
    shards at its coordinate, relative to the whole leaf's max (the
    bf16 scores' rounding noise is the leaf's: whisper-base's decoder wq
    moments differ by 2.0e-2 of the leaf's max, 4.2e-2 of one shard's
    smaller max)."""
    ref, ranks, single = run
    state, metrics = single[arch]["train"]
    _check_step(ranks[arch][0][0], ref, state, metrics, f"{arch}/out",
                LOSS_RTOL, MOMENT_RTOL)
    lr = float(ref[f"{arch}/out/metrics/lr"])
    for got, meta in ranks[arch]:
        for key in _leaf_keys(ref, f"{arch}/out/state"):
            check_leaf(key, got[f"{key}@{_coord(meta)}"],
                       ref[f"{key}@{_coord(meta)}"], lr, MOMENT_RTOL,
                       scale=np.abs(ref[key]).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax_sharded_and_one_device(run, arch):
    """The prefill on the same params: the greedy tokens equal the JAX
    run's and the one-device run's; the cache within ``CACHE_RTOL`` of
    its max, whole against both and each rank's shard against the JAX
    shard at its coordinate."""
    ref, ranks, single = run
    token, cache = single[arch]["prefill"]
    got = ranks[arch][0][0]
    np.testing.assert_array_equal(got[f"{arch}/out/token/t"],
                                  ref[f"{arch}/out/token/t"])
    np.testing.assert_array_equal(got[f"{arch}/out/token/t"],
                                  token.numpy())
    for key, leaf in _flatten(cache):
        have = got[f"{arch}/out/cache/{key}"]
        _close(have, ref[f"{arch}/out/cache/{key}"], CACHE_RTOL, key)
        _close(have, leaf.float().numpy(), CACHE_RTOL, key)
    for rank, meta in ranks[arch]:
        for key in _leaf_keys(ref, f"{arch}/out/cache"):
            _close(rank[f"{key}@{_coord(meta)}"],
                   ref[f"{key}@{_coord(meta)}"], CACHE_RTOL, key)


def test_ssd_prefill_runs_the_local_shard_route(run):
    """mamba2's prefill on the (2, 2) mesh sends each of its SSD blocks'
    chunks through ``ssd_chunk``'s local-shard route on every rank (the
    smoke config's 3 blocks); no other family reaches it."""
    _, ranks, _ = run
    for arch in ARCHS:
        for got, _ in ranks[arch]:
            calls = got[f"{arch}/ssd/calls"].tolist()
            blocks = 3 if arch == "mamba2_130m" else 0
            assert calls == [blocks, blocks], (arch, calls)


#: the placements the local-shard route runs each case on (x, dt and the
#: states; ``local_placements``): the batch split over "data" kept, the
#: heads over "model" kept where each rank reads one group, and the
#: straddling, uneven and partial cases redistributed first
SSD_RAN = {"as_placed": "[Shard(dim=0), Replicate()]",
           "heads_over_model": "[Shard(dim=0), Shard(dim=2)]",
           "straddling": "[Shard(dim=0), Replicate()]",
           "uneven": "[Replicate(), Shard(dim=2)]",
           "partial": "[Replicate(), Shard(dim=2)]"}


@pytest.mark.parametrize("case", LM.SSD_CASES)
def test_ssd_local_shards_match_dtensor_ops(run, case):
    """On every rank, ``ssd_chunk``'s local-shard route (each rank's
    shards through the plain version, wrapped back) against
    ``ssd_chunk_plain``'s DTensor ops on the same DTensors: y and the
    chunk states within ``SSD_RTOL`` of their max (bitwise, as it runs
    here), on the route's placements (``SSD_RAN``)."""
    _, ranks, _ = run
    for got, meta in ranks["mamba2_130m"]:
        gap, bitwise = got[f"mamba2_130m/ssd/{case}/gap"].tolist()
        assert gap <= LM.SSD_RTOL and bitwise, (case, meta, gap)
        assert got[f"mamba2_130m/ssd/{case}/placements"].tolist() == \
            [SSD_RAN[case]], case
