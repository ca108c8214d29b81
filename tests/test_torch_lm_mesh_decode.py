"""The repaired production-mesh decode on gloo ranks
(tests/_torch_lm_mesh.py, kind "decode") against the JAX package's
``build_cell`` jitted on forced host devices, and a train state restored
onto a 2x2 mesh of the same ranks shard by shard.

Four gloo ranks build a (1, 4) ("data", "model") mesh, where the model
axis exceeds mixtral-8x7b smoke's 2 kv heads (its 16-token window makes
the decode cache a ring) and mamba2 smoke decodes at batch 1 (nothing
splits over "data"; the greedy token is an argmax over vocab-split
logits).  Both decode cells start from the params, cache and token this
module draws and saves; one JAX subprocess runs the same cells on 4 of
8 forced host devices with ``AxisType.Auto`` (``jax.make_mesh``'s
Explicit default refuses ``build_cell``'s constraints).  Both packages
compute in f32, the cache too (the JAX package's f32 decode cannot
write its f32 k/v into a bf16 cache).  The greedy tokens must be
equal; the new cache is held at ``CACHE_RTOL`` of its max, an f32
tolerance, whole and each rank's shard against the JAX shard at its
coordinate.

The same ranks then restore a stablelm smoke train state onto a (2, 2)
mesh: bitwise, every rank holding its placement's shard, with no leaf
passing through ``sharding.place`` and every local tensor built the
rank's shard alone (``DTensor.from_local`` counted)."""
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
from repro_torch.configs import get_config                     # noqa: E402
from repro_torch.launch import sharding as sh                  # noqa: E402
from repro_torch.launch.steps import init_train_state          # noqa: E402
from repro_torch.models import transformer as T                # noqa: E402
from test_torch_lm_mesh import ROOT, _close                    # noqa: E402

#: the new f32 cache relative to its max: both packages compute in f32
#: throughout (measured up to 6.2e-7, mixtral's v)
CACHE_RTOL = 1e-5

REFERENCE = r'''
import json, sys
import numpy as np, jax, jax.numpy as jnp
import repro.models.common as common
from repro.checkpoint.store import restore_checkpoint
from repro.configs import get_config
from repro.launch import shapes
from repro.models import transformer as T
common.COMPUTE_DTYPE = jnp.float32
out_dir, mesh_case, cases = (sys.argv[1], json.loads(sys.argv[2]),
                             json.loads(sys.argv[3]))

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

n = int(np.prod(mesh_case["shape"]))
mesh = jax.make_mesh(tuple(mesh_case["shape"]), tuple(mesh_case["axes"]),
                     devices=jax.devices()[:n],
                     axis_types=(jax.sharding.AxisType.Auto,)
                     * len(mesh_case["shape"]))
got = {}
for arch, (seq, b) in cases.items():
    cfg = get_config(arch, smoke=True)
    like = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
    params, _, _ = restore_checkpoint(f"{out_dir}/weights_{arch}",
                                      {"params": like})
    data = np.load(f"{out_dir}/decode_{arch}.npz")
    spec = shapes.ShapeSpec("smoke_decode", seq, b, "decode")
    fn, args, ins, outs = shapes.build_cell(cfg, spec, mesh)
    flat, tree = jax.tree_util.tree_flatten_with_path(args[1])
    cache = jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(data["cache/" + key(p)]) for p, leaf in flat])
    p, c, t = jax.device_put((params["params"], cache,
                              jnp.asarray(data["token"])), ins[:3])
    token, new_cache = jax.jit(fn, in_shardings=ins, out_shardings=outs)(
        p, c, t, jnp.int32(seq - 1))
    got[f"{arch}/token/t"] = np.asarray(token, np.float32)
    for path, leaf in jax.tree_util.tree_flatten_with_path(new_cache)[0]:
        got[f"{arch}/cache/{key(path)}"] = np.asarray(leaf, np.float32)
        for s in leaf.addressable_shards:
            c = np.argwhere(mesh.devices == s.device)[0]
            got[f"{arch}/cache/{key(path)}@"
                + ",".join(str(int(i)) for i in c)] = \
                np.asarray(s.data, np.float32)
np.savez(f"{out_dir}/ref_decode.npz", **got)
print("REFERENCE-OK")
'''


def _save_inputs(out) -> dict:
    """Each decode case's params (a checkpoint), f32 cache and token (an
    npz) drawn from the cases' seed; and the train state to restore.
    Returns the saved train state."""
    for arch, (seq, batch) in LM.DECODE_CASES.items():
        cfg = get_config(arch, smoke=True)
        gen = torch.Generator().manual_seed(LM.SEED)
        params = T.init_params(cfg, gen, "cpu")
        save_checkpoint(out / f"weights_{arch}", 1, {"params": params})
        cache = T.init_cache(cfg, batch, seq, enc_len=seq, device="meta")
        data = {f"cache/{k}": torch.randn(tuple(a.shape), generator=gen)
                .numpy() for k, a in _flatten(cache)}
        data["token"] = torch.randint(0, cfg.vocab, (batch, 1),
                                      generator=gen,
                                      dtype=torch.int32).numpy()
        np.savez(out / f"decode_{arch}.npz", **data)
    cfg = get_config(LM.RESTORE_ARCH, smoke=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(LM.SEED + 1),
                             "cpu")
    save_checkpoint(out / "restore_ckpt", 7, state)
    return {k: v.numpy() for k, v in _flatten(state)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX outputs, the port's ranks, the saved train state)."""
    out = tmp_path_factory.mktemp("lm_mesh_decode")
    saved = _save_inputs(out)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + sys.path))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(out),
         json.dumps(LM.DECODE_MESH), json.dumps(LM.DECODE_CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = LM.launch("decode", "1x4", 4, out / "port_decode")
    stdout, stderr = jax_run.communicate(timeout=600)
    assert "REFERENCE-OK" in stdout, stderr[-4000:]
    return dict(np.load(out / "ref_decode.npz")), ranks, saved


@pytest.mark.parametrize("arch", list(LM.DECODE_CASES))
def test_decode_on_a_model_axis_past_the_heads_matches_jax(run, arch):
    """The decode cell on (1, 4): the greedy tokens equal the JAX run's
    on every rank; the new cache within ``CACHE_RTOL`` of its max, whole
    and each rank's shard at its coordinate."""
    ref, ranks, _ = run
    want = ref[f"{arch}/token/t"]
    assert want.shape == (LM.DECODE_CASES[arch][1], 1)
    for got, _ in ranks:
        np.testing.assert_array_equal(got[f"{arch}/token/t"], want)
    keys = sorted(k for k in ref if k.startswith(f"{arch}/cache/")
                  and "@" not in k)
    assert keys
    for key in keys:
        _close(ranks[0][0][key], ref[key], CACHE_RTOL, key)
    n = 0
    for got, meta in ranks:
        c = ",".join(str(i) for i in meta["coord"])
        for key in keys:
            if f"{key}@{c}" in got:
                _close(got[f"{key}@{c}"], ref[f"{key}@{c}"], CACHE_RTOL, key)
                n += 1
    assert n >= len(ranks)


def test_restore_onto_a_2x2_mesh_sends_only_shards(run):
    """The train state restored onto the (2, 2) mesh of the four ranks:
    every leaf whole equals what was saved bit for bit, each rank holds
    its placement's shard, no leaf went through ``sharding.place``, and
    each local tensor built was the rank's shard (smaller than the leaf
    wherever its spec splits it)."""
    _, ranks, saved = run
    cfg = get_config(LM.RESTORE_ARCH, smoke=True)
    mesh = type("FakeMesh", (), {"shape": {"data": 2, "model": 2},
                                 "axis_names": ("data", "model")})()
    like = init_train_state(cfg, None, "meta")
    psh = sh.param_shardings(cfg, like["params"], mesh)
    specs = dict(_flatten({"params": psh,
                           "opt": sh.opt_shardings(psh, mesh)}))
    for got, meta in ranks:
        assert meta["step"] == 7 and meta["placed"] == []
        assert len(meta["built"]) == len(saved)
        assert sum(loc != full for loc, full in meta["built"]) > \
            len(saved) // 3
        c = meta["coord22"]
        for key, full in saved.items():
            np.testing.assert_array_equal(got[f"restored/{key}"], full,
                                          err_msg=key)
            want = full
            for d, entry in enumerate(specs[key].spec):
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                for a in axes:
                    want = np.split(want, 2, axis=d)[c[("data",
                                                        "model").index(a)]]
            have = got.get(f"restored/{key}@{c[0]},{c[1]}")
            np.testing.assert_array_equal(have, want, err_msg=key)
