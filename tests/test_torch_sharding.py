"""The port's LM production-mesh specs (repro_torch.launch.sharding,
launch.mesh, launch.shapes) against the JAX package's, in-process and
without forced host devices.

The spec functions read a mesh only through its axis names and sizes, so
the JAX side runs on ``FakeMesh`` stand-ins (as tests/test_launch.py
does) and ``jax.eval_shape``'s abstract params; the port's shapes come
from ``meta`` tensors.  Every leaf of all ten ``ARCH_IDS`` configs at
full size is compared entry for entry on the 16x16 pod, the 2x16x16 pair
of pods and a (2, 3) stand-in, where qwen's 40 heads do not divide.  The
production meshes themselves are built over a fake 256/512-rank process
group, and ``distribute_tensor`` under ``FakeTensorMode`` gives every
leaf its local shard."""
from functools import partial

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, get_config as j_get_config  # noqa: E402
from repro.launch import shapes as j_shapes                     # noqa: E402
from repro.launch import sharding as j_sh                       # noqa: E402
from repro.models import transformer as JT                      # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import mesh as t_mesh                   # noqa: E402
from repro_torch.launch import shapes as t_shapes               # noqa: E402
from repro_torch.launch import sharding as sh                   # noqa: E402
from repro_torch.launch.steps import init_train_state           # noqa: E402
from repro_torch.models import transformer as T                 # noqa: E402


class FakeMesh:
    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16),
          "2x3": FakeMesh(data=2, model=3)}
#: the decode cell's cache: decode_32k's batch and length
CACHE = (128, 32768)


def _jax_specs(fn, tree, mesh, cfg) -> dict:
    return {j_sh._path_names(p): tuple(fn(j_sh._path_names(p), leaf.shape,
                                          mesh, cfg))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(fn, tree, mesh, cfg) -> dict:
    out = {}
    sh.map_with_path(lambda p, leaf: out.__setitem__(
        sh._path_names(p), tuple(fn(sh._path_names(p), tuple(leaf.shape),
                                    mesh, cfg))), tree)
    return out


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    cfg_j = j_get_config(request.param)
    cfg = get_config(request.param)
    params_j = jax.eval_shape(partial(JT.init_params, cfg_j),
                              jax.random.PRNGKey(0))
    cache_j = jax.eval_shape(lambda: JT.init_cache(
        cfg_j, *CACHE, enc_len=min(CACHE[1], 32768)))
    return (cfg_j, cfg, params_j, T.init_params(cfg, device="meta"),
            cache_j, T.init_cache(cfg, *CACHE, enc_len=min(CACHE[1], 32768),
                                  device="meta"))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_and_cache_specs_equal_jax(arch, mesh):
    """Every leaf's param spec and decode cache spec, entry for entry,
    full size; the leaves' paths and shapes agree first."""
    cfg_j, cfg, params_j, params_t, cache_j, cache_t = arch
    m = MESHES[mesh]
    want = _jax_specs(j_sh.param_spec, params_j, m, cfg_j)
    got = _port_specs(sh.param_spec, params_t, m, cfg)
    assert got == want
    assert len(got) >= 10
    want = _jax_specs(j_sh.cache_spec, cache_j, m, cfg_j)
    got = _port_specs(sh.cache_spec, cache_t, m, cfg)
    assert got == want and got


def test_param_shardings_cover_tree():
    """tests/test_launch.py's case: a sharding for every leaf (host
    mesh), with a spec no longer than the leaf's rank."""
    mesh = t_mesh.make_host_mesh("cpu")
    for arch in ("mixtral_8x7b", "mamba2_130m", "recurrentgemma_9b",
                 "deepseek_v2_lite_16b", "whisper_base"):
        cfg = get_config(arch, smoke=True)
        shapes = T.init_params(cfg, device="meta")
        shs = T.tree_leaves(sh.param_shardings(cfg, shapes, mesh))
        leaves = T.tree_leaves(shapes)
        assert len(shs) == len(leaves)
        assert all(isinstance(s, sh.NamedSharding) and s.mesh is mesh
                   and len(s.spec) <= len(x.shape)
                   for s, x in zip(shs, leaves))


def test_param_spec_head_dim_fallback():
    """qwen: 40 heads don't divide 16 -> the head_dim axis gets 'model'."""
    cfg = get_config("qwen1_5_32b")
    spec = sh.param_spec(("stages", "[0]", "[0]", "attn", "wq"),
                         (64, 5120, 40, 128), MESHES["16x16"], cfg)
    assert spec == sh.P(None, ("data",), None, "model")
    assert tuple(spec) == (None, "data", None, "model")


def test_cache_spec_seq_over_model():
    cfg = get_config("mixtral_8x7b")
    spec = sh.cache_spec(("stages", "k"), (32, 128, 4096, 8, 128),
                         MESHES["16x16"], cfg)
    assert spec == sh.P(None, ("data",), "model", None, None)


def test_long500k_skips():
    for arch, expect in [("deepseek_67b", False), ("mamba2_130m", True),
                         ("mixtral_8x7b", True),
                         ("recurrentgemma_9b", True),
                         ("qwen1_5_32b", False)]:
        ok, reason = t_shapes.cell_supported(get_config(arch),
                                             t_shapes.SHAPES["long_500k"])
        assert ok == expect, arch
        assert (reason == "") == ok


def test_shapes_cells_and_batches_equal_jax():
    """SHAPES, cell_supported, default_microbatches and batch_specs (the
    abstract batch's shapes and dtypes, its specs on the pod and the
    pair of pods) for every arch x shape."""
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    host = t_mesh.make_host_mesh("cpu")
    dtypes = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}
    assert {k: tuple(vars(v).values()) for k, v in t_shapes.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in j_shapes.SHAPES.items()}
    for arch in ARCH_IDS:
        cfg_j, cfg = j_get_config(arch), get_config(arch)
        for name, spec in t_shapes.SHAPES.items():
            jspec = j_shapes.SHAPES[name]
            assert t_shapes.cell_supported(cfg, spec) == \
                j_shapes.cell_supported(cfg_j, jspec)
            for m in (MESHES["16x16"], MESHES["2x16x16"]):
                assert t_shapes.default_microbatches(cfg, spec, m) == \
                    j_shapes.default_microbatches(cfg_j, jspec, m)
                assert sh.batch_dim(m, spec.batch) == \
                    j_sh.batch_dim(m, jspec.batch)
                assert tuple(sh.batch_spec(m, spec.batch, 3)) == \
                    tuple(j_sh.batch_spec(m, jspec.batch, 3))
            if spec.mode == "decode":
                continue
            bj, sj = j_shapes.batch_specs(cfg_j, jspec, jmesh)
            bt, st = t_shapes.batch_specs(cfg, spec, host)
            assert sorted(bt) == sorted(bj)
            for k in bj:
                assert tuple(bt[k].shape) == bj[k].shape, (arch, name, k)
                assert bt[k].dtype == dtypes[bj[k].dtype.type]
                assert bt[k].device.type == "meta"
                assert tuple(st[k].spec) == tuple(sj[k].spec)


def test_placements_major_to_minor():
    """A dim named under ("pod", "data") is sharded by both mesh dims, pod
    first; an axis out of the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert sh.placements(sh.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(), m) == (Replicate(),) * 3
    assert sh.placements(sh.P(None, "data"), m) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.P(("data", "pod")), m)
    with pytest.raises(ValueError, match="twice"):
        sh.placements(sh.P("model", "model"), m)
    # an axis of size 1 splits nothing
    assert sh.placements(sh.P(("pod", "data"), "model"),
                         FakeMesh(pod=2, data=1, model=3)) == (
        Shard(0), Replicate(), Shard(1))


def test_optimizer_batch_and_replicated_shardings():
    m = MESHES["2x16x16"]
    cfg = get_config("stablelm_1_6b")
    psh = sh.param_shardings(cfg, T.init_params(cfg, device="meta"), m)
    opt = sh.opt_shardings(psh, m)
    assert opt["m"] is psh and opt["v"] is psh
    assert tuple(opt["step"].spec) == () == tuple(sh.replicated(m).spec)
    assert tuple(sh.batch_spec(m, 256, 2)) == (("pod", "data"), None)
    assert tuple(sh.batch_spec(m, 1, 2)) == (None, None)


def test_host_mesh_places_plain_tensors():
    """On a one-device mesh the placed tensors stay plain, on its
    device; an int position passes through."""
    host = t_mesh.make_host_mesh("cpu")
    x = torch.arange(6.0).reshape(2, 3)
    got = sh.distribute({"x": x, "pos": 5},
                        {"x": sh.NamedSharding(host, sh.P("data", None)),
                         "pos": sh.replicated(host)})
    assert type(got["x"]) is torch.Tensor and torch.equal(got["x"], x)
    assert got["pos"] == 5
    assert sh.constrain(x, sh.replicated(host)) is x


def test_production_mesh_needs_its_process_group():
    """Without an initialised group of exactly its world size the mesh
    is refused, naming what it needs; no smaller mesh is built."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks.*none is"):
        t_mesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        t_mesh.make_production_mesh(multi_pod=True, device_type="cpu")


@pytest.fixture(params=[False, True], ids=["pod", "two_pods"])
def fake_group(request):
    """A fake process group of the production mesh's world size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 512 if request.param else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield request.param
    finally:
        dist.destroy_process_group()


def test_production_mesh_local_shards(fake_group):
    """Under a fake 256/512-rank group: the mesh's axes and sizes, a
    wrong world size refused, and for every leaf of four configs at full
    size (FakeTensorMode: nothing allocated) the local shard's shape is
    the global shape divided by the sizes of the axes its spec names."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    multi = fake_group
    mesh = t_mesh.make_production_mesh(multi_pod=multi, device_type="cpu")
    sizes = t_mesh.axis_sizes(mesh)
    assert sizes == ({"pod": 2, "data": 16, "model": 16} if multi
                     else {"data": 16, "model": 16})
    assert t_mesh.axis_names(mesh) == tuple(sizes)
    assert t_mesh.data_axes(mesh) == (("pod", "data") if multi else
                                      ("data",))
    with pytest.raises(RuntimeError, match="group has"):
        t_mesh._device_mesh((2, 2), ("data", "model"), "cpu")
    n = 0
    for arch in ("qwen1_5_32b", "mixtral_8x7b", "deepseek_v2_lite_16b",
                 "mamba2_130m"):
        cfg = get_config(arch)
        state = init_train_state(cfg, None, "meta")
        shards = sh.param_shardings(cfg, state["params"], mesh)
        with FakeTensorMode():
            for leaf, s in zip(T.tree_leaves(state["params"]),
                               T.tree_leaves(shards)):
                want = list(leaf.shape)
                for d, entry in enumerate(s.spec):
                    axes = () if entry is None else (
                        (entry,) if isinstance(entry, str) else entry)
                    for a in axes:
                        want[d] //= sizes[a]
                x = torch.empty(tuple(leaf.shape))
                local = distribute_tensor(x, mesh, s.placements).to_local()
                assert list(local.shape) == want, (arch, s.spec)
                n += 1
    assert n > 50


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "whisper_base"])
def test_placer_places_the_same_params_a_block_at_a_time(arch,
                                                         monkeypatch):
    """``init_params(place=Placer(...))`` (what ``materialize`` draws)
    gives the draw without it, bit for bit, encoder included; so does
    ``Placer.tree`` over the full params.  A leaf stacked over its units
    is never placed whole: it goes unit by unit."""
    cfg = get_config(arch, smoke=True)
    host = t_mesh.make_host_mesh("cpu")
    shapes = T.init_params(cfg, device="meta")
    shards = sh.param_shardings(cfg, shapes, host)
    stacked = {tuple(x.shape) for path, x in _leaves_with_names(shapes)
               if sh._stacked(path) and x.shape[0] > 1}
    assert stacked
    original = sh.place
    for kind in ("init", "tree"):
        placed = []
        want = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with monkeypatch.context() as m:
            m.setattr(sh, "place", lambda x, s: (
                placed.append(tuple(x.shape)), original(x, s))[1])
            placer = sh.Placer(shards)
            got = (T.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", place=placer) if kind == "init"
                   else placer.tree(want))
        assert [k for k, _ in _leaves_with_names(got)] == \
            [k for k, _ in _leaves_with_names(want)]
        for a, b in zip(T.tree_leaves(got), T.tree_leaves(want)):
            assert type(a) is torch.Tensor and torch.equal(a, b)
        assert not stacked & set(placed), kind
        assert {s[1:] for s in stacked} <= set(placed), kind


def _leaves_with_names(tree) -> list:
    out = []
    sh.map_with_path(lambda p, x: out.append((sh._path_names(p), x)), tree)
    return out
