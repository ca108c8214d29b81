"""The port's CIM macro mesh (repro_torch.launch.mesh, launch.sharding and
the mapped executor's sharded super-step) against the JAX package's
``shard_map`` path on 8 forced host devices.

One module-scoped subprocess runs the JAX package with
``--xla_force_host_platform_device_count=8`` (as tests/test_plan.py and
tests/test_mapped_net.py do) and writes its values: the mesh helpers
over a table of cases, and the sharded forward of cnn8[:3] (64x64
arrays, Tetris-SDK, a 2x2 grid, batch 4) on a (data 2, row 2, col 2)
mesh through ``mapped_net_apply``, ``execute_plan`` and
``execute_looped``, with its inputs.  The port runs the same cases on a
mesh over ``[cpu] * 8``: the same entry repeated, so the shards run one
after another on the one CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (RTOL_LAYER, VClock, assert_close,   # noqa: E402
                           small_net_both, t)
from repro_torch.cnn.mapped_net import (mapped_conv2d,          # noqa: E402
                                        mapped_net_apply)
from repro_torch.core import memo                              # noqa: E402
from repro_torch.exec import (compile_plan, constant_counts,    # noqa: E402
                              execute_looped, execute_oracle,
                              execute_plan, prepare_constants)
from repro_torch.launch import batching as t_batching          # noqa: E402
from repro_torch.launch import fleet as t_fleet                # noqa: E402
from repro_torch.launch import mesh as t_mesh                  # noqa: E402
from repro_torch.launch import serve_cnn as t_serve            # noqa: E402
from repro_torch.launch import sharding as t_sharding          # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU8 = [torch.device("cpu")] * 8
#: sharded vs single-device, port vs port: the row sum split in two
RTOL_SHARD = 1e-6

#: (sub_r, sub_c, data, batch, n_devices) of the helper table
CASES = ((2, 2, 1, 4, 8), (2, 2, 2, 4, 8), (2, 1, 1, 8, 8), (2, 1, 4, 8, 8),
         (4, 2, 1, 3, 8), (3, 3, 2, 5, 8), (2, 2, 1, 4, 1), (2, 2, 2, 4, 1),
         (1, 1, 1, 4, 4), (4, 4, 1, 8, 6), (2, 1, 3, 6, 7), (8, 1, 1, 2, 8),
         (6, 4, 2, 9, 8), (1, 2, 2, 3, 2))
#: (data, row, col) splits realised over each case's devices
SPLITS = ((2, 2, 2), (4, 2, 1), (1, 1, 1), (8, 1, 1), (3, 1, 1), (1, 3, 2),
          (2, 2, 3), (1, 2, 1))

REFERENCE = r'''
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import ArrayConfig, MacroGrid, map_net, networks
from repro.cnn.mapped_net import (mapped_conv2d, mapped_net_apply,
                                  zero_pruned_kernels)
from repro.exec import compile_plan, execute_looped, execute_plan
from repro.launch import batching, mesh as M, sharding
assert len(jax.devices()) == 8
out_dir, cases, splits = sys.argv[1], json.loads(sys.argv[2]), \
    json.loads(sys.argv[3])

def desc(m):
    if m is None:
        return None
    return [list(m.axis_names), [int(m.shape[a]) for a in m.axis_names]]

helpers = []
for sr, sc, data, batch, n in cases:
    devs = jax.devices()[:n]
    macro = M.make_macro_mesh(sr, sc, devs, data=data)
    serving = M.make_serving_mesh(sr, sc, batch, devs)
    row = {"macro": desc(macro), "serving": desc(serving),
           "split": M.mesh_split(serving),
           "data_axis": M.data_axis_size(serving),
           "pad": M.pad_to_data_axis(batch, serving),
           "tiers": list(batching.batch_tiers(batch, serving)),
           "macro_tiers": list(batching.batch_tiers(batch, macro)),
           "specs": [list(s) for s in sharding.macro_pass_specs(serving)],
           "fits": [sharding.macro_mesh_fits(m, r, c, b)
                    for m in (macro, serving) if m is not None
                    for r, c in ((sr, sc), (2 * sr, sc), (sr + 1, sc))
                    for b in (None, batch, batch + 1)],
           "from_split": [desc(M.mesh_from_split(s, devs)) for s in splits],
           "tags": [M.mesh_tag(m) for m in (macro, serving)
                    if m is not None]}
    helpers.append(row)

nets = {"cnn8": map_net("cnn8", networks.cnn8()[:3], ArrayConfig(64, 64),
                        "Tetris-SDK", MacroGrid(2, 2)),
        "densenet40": map_net("densenet40", networks.densenet40()[:4],
                              ArrayConfig(64, 64), "TetrisG-SDK",
                              MacroGrid(4, 1), groups=(1, 2))}
candidates = {name: {str(n): [[list(s) if s is not None else None
                               for s in M.mesh_split_candidates(
                                   nm, b, jax.devices()[:n])]
                              for b in (1, 3, 8)]
                     for n in (1, 2, 4, 8)}
              for name, nm in nets.items()}
grids = {name: list(M.net_macro_grid(nm)) for name, nm in nets.items()}

net = nets["cnn8"]
mesh = M.make_macro_mesh(2, 2, data=2)
rng = np.random.RandomState(0)
ks = zero_pruned_kernels(net, [
    jnp.asarray(rng.randn(m.layer.k_h, m.layer.k_w,
                          m.layer.ic // m.group, m.layer.oc) * 0.2,
                jnp.float32) for m in net.layers])
first = net.layers[0].layer
x = jnp.asarray(rng.randn(4, first.ic, first.i_h, first.i_w), jnp.float32)
plan = compile_plan(net, executor_policy="mapped", mesh=mesh, batch=4)
m0 = net.layers[0]
gs = jax.grad(lambda k: jnp.sum(mapped_conv2d(m0, x, k, mesh=mesh) ** 2))(
    ks[0])
np.savez(out_dir + "/ref.npz", x=np.asarray(x),
         **{f"k{i}": np.asarray(k) for i, k in enumerate(ks)},
         y_apply=np.asarray(mapped_net_apply(net, ks, x, mesh=mesh)),
         y_plan=np.asarray(execute_plan(plan, ks, x, mesh=mesh)),
         y_looped=np.asarray(execute_looped(plan, ks, x, mesh=mesh)),
         g0=np.asarray(gs))
json.dump({"helpers": helpers, "candidates": candidates, "grids": grids,
           "mesh_axes": [list(a) for a in plan.mesh_axes],
           "use_mesh": [lp.use_mesh for lp in plan.layers]},
          open(out_dir + "/ref.json", "w"))
print("REFERENCE-OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's values on 8 forced host devices."""
    out = tmp_path_factory.mktemp("mesh_ref")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + sys.path))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(out),
         json.dumps([list(c) for c in CASES]),
         json.dumps([list(s) for s in SPLITS])],
        env=env, capture_output=True, text=True, timeout=600)
    assert "REFERENCE-OK" in run.stdout, run.stderr[-3000:]
    data = np.load(out / "ref.npz")
    return json.loads((out / "ref.json").read_text()), \
        {k: data[k] for k in data.files}


def _desc(m):
    if m is None:
        return None
    return [list(m.axis_names), [int(m.shape[a]) for a in m.axis_names]]


def _small():
    """The port's cnn8[:3] mapping (equal to the JAX package's field by
    field)."""
    return small_net_both(3)[1]


def _densenet():
    from repro_torch import core
    return core.map_net("densenet40", core.networks.densenet40()[:4],
                        core.ArrayConfig(64, 64), "TetrisG-SDK",
                        core.MacroGrid(4, 1), groups=(1, 2))


# ------------------------------------------------------------ helpers

@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["x".join(map(str, c)) for c in CASES])
def test_mesh_helpers_equal_jax(ref, i):
    """make_macro_mesh, make_serving_mesh, mesh_split, pad_to_data_axis,
    batch_tiers(mesh), macro_pass_specs, macro_mesh_fits,
    mesh_from_split and mesh_tag give the JAX package's shapes, splits
    and answers on every case, 1 to 8 devices."""
    sr, sc, data, batch, n = CASES[i]
    want = ref[0]["helpers"][i]
    devs = CPU8[:1] * n
    macro = t_mesh.make_macro_mesh(sr, sc, devs, data=data)
    serving = t_mesh.make_serving_mesh(sr, sc, batch, devs)
    got = {"macro": _desc(macro), "serving": _desc(serving),
           "split": (list(t_mesh.mesh_split(serving))
                     if serving is not None else None),
           "data_axis": t_mesh.data_axis_size(serving),
           "pad": t_mesh.pad_to_data_axis(batch, serving),
           "tiers": list(t_batching.batch_tiers(batch, serving)),
           "macro_tiers": list(t_batching.batch_tiers(batch, macro)),
           "specs": [list(s) for s in t_sharding.macro_pass_specs(serving)],
           "fits": [t_sharding.macro_mesh_fits(m, r, c, b)
                    for m in (macro, serving) if m is not None
                    for r, c in ((sr, sc), (2 * sr, sc), (sr + 1, sc))
                    for b in (None, batch, batch + 1)],
           "from_split": [_desc(t_mesh.mesh_from_split(s, devs))
                          for s in SPLITS],
           "tags": [t_mesh.mesh_tag(m) for m in (macro, serving)
                    if m is not None]}
    assert got == want
    for m in (macro, serving):
        if m is not None:
            assert m.devices.shape == tuple(m.sizes)
            assert t_mesh.mesh_platform(m) == "cpu"


@pytest.mark.parametrize("name", ["cnn8", "densenet40"])
def test_mesh_split_candidates_equal_jax(ref, name):
    """The tuner's split candidates and the net's common macro grid are
    the JAX package's, for 1, 2, 4 and 8 devices and three batches; the
    tuner's own entry (tune.space) gives the same."""
    from repro_torch import tune
    net = _small() if name == "cnn8" else _densenet()
    assert list(t_mesh.net_macro_grid(net)) == ref[0]["grids"][name]
    want = ref[0]["candidates"][name]
    for n in (1, 2, 4, 8):
        for b in (1, 3, 8):
            got = [list(s) if s is not None else None
                   for s in t_mesh.mesh_split_candidates(net, b,
                                                          CPU8[:1] * n)]
            assert got == want[str(n)][[1, 3, 8].index(b)]
            assert tune.space.mesh_split_candidates(
                net, b, CPU8[:1] * n) == \
                t_mesh.mesh_split_candidates(net, b, CPU8[:1] * n)


def test_mesh_value_and_default_devices(monkeypatch):
    """A mesh is a frozen, hashable value; "cuda" means cuda:0; devices
    must fill the shape; ``devices=None`` is every visible card and
    raises without one; mixed devices are "mixed"."""
    a = t_mesh.Mesh(("row", "col"), (2, 1), ["cuda", "cuda:0"])
    b = t_mesh.Mesh(("row", "col"), (2, 1), [torch.device("cuda", 0)] * 2)
    assert a == b and hash(a) == hash(b)
    assert a.device_list == (torch.device("cuda", 0),) * 2
    assert t_mesh.mesh_platform(a) == "cuda"
    mixed = t_mesh.Mesh(("row",), (2,), ["cpu", "cuda:0"])
    assert t_mesh.mesh_platform(mixed) == "mixed"
    assert t_mesh.mesh_platform(None) is None
    with pytest.raises(ValueError, match="devices for a mesh"):
        t_mesh.Mesh(("row", "col"), (2, 2), CPU8[:3])
    with pytest.raises(ValueError, match=">= 1"):
        t_mesh.make_macro_mesh(2, 2, CPU8, data=0)
    host = t_mesh.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert t_mesh.data_axes(host) == ("data",)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: t_mesh.make_macro_mesh(2, 2),
                 lambda: t_mesh.serving_mesh_for(_small(), 4),
                 lambda: t_mesh.mesh_from_split((2, 1, 1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert t_mesh.visible_devices("cpu") == [torch.device("cpu")]


# ------------------------------------------------------ sharded forward

def _inputs(ref):
    arrays = ref[1]
    ks = [t(arrays[f"k{i}"]) for i in range(3)]
    return ks, t(arrays["x"])


def _cpu_mesh():
    mesh = t_mesh.make_macro_mesh(2, 2, CPU8, data=2)
    assert mesh.shape == {"data": 2, "row": 2, "col": 2}
    return mesh


@pytest.mark.parametrize("path", ["mapped_net_apply", "execute_plan",
                                  "execute_looped"])
def test_sharded_forward_matches_shard_map(ref, path):
    """The port's sharded forward on [cpu] * 8 is the JAX package's
    shard_map output within 1e-5 of max|y|, through each entry."""
    net, mesh = _small(), _cpu_mesh()
    ks, x = _inputs(ref)
    if path == "mapped_net_apply":
        y = mapped_net_apply(net, ks, x, mesh=mesh)
        want = ref[1]["y_apply"]
    else:
        plan = compile_plan(net, executor_policy="mapped", mesh=mesh,
                            batch=4, device="cpu")
        run = execute_plan if path == "execute_plan" else execute_looped
        y = run(plan, ks, x, mesh=mesh)
        want = ref[1]["y_" + path.split("_")[1]]
    assert_close(y, want, RTOL_LAYER)


def test_sharded_plan_vs_vmap_bitwise_twice(ref):
    """The plan's IR records the mesh; the sharded forward is the port's
    single-device forward within 1e-6 of max|y| and the oracle within
    1e-4; two sharded runs agree bit for bit; no kernel is launched."""
    from repro_torch.kernels import sdk_conv
    net, mesh = _small(), _cpu_mesh()
    ks, x = _inputs(ref)
    plan = compile_plan(net, executor_policy="mapped", mesh=mesh, batch=4,
                        device="cpu")
    assert plan.mesh_axes == (("data", 2), ("row", 2), ("col", 2))
    assert [list(a) for a in plan.mesh_axes] == ref[0]["mesh_axes"]
    assert [lp.use_mesh for lp in plan.layers] == ref[0]["use_mesh"] \
        == [True] * 3
    assert "mesh=data=2xrow=2xcol=2" in plan.describe()
    vplan = compile_plan(net, executor_policy="mapped", device="cpu")
    assert vplan.mesh_axes is None and "mesh=vmap" in vplan.describe()
    assert not any(lp.use_mesh for lp in vplan.layers)
    sdk_conv.reset_counts()
    y1 = execute_plan(plan, ks, x, mesh=mesh)
    y2 = execute_plan(plan, ks, x, mesh=mesh)
    assert torch.equal(y1, y2)
    assert_close(y1, execute_plan(vplan, ks, x).numpy(), RTOL_SHARD)
    assert_close(y1, execute_oracle(plan, ks, x).numpy(), 1e-4)
    assert sdk_conv.sdk_whole.launches == sdk_conv.sdk_window.launches == 0


def test_mesh_refusals(ref):
    """A plan compiled on a mesh refuses a call without it ("compile
    mesh"), and the reverse; a batch the data axis does not divide is
    refused at compile, naming pad_to_data_axis; a mesh of another
    device type, a mixed mesh and a non-mesh are refused."""
    net, mesh = _small(), _cpu_mesh()
    ks, x = _inputs(ref)
    plan = compile_plan(net, executor_policy="mapped", mesh=mesh, batch=4,
                        device="cpu")
    vplan = compile_plan(net, executor_policy="mapped", device="cpu")
    for call in (lambda: execute_plan(plan, ks, x),
                 lambda: execute_looped(plan, ks, x),
                 lambda: execute_plan(vplan, ks, x, mesh=mesh)):
        with pytest.raises(ValueError, match="compile mesh"):
            call()
    with pytest.raises(ValueError, match="pad_to_data_axis"):
        compile_plan(net, executor_policy="mapped", mesh=mesh, batch=3,
                     device="cpu")
    card = t_mesh.Mesh(("row", "col"), (2, 2), ["cuda:0"] * 4)
    with pytest.raises(ValueError, match="plan runs on cpu"):
        compile_plan(net, executor_policy="mapped", mesh=card,
                     device="cpu")
    mixed = t_mesh.Mesh(("row", "col"), (2, 1), ["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="mixed"):
        compile_plan(net, executor_policy="mapped", mesh=mixed,
                     device="cpu")
    with pytest.raises(ValueError, match="invalid mesh"):
        compile_plan(net, executor_policy="mapped", mesh=object(),
                     device="cpu")
    # a (row, col) mesh without a data axis takes any batch; a mesh that
    # does not divide a layer's sub-grid leaves that layer batched
    plain = t_mesh.make_macro_mesh(2, 2, CPU8)
    p3 = compile_plan(net, executor_policy="mapped", mesh=plain, batch=3,
                      device="cpu")
    assert all(lp.use_mesh for lp in p3.layers)
    tall = t_mesh.Mesh(("row", "col"), (4, 1), CPU8[:4])
    assert not any(lp.use_mesh for lp in compile_plan(
        net, executor_policy="mapped", mesh=tall, device="cpu").layers)


def test_sharded_gradients(ref):
    """The first layer's kernel gradient over the mesh is the
    single-device one within 1e-6 of max|g|, and the JAX package's
    shard_map gradient within 1e-5."""
    net, mesh = _small(), _cpu_mesh()
    ks, x = _inputs(ref)
    m0 = net.layers[0]
    grads = []
    for msh in (mesh, None):
        k = ks[0].clone().requires_grad_(True)
        (mapped_conv2d(m0, x, k, mesh=msh) ** 2).sum().backward()
        grads.append(k.grad)
    assert_close(grads[0], grads[1].numpy(), RTOL_SHARD)
    assert_close(grads[0], ref[1]["g0"], RTOL_LAYER)


# ------------------------------------------------------ serving on a mesh

def test_serve_pads_and_masks_on_mesh():
    """A request batch of 3 on a data=2 serving mesh pads to plan batch
    4: the masked rows are the single-device plan's within 1e-6, garbage
    in the padded row leaves them bit for bit, and the padded row's input
    gradient is exactly zero."""
    net = _small()
    mesh = t_serve.serving_mesh_for(net, 3, CPU8)
    assert mesh.shape == {"data": 2, "row": 2, "col": 2}
    assert t_mesh.pad_to_data_axis(3, mesh) == 4
    s = t_serve.serve(net, batch=3, steps=1, warmup=1, mesh=mesh,
                      device="cpu")
    assert (s.request_batch, s.plan_batch) == (3, 4)
    assert s.plan.mesh_axes == (("data", 2), ("row", 2), ("col", 2))
    assert abs(s.padded_images_per_s / s.images_per_s - 4 / 3) < 1e-6
    rng = np.random.RandomState(0)
    ks, _ = t_serve.serving_inputs(net, 3, 0, "cpu")
    first = net.layers[0].layer
    x3 = torch.as_tensor(rng.randn(3, first.ic, first.i_h,
                                   first.i_w).astype(np.float32))
    x4 = torch.cat([x3, torch.zeros_like(x3[:1])])
    plan = compile_plan(net, executor_policy="mapped", mesh=mesh, batch=4,
                        device="cpu")
    vplan = compile_plan(net, executor_policy="mapped", device="cpu")
    y = execute_plan(plan, ks, x4, mesh=mesh)[:3]
    y_ref = execute_plan(vplan, ks, x3)
    assert_close(y, y_ref.numpy(), RTOL_SHARD)
    dirty = x4.clone()
    dirty[3] = 7.5
    assert torch.equal(execute_plan(plan, ks, dirty, mesh=mesh)[:3], y)
    xg = x4.clone().requires_grad_(True)
    (execute_plan(plan, ks, xg, mesh=mesh)[:3] ** 2).sum().backward()
    x3g = x3.clone().requires_grad_(True)
    (execute_plan(vplan, ks, x3g) ** 2).sum().backward()
    assert_close(xg.grad[:3], x3g.grad.numpy(), RTOL_SHARD)
    assert torch.count_nonzero(xg.grad[3]) == 0


def test_constants_shared_across_tiers_on_mesh():
    """With a data=2 serving mesh the tiers of one network share ONE
    constants handle, materialized once, and every tier's output is the
    same bit for bit with sharing on or off."""
    net = _small()
    memo.clear()
    mesh = t_mesh.serving_mesh_for(net, 4, CPU8)
    plans = {tr: compile_plan(net, executor_policy="mapped", mesh=mesh,
                              batch=tr, device="cpu") for tr in (2, 4)}
    ks, _ = t_serve.serving_inputs(net, 4, 0, "cpu")
    handles = [prepare_constants(plans[tr], ks, token=("fleet", 0))
               for tr in (2, 4)]
    assert handles[0] is handles[1]
    assert list(constant_counts(net=net).values()) == [1]
    rng = np.random.RandomState(1)
    first = net.layers[0].layer
    for tr in (2, 4):
        x = torch.as_tensor(rng.randn(tr, first.ic, first.i_h,
                                      first.i_w).astype(np.float32))
        y_off = execute_plan(plans[tr], ks, x, mesh=mesh)
        y_on = execute_plan(plans[tr], ks, x, mesh=mesh,
                            constants=handles[0])
        assert torch.equal(y_on, y_off)
    assert list(constant_counts(net=net).values()) == [1]
    memo.clear()


def test_dynamic_and_fleet_serve_on_one_mesh():
    """serve_dynamic's default tiers are multiples of the data axis and
    every request is served; a two-model fleet on fleet_mesh_for's one
    shared mesh serves every request with its tiers padded alike."""
    from repro_torch.launch import transformer as t_transformer
    net = _small()
    mesh = t_mesh.serving_mesh_for(net, 4, CPU8)
    reqs = ((0.0, 3), (0.0, 1), (0.001, 2), (0.002, 1))
    clk = VClock()
    s = t_serve.serve_dynamic(net, reqs, max_batch=4, max_delay_ms=1.0,
                              mesh=mesh, warmup=0, device="cpu",
                              clock=clk, sleep=clk.sleep)
    assert tuple(s.tiers) == (2, 4) == t_batching.batch_tiers(4, mesh)
    assert s.request_images == 7
    assert all(tr % 2 == 0 for tr in s.tiers)
    with pytest.raises(ValueError, match="data axis"):
        t_batching.PlanLadder(net, (1, 2), mesh=mesh, device="cpu")
    tm = t_transformer.transformer_mapping("whisper_smoke", blocks=1)
    maps = {"cnn8": net, "whisper_smoke": tm}
    fmesh = t_fleet.fleet_mesh_for(maps, 2, CPU8)
    assert fmesh is not None
    assert t_mesh.net_macro_grid(tm) == (1, 1)
    config = t_fleet.FleetConfig(models=(
        t_fleet.ModelSpec("cnn8", max_batch=2, max_delay_s=0.001),
        t_fleet.ModelSpec("whisper_smoke", max_batch=2, max_delay_s=0.001)))
    trace = t_fleet.mixed_poisson_trace(("cnn8", "whisper_smoke"), 6, 0.0,
                                        2, seed=0)
    clk = VClock()
    stats, _ = t_fleet.serve_fleet(maps, config, trace, mesh=fmesh,
                                   warmup=0, device="cpu", clock=clk,
                                   sleep=clk.sleep)
    assert stats.request_images == sum(r for _, _, r in trace)
    sched = t_fleet.FleetScheduler(config, mesh=fmesh)
    d = t_mesh.data_axis_size(fmesh)
    assert all(tr % d == 0 for ts in sched.tiers.values() for tr in ts)


def test_train_plan_mesh_vs_no_mesh():
    """train_plan over the mesh: the microbatch pads to the data axis;
    with the same padded step (a ragged tail, zero-weight rows) the
    losses are those without the mesh within 1e-5 relative and the first
    step's gradients within 1e-6 of max|g|."""
    from repro_torch.cnn import train as ttrain
    net = _small()
    mesh = t_mesh.make_macro_mesh(2, 2, CPU8, data=2)
    kw = dict(batch=8, accum=2, n_train=6, executor_policy="mapped",
              device="cpu")
    tr_m = ttrain.plan_training(net, mesh=mesh, **kw)
    tr_v = ttrain.plan_training(net, **kw)
    xb, yb, mask = tr_m.batch_at(0)
    assert float(mask.sum()) == 6.0 and mask.shape == (2, 4)
    g = []
    for tr in (tr_m, tr_v):
        _, grads = ttrain._accum_grads(tr.loss_sum, tr.params,
                                       *tr.batch_at(0))
        g.append(grads)
    for a, b in zip(g[0]["kernels"] + [g[0]["head"]],
                    g[1]["kernels"] + [g[1]["head"]]):
        assert_close(a, b.numpy(), RTOL_SHARD)
    losses = {}
    for name, msh in (("mesh", mesh), ("vmap", None)):
        losses[name] = []
        r = ttrain.train_plan(net, steps=3, mesh=msh, losses=losses[name],
                              **kw)
        assert r.batch == 8
    np.testing.assert_allclose(losses["mesh"], losses["vmap"], rtol=1e-5)
    # a microbatch of 3 pads to 4 on the data axis: batch 6 -> 8
    assert ttrain.train_plan(net, steps=1, batch=6, accum=2, n_train=6,
                             mesh=mesh, executor_policy="mapped",
                             device="cpu").batch == 8


@pytest.mark.parametrize("name", ["cnn8", "inception", "densenet40",
                                  "mobilenet"])
def test_network_schedule_and_steps_match(name):
    """network_schedule equals the JAX package's field by field, its
    steps total the net's cycles, and assert_steps_match holds on every
    bench network (host-side only, the Fig 20 contract)."""
    import dataclasses
    from repro.cnn import mapped_net as jmapped
    from repro_torch.cnn import assert_steps_match, network_schedule
    from _torch_parity import map_net_both
    jnet, tnet = map_net_both(
        name, lambda core: core.networks.NETWORKS[name](), (64, 64),
        "TetrisG-SDK", (4, 4), groups=(1, 2))
    got, want = network_schedule(tnet), jmapped.network_schedule(jnet)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert sum(s.steps for s in got) == tnet.total_cycles
    assert_steps_match(tnet)
    jmapped.assert_steps_match(jnet)
