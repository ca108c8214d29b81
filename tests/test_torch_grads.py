"""Gradients through the port's executors (repro_torch.cnn.cim_conv,
repro_torch.cnn.mapped_net) against ``F.conv2d`` autograd and against
``jax.grad`` of the JAX package's executors, on cnn8's six layers and the
14-layer densenet40 prefix at 64x64 and 512x512 arrays.

Border-clamped windows write some output positions more than once.  A
scatter that kept every writer handed each of them the full output
gradient (``index_put_``'s backward), so CNN8-2 @ 64x64 (G 8) and CNN8-4
@ 512x512 read kernel gradients 6e-2 and 2.4e-1 of max|g| away from
``F.conv2d``'s; the executors now keep one writer per position.  Also
here: the forward is the sequential set-semantics scatter bit for bit,
and the kernel wrappers refuse autograd on the CPU as on the card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from _torch_parity import (assert_close, map_net_both,  # noqa: E402
                           t, zero_pruned)
from repro.cnn.cim_conv import cim_conv2d_traced                # noqa: E402
from repro.cnn.mapped_net import mapped_conv2d_traced           # noqa: E402
from repro_torch.cnn import cim_conv as tcc                     # noqa: E402
from repro_torch.cnn import mapped_net as tmn                   # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while this module runs: the suite
    runs several worker processes on a few cores, and each one's default
    of a thread per core oversubscribes them (one small test of this
    kind slowed from 3 s to almost 300 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: a gradient of one layer, f32, another summation order: relative to
#: max|g| (the executors read <= 1.1e-6 against F.conv2d)
RTOL_GRAD = 1e-5

#: (layers, macro grid, groups): cnn8 with G up to 8 on one macro gives
#: the failing CNN8-2 @ 64x64 (G 8) and CNN8-4 @ 512x512 (G 4); the
#: densenet prefix is that of tests/test_memory_remat.py
NETS = {
    "cnn8": (lambda core: core.networks.cnn8(), (1, 1), (1, 2, 4, 8)),
    "densenet_prefix": (lambda core: core.networks.densenet40()[:14],
                        (2, 2), (1, 2)),
}
EXECUTORS = {"cim": (tcc.cim_conv2d, cim_conv2d_traced),
             "mapped": (tmn.mapped_conv2d, mapped_conv2d_traced)}


def _nets(name, array):
    layers_of, grid, groups = NETS[name]
    return map_net_both(name, layers_of, (array, array), "TetrisG-SDK", grid,
                        groups=groups)


def _data(net, seed=0):
    """One image and a kernel (pruned channels zeroed) per layer, numpy
    f32."""
    rng = np.random.RandomState(seed)
    out = []
    for m in net.layers:
        lay = m.layer
        x = rng.randn(1, lay.ic, lay.i_h, lay.i_w).astype(np.float32)
        k = rng.randn(lay.k_h, lay.k_w, lay.ic // m.group,
                      lay.oc).astype(np.float32)
        out.append((x, zero_pruned(m, k)))
    return out


def _torch_grads(fn, x, k):
    """(dL/dx, dL/dk) of L = sum(fn(x, k)**2)."""
    x, k = t(x).requires_grad_(True), t(k).requires_grad_(True)
    (fn(x, k) ** 2).sum().backward()
    return x.grad, k.grad


def _conv_grads(m, x, k):
    lay = m.layer
    return _torch_grads(lambda x, k: F.conv2d(
        x, k.permute(3, 2, 0, 1), stride=lay.stride, groups=m.group), x, k)


@functools.lru_cache(maxsize=None)
def _jax_grads(net_name, array, executor, layers=None):
    """jax.grad of sum(y**2) of each layer (all, or the named ``layers``)
    through the JAX package's executor, in ONE jitted program: {layer
    name: (dL/dx, dL/dk)}."""
    jnet, tnet = _nets(net_name, array)
    data = _data(tnet)
    keep = [i for i, m in enumerate(jnet.layers)
            if layers is None or m.layer.name in layers]
    traced = EXECUTORS[executor][1]

    def loss(xs, ks):
        return sum((traced(jnet.layers[i], x, k) ** 2).sum()
                   for i, x, k in zip(keep, xs, ks))
    xs = [jnp.asarray(data[i][0]) for i in keep]
    ks = [jnp.asarray(data[i][1]) for i in keep]
    gx, gk = jax.jit(jax.grad(loss, argnums=(0, 1)))(xs, ks)
    return {jnet.layers[i].layer.name: (np.asarray(a), np.asarray(b))
            for i, a, b in zip(keep, gx, gk)}


#: the densenet prefix's layers whose gradients are held to the JAX
#: package's mapped executor itself (compiling all 14 takes ~40 s): the
#: block's first and last layers, the transition and the next block's
#: first; every layer is held to F.conv2d and to the JAX package's
#: reference executor, whose gradients the JAX package's own tests pin
#: to its mapped executor's
JAX_MAPPED_LAYERS = ("DN40-b1l1", "DN40-b1l12", "DN40-t1", "DN40-b2l1")


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
@pytest.mark.parametrize("array", (64, 512))
@pytest.mark.parametrize("net_name", sorted(NETS))
def test_gradients_match_conv2d_and_jax(net_name, array, executor):
    """Input and kernel gradients of every layer within 1e-5 of max|g|
    of F.conv2d's and of jax.grad of the JAX package's executors."""
    _, tnet = _nets(net_name, array)
    port = EXECUTORS[executor][0]
    want = dict(_jax_grads(net_name, array, "cim"))
    if executor == "mapped":
        subset = JAX_MAPPED_LAYERS if net_name == "densenet_prefix" else None
        want.update(_jax_grads(net_name, array, "mapped", subset))
    for m, (x, k) in zip(tnet.layers, _data(tnet)):
        gx, gk = _torch_grads(lambda x, k: port(m, x, k), x, k)
        cgx, cgk = _conv_grads(m, x, k)
        jgx, jgk = want[m.layer.name]
        for got, ref in ((gk, cgk.numpy()), (gx, cgx.numpy()), (gk, jgk),
                         (gx, jgx)):
            assert_close(got, ref, RTOL_GRAD)


@pytest.mark.parametrize("layer,array", (("CNN8-2", 64), ("CNN8-4", 512)))
def test_duplicate_writers_get_one_gradient(layer, array):
    """The two layers where the parent's scatter double-counted: their
    mappings do write positions more than once, and both executors'
    kernel gradients now match F.conv2d's."""
    _, tnet = _nets("cnn8", array)
    i = [m.layer.name for m in tnet.layers].index(layer)
    m = tnet.layers[i]
    dup = 0
    for tile in m.tiles:
        writes = sum(len(o) * _outputs(m.layer, shape)
                     for shape, o in tcc.placement_groups(m.layer,
                                                          tile).items())
        kept = sum(len(src) for src, _, _ in tcc.kept_writes(m.layer, tile))
        assert kept == m.layer.o_h * m.layer.o_w <= writes
        dup += writes - kept
    assert dup > 0
    x, k = _data(tnet)[i]
    _, want = _conv_grads(m, x, k)
    for port, _ in EXECUTORS.values():
        _, gk = _torch_grads(lambda x, k: port(m, x, k), x, k)
        assert_close(gk, want.numpy(), RTOL_GRAD)


def test_pruned_channels_get_no_gradient():
    """DN40-b2l3 as served (512x512, G <= 4) prunes input channels: the
    executors skip them, so their kernel gradient is exactly 0, and the
    rest equals F.conv2d's."""
    from repro_torch.launch import serve_cnn
    from repro_torch.core import ArrayConfig
    net, _ = serve_cnn.map_for_serving("densenet40", ArrayConfig(512, 512),
                                       "TetrisG-SDK")
    m = next(m for m in net.layers if m.layer.name == "DN40-b2l3")
    assert any(tile.pruned_channels for tile in m.tiles)
    x, k = _data(type(net)(net.name, net.algorithm, net.array, (m,),
                           net.grid))[0]
    cgx, cgk = _conv_grads(m, x, k)
    want = zero_pruned(m, cgk.numpy())
    assert np.abs(want - cgk.numpy()).max() > 0
    for port, _ in EXECUTORS.values():
        gx, gk = _torch_grads(lambda x, k: port(m, x, k), x, k)
        assert_close(gk, want, RTOL_GRAD)
        assert_close(gx, cgx.numpy(), RTOL_GRAD)
        assert not (zero_pruned(m, gk.numpy()) - gk.numpy()).any()


def _outputs(layer, shape):
    """Output positions one window of ``shape`` (ph, pw) writes."""
    s = layer.stride
    return (((shape[0] - layer.k_h) // s + 1)
            * ((shape[1] - layer.k_w) // s + 1))


def _all_writes(layer, tile):
    """Every window's every write, duplicates included: the scatter the
    executors made before they kept one writer per position."""
    out = []
    for shape, origins in tcc.placement_groups(layer, tile).items():
        s = layer.stride
        py = (shape[0] - layer.k_h) // s + 1
        px = (shape[1] - layer.k_w) // s + 1
        oy, ox = np.broadcast_arrays(*tcc.scatter_indices(origins, py, px, s))
        out.append((np.arange(oy.size), oy.reshape(-1), ox.reshape(-1)))
    return tuple(out)


@pytest.mark.parametrize("net_name", sorted(NETS))
def test_forward_is_the_sequential_set_scatter(net_name, monkeypatch):
    """Keeping one writer per position leaves the forward as it was, bit
    for bit: equal to the scatter of every write in placement order with
    set semantics, run sequentially (torch's deterministic mode; without
    it that scatter's winner among duplicates is not defined, and on the
    CPU it varied between two calls on DN40-b1l5 @ 512x512)."""
    for array in (64, 512):
        _, tnet = _nets(net_name, array)
        data = _data(tnet)
        got = [[port(m, t(x), t(k)) for port, _ in EXECUTORS.values()]
               for m, (x, k) in zip(tnet.layers, data)]
        with monkeypatch.context() as mp:
            for mod in (tcc, tmn):
                mp.setattr(mod, "kept_writes", _all_writes)
            torch.use_deterministic_algorithms(True)
            try:
                want = [[port(m, t(x), t(k)) for port, _ in
                         EXECUTORS.values()]
                        for m, (x, k) in zip(tnet.layers, data)]
            finally:
                torch.use_deterministic_algorithms(False)
        for m, g, w in zip(tnet.layers, got, want):
            for a, b in zip(g, w):
                assert torch.equal(a, b), (array, m.layer.name)


@pytest.mark.parametrize("net_name", sorted(NETS))
def test_weight_matrix_scatter_has_no_duplicates(net_name):
    """build_weight_matrix's scatter ``W[:, ys, xs, p, :]`` writes every
    (window pixel, position) once, so its backward needs no mask."""
    for array in (64, 512):
        _, tnet = _nets(net_name, array)
        for m in tnet.layers:
            lay, s = m.layer, m.layer.stride
            for tile in m.tiles:
                for ph, pw in tcc.placement_groups(lay, tile):
                    py = (ph - lay.k_h) // s + 1
                    px = (pw - lay.k_w) // s + 1
                    iy, ix = np.divmod(np.arange(py * px), px)
                    ys = (iy * s)[:, None, None] + np.arange(lay.k_h)[:, None]
                    xs = (ix * s)[:, None, None] + np.arange(lay.k_w)
                    p = np.arange(py * px)[:, None, None]
                    idx = np.stack(np.broadcast_arrays(ys, xs, p), -1)
                    idx = idx.reshape(-1, 3)
                    assert len(np.unique(idx, axis=0)) == len(idx)


# ------------------------------------------------- kernels: no backward

def _needs_grad(*ts):
    return [x.detach().clone().requires_grad_(True) for x in ts]


def _kernel_calls():
    """(name, call(requires_grad: bool)) for each kernel entry point."""
    from repro_torch.core import ArrayConfig, ConvLayerSpec, map_layer
    from repro_torch.kernels import ops, ssd_chunk
    from repro_torch.kernels.matmul_exec import matmul_layer
    from repro_torch.kernels.sdk_conv import sdk_conv
    from repro_torch.core.types import matmul_spec
    rng = np.random.RandomState(3)

    def r(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32))
    m = map_layer(ConvLayerSpec("t", 10, 10, 3, 3, 8, 16),
                  ArrayConfig(128, 128), "VW-SDK")
    mm = map_layer(matmul_spec("mm", 8, 16, 24), ArrayConfig(128, 128),
                   "Tetris-SDK")
    x, k = r(2, 8, 10, 10), r(3, 3, 8, 16)
    a, b, g = r(6, 8), r(8, 5), r(2, 6, 8)
    q = r(2, 16, 8)
    s = (r(1, 16, 2, 4), torch.rand(1, 16, 2) * 0.5 + 0.1, r(2),
         r(1, 16, 1, 4), r(1, 16, 1, 4))

    def with_grad(fn, *ts):
        return lambda grad: fn(*(_needs_grad(*ts) if grad else ts))
    return {
        "sdk_conv whole": with_grad(
            lambda x, k: sdk_conv(m, x, k, block="whole"), x, k),
        "sdk_conv window": with_grad(
            lambda x, k: sdk_conv(m, x, k, block="window"), x, k),
        "tetris_matmul": with_grad(ops.matmul, a, b),
        "grouped_matmul": with_grad(ops.gmm, g, r(2, 8, 5)),
        "flash_attention": with_grad(ops.attention, q, q, q),
        "im2win_conv": with_grad(ops.conv2d, x.permute(0, 2, 3, 1), k),
        "ssd_chunk": with_grad(
            lambda *a: ssd_chunk.ssd_chunk(*a, chunk=8), *s),
        "matmul_layer": with_grad(
            lambda x, k: matmul_layer(mm, x, k), r(2, 16, 8, 1),
            r(1, 1, 16, 24)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_wrappers_refuse_autograd(name):
    """Every kernel entry point (both sdk block modes, the four ops
    wrappers, ssd_chunk and the matmul executor) raises when autograd
    would have to differentiate it, on the CPU as on the card; without
    grad, or under torch.no_grad, it computes."""
    call = _kernel_calls()[name]
    with pytest.raises(RuntimeError, match="has no backward"):
        call(True)
    call(False)
    with torch.no_grad():
        call(True)


def test_plain_versions_stay_differentiable():
    from repro_torch.core import ArrayConfig, ConvLayerSpec, map_layer
    from repro_torch.kernels.sdk_conv import sdk_conv_plain
    from repro_torch.kernels.tetris_matmul import matmul_ref
    m = map_layer(ConvLayerSpec("t", 10, 10, 3, 3, 8, 16),
                  ArrayConfig(128, 128), "VW-SDK")

    x, k = _needs_grad(torch.randn(2, 8, 10, 10), torch.randn(3, 3, 8, 16))
    (sdk_conv_plain(m, x, k) ** 2).sum().backward()
    _, want = _conv_grads(m, x.detach().numpy(), k.detach().numpy())
    assert_close(k.grad, want.numpy(), RTOL_GRAD)
    a, b = _needs_grad(torch.randn(4, 3), torch.randn(3, 2))
    matmul_ref(a, b).sum().backward()
    assert a.grad is not None and b.grad is not None
