"""The host side of the ``reference`` executor's card path
(``kernels/sdk_conv.py::sdk_placed``) on every layer the ``auto`` policy
sends to ``reference`` on the card, in cnn8, inception and densenet40
mapped by TetrisG-SDK on a 512x512 array (groups 1, 2, 4): the launches
follow ``placement_groups`` tile by tile, their steps are the mapping's
cycles, the output's coverage is read from the placements, every launch
layout fits a block and computes each (group, window, image, column)
once, and the C geometry handed to ``sdk_conv_placed``, decoded on the
CPU as the kernel decodes it, reproduces ``cim_conv2d``.  The kernel
itself is held to ``cim_conv2d`` and ``F.conv2d`` on the card by
tests/test_torch_cuda.py.  Imports torch only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.cnn.cim_conv import (cim_conv2d, kept_writes,  # noqa: E402
                                      placement_groups)
from repro_torch.core import ArrayConfig                        # noqa: E402
from repro_torch.exec import compile_plan                       # noqa: E402
from repro_torch.exec.plan import _auto_executor                # noqa: E402
from repro_torch.kernels import sdk_conv as sk                  # noqa: E402
from repro_torch.launch.serve_cnn import map_for_serving        # noqa: E402

NETS = ("cnn8", "inception", "densenet40")


def _net(name):
    return map_for_serving(name, ArrayConfig(512, 512), "TetrisG-SDK")[0]


def _reference_layers():
    """(net, layer name) of every layer ``auto`` runs on ``reference`` on
    the card: 1 in cnn8, 2 in inception, 18 in densenet40."""
    return [(n, m.layer.name) for n in NETS for m in _net(n).layers
            if _auto_executor(m, backend="cuda") == "reference"]


REFERENCE_LAYERS = _reference_layers()


def _mapping(net, name):
    return next(m for m in _net(net).layers if m.layer.name == name)


def test_reference_layers_of_the_three_nets():
    counts = {n: sum(1 for net, _ in REFERENCE_LAYERS if net == n)
              for n in NETS}
    assert counts == {"cnn8": 1, "inception": 2, "densenet40": 18}


@pytest.mark.parametrize("net,name", REFERENCE_LAYERS)
def test_placed_launches_follow_placement_groups(net, name):
    """Tile by tile, one launch per window shape in ``placement_groups``
    order with that shape's origins and geometry; the tile's kept
    channels at its channel offset (pruned ones skipped), every group's
    oc in the launch; the steps sum to ``mapping.cycles``."""
    m = _mapping(net, name)
    lay = m.layer
    want, c_base = [], 0
    for ti, tile in enumerate(m.tiles):
        for (ph, pw), org in placement_groups(lay, tile).items():
            want.append((ti, ph, pw, org, c_base, tile.depth))
        c_base += tile.depth + tile.pruned_channels
    placed = sk.placed_layer(m)
    got = placed.launches
    assert len(got) == len(want)
    for ln, (ti, ph, pw, org, base, kept) in zip(got, want):
        g = ln.geom
        assert (ln.tile, g.pw_h, g.pw_w, g.nw) == (ti, ph, pw, len(org))
        np.testing.assert_array_equal(ln.origins, org)
        assert ln.origins.dtype == np.int32
        assert (g.py, g.px) == ((ph - lay.k_h) // lay.stride + 1,
                                (pw - lay.k_w) // lay.stride + 1)
        assert (ln.c_base, g.ic_t, g.ar_c) == (base, kept, 1)
        assert (g.oc_t, g.ac_c) == (lay.oc // m.group, m.group)
    steps = 0
    for ln in got:
        _, ar_c, _, ac_c = m.tile_passes(m.tiles[ln.tile])
        steps += ar_c * ac_c * ln.geom.nw * m.group
    assert placed.steps == steps == m.cycles


@pytest.mark.parametrize("net,name", REFERENCE_LAYERS)
def test_placed_coverage_from_the_placements(net, name):
    """``placed_layer``'s coverage against the writers ``kept_writes``
    keeps: a tile covers its output when its kept writers reach every
    position once.  Every reference layer of the three nets is covered,
    so ``sdk_placed`` allocates its output without a fill."""
    m = _mapping(net, name)
    lay = m.layer
    for tile in m.tiles:
        pos = np.concatenate([oy * lay.o_w + ox
                              for _, oy, ox in kept_writes(lay, tile)])
        assert np.array_equal(np.sort(pos), np.arange(lay.o_h * lay.o_w))
    assert sk.placed_layer(m).covers_output


def test_placed_coverage_detects_a_gap():
    """A tile whose marginal strip is dropped leaves the right-hand
    columns unwritten: coverage is false there."""
    import dataclasses
    m = _mapping("cnn8", "CNN8-2")
    tile = m.tiles[0]
    assert tile.marginals
    cut = dataclasses.replace(tile, marginals=tile.marginals[1:])
    gap = dataclasses.replace(m, tiles=(cut,))
    assert sk.placed_layer(m).covers_output
    assert not sk.placed_layer(gap).covers_output


def _grid_cover(b, g, d):
    """How often the placed kernel's grid, decoded as csrc/sdk_conv.cu
    decodes it (x: group and column part, y: run of windows, z: image
    chunk), computes each (group, window, image, column)."""
    parts = -(-g.oc_t // d.oc_b)
    seen = np.zeros((g.ac_c, g.nw, b, g.oc_t), dtype=int)
    for bx in range(g.ac_c * parts):
        oi, part = divmod(bx, parts)
        o_lo = part * d.oc_b
        for by in range(-(-g.nw // d.run)):
            for bz in range(-(-b // d.b_chunk)):
                seen[oi, by * d.run:(by + 1) * d.run,
                     bz * d.b_chunk:(bz + 1) * d.b_chunk,
                     o_lo:o_lo + d.oc_b] += 1
    return seen


@pytest.mark.parametrize("batch", [1, 8, 256, 8192])
@pytest.mark.parametrize("net,name", REFERENCE_LAYERS)
def test_placed_launch_dims_fit_and_cover(net, name, batch):
    """``window_launch_dims`` on each launch: the block fits 227 KB of
    shared memory and the grid computes every (group, window, image,
    column) exactly once."""
    m = _mapping(net, name)
    for ln in sk.placed_layer(m).launches:
        g = ln.geom
        d = sk.window_launch_dims(batch, g)
        assert d.smem <= sk.SMEM_LIMIT
        assert 1 <= d.b_chunk <= batch and 1 <= d.run <= g.nw
        if batch <= 256:
            assert (_grid_cover(batch, g, d) == 1).all()
        assert d.blocks == (g.ac_c * -(-g.oc_t // d.oc_b)
                            * -(-g.nw // d.run) * -(-batch // d.b_chunk))


def _decode_calls(m, x, k):
    """The placed kernel's arithmetic on the CPU, read from the C
    geometry and origin tables ``sdk_placed`` hands to the entry: group
    oi reads x's channels oi*ic_g + c_base + c and the kernel's rows
    c_base + c and columns oi*oc_t + o, each window stores its output
    tile into its tile's slot, and the slots are summed."""
    lay = m.layer
    ic_g = lay.ic // m.group
    b = x.shape[0]
    args = sk._placed_args(m, b, x.device)
    assert [ln for ln, _, _ in args] == list(sk.placed_layer(m).launches)
    out = torch.full((len(m.tiles), b, lay.oc, lay.o_h, lay.o_w),
                     float("nan"))
    for ln, g, origins in args:
        assert (g.b, g.ic_pad, g.oc_pad, g.ar_c) == (b, lay.ic, lay.oc, 1)
        assert g.nw == len(origins) and origins.dtype == torch.int32
        assert ln.c_base + g.ic_t <= ic_g
        assert g.ac_c * g.oc_t == lay.oc
        for oi in range(g.ac_c):
            xc = x[:, oi * ic_g + ln.c_base:oi * ic_g + ln.c_base + g.ic_t]
            kc = k[:, :, ln.c_base:ln.c_base + g.ic_t,
                   oi * g.oc_t:(oi + 1) * g.oc_t]
            for y0, x0 in origins.tolist():
                assert y0 + g.pw_h <= g.i_h and x0 + g.pw_w <= g.i_w
                win = xc[..., y0:y0 + g.pw_h, x0:x0 + g.pw_w]
                val = torch.nn.functional.conv2d(win, kc.permute(3, 2, 0, 1),
                                                 stride=g.s)
                assert val.shape[-2:] == (g.py, g.px)
                out[ln.tile, :, oi * g.oc_t:(oi + 1) * g.oc_t,
                    y0 // g.s:y0 // g.s + g.py,
                    x0 // g.s:x0 // g.s + g.px] = val
    return out.sum(dim=0)


@pytest.mark.parametrize("net,name", REFERENCE_LAYERS)
def test_placed_calls_decode_to_cim_conv2d(net, name):
    """The launches as the C entry receives them compute the layer:
    within 1e-5 of max|y| of ``cim_conv2d`` (both skip the pruned
    channels), every position written."""
    m = _mapping(net, name)
    lay = m.layer
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(2, lay.ic, lay.i_h, lay.i_w)
                        .astype(np.float32))
    k = torch.as_tensor(rng.randn(lay.k_h, lay.k_w, lay.ic // m.group,
                                  lay.oc).astype(np.float32))
    got = _decode_calls(m, x, k)
    want = cim_conv2d(m, x, k)
    assert not torch.isnan(got).any()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_cnn8_plan_predicts_three_placed_launches():
    """cnn8's plan under the card's auto policy at batch 8192: CNN8-2 on
    ``reference`` makes 3 ``sdk_placed`` launches (its three window
    shapes, all four groups in each), CNN8-3..7 15 ``sdk_window``
    launches; densenet40's plan one launch per (tile, shape) of its 18
    reference layers."""
    net = _net("cnn8")
    policy = [_auto_executor(m, backend="cuda") for m in net.layers]
    assert policy == ["reference"] + ["sdk"] * 5
    plan = compile_plan(net, executor_policy=policy, batch=8192,
                        device="cpu")
    n = plan.launches_per_forward()
    assert (n["sdk_placed"], n["sdk_window"], n["sdk_whole"]) == (3, 15, 0)
    dn = _net("densenet40")
    policy = [_auto_executor(m, backend="cuda") for m in dn.layers]
    plan = compile_plan(dn, executor_policy=policy, batch=8, device="cpu")
    assert plan.launches_per_forward()["sdk_placed"] == sum(
        len(sk.placed_layer(m).launches) for m, e in zip(dn.layers, policy)
        if e == "reference")


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("requires", [(False, False), (True, False),
                                      (False, True)])
def test_needs_backward_is_the_kernels_refusal(grad, requires):
    """``needs_backward`` — the reference executor's choice of the
    placed kernel on the card — is the rule ``no_backward`` refuses a
    kernel call by: grad mode on and an operand that requires grad."""
    from repro_torch.kernels._build import needs_backward, no_backward
    ops = [torch.zeros(2, requires_grad=r) for r in requires]
    with torch.set_grad_enabled(grad):
        want = grad and any(requires)
        assert needs_backward(*ops) == want
        if want:
            with pytest.raises(RuntimeError, match="has no backward"):
                no_backward("k", *ops)
        else:
            no_backward("k", *ops)


@pytest.mark.parametrize("grad", [True, False])
def test_reference_executor_on_the_cpu_runs_cim_conv2d(grad):
    """On the CPU the reference branch runs ``cim_conv2d``, with autograd
    on or off: no launch and no fall-back counted (a fall-back is the
    card's), and the forward equals the oracle."""
    from repro_torch.exec import execute_oracle, execute_plan
    from repro_torch.launch import serve_cnn
    net = _net("cnn8")
    plan = compile_plan(net, executor_policy="reference", batch=1,
                        device="cpu")
    ks, xh = serve_cnn.serving_inputs(net, 1, 0, "cpu")
    ks = [k.requires_grad_(grad) for k in ks]
    x = torch.as_tensor(xh)
    sk.reset_counts()
    with torch.set_grad_enabled(grad):
        y = execute_plan(plan, ks, x)
    assert (sk.sdk_placed.launches, sk.sdk_placed.fallbacks) == (0, 0)
    assert (y.grad_fn is not None) == grad
    with torch.no_grad():
        ref = execute_oracle(plan, ks, x)
    y = y.detach()
    assert float((y - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
