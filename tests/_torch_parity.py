"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
map one layer with both packages, draw numpy inputs from a seed, and
compare a port result with the JAX package's.

Every comparison is f32 against f32 with the same products summed in a
different order, so tolerances are stated relative to max|y|."""
import dataclasses

import numpy as np
import torch

from repro import core as jcore
from repro_torch import core as tcore

#: one layer, f32, another summation order: relative to max|y|
RTOL_LAYER = 1e-5
#: a chain of layers with glue between: relative to max|y|
RTOL_NET = 1e-4


def map_layer_both(make, array, alg, grid=(1, 1), **kw):
    """(jax mapping, port mapping) of ``make(core)`` — the two must agree
    field by field before any arithmetic is compared."""
    out = []
    for core in (jcore, tcore):
        out.append(core.map_layer(make(core), core.ArrayConfig(*array), alg,
                                  core.MacroGrid(*grid), **kw))
    assert dataclasses.astuple(out[0]) == dataclasses.astuple(out[1])
    return tuple(out)


def map_net_both(name, layers_of, array, alg, grid=(1, 1), **kw):
    """(jax mapping, port mapping) of a network; ``layers_of(core)``
    gives its layer specs."""
    out = []
    for core in (jcore, tcore):
        out.append(core.map_net(name, layers_of(core),
                                core.ArrayConfig(*array), alg,
                                core.MacroGrid(*grid), **kw))
    assert dataclasses.astuple(out[0]) == dataclasses.astuple(out[1])
    return tuple(out)


def zero_pruned(mapping, k):
    """Zero each tile's pruned trailing input channels of a numpy kernel."""
    k = k.copy()
    c_base = 0
    for t in mapping.tiles:
        c_base += t.depth
        k[:, :, c_base:c_base + t.pruned_channels] = 0.0
        c_base += t.pruned_channels
    return k


def layer_data(mapping, rng, batch=2, scale=1.0):
    """Seeded numpy f32 input and grouped-HWIO kernel of one layer."""
    lay = mapping.layer
    x = rng.randn(batch, lay.ic, lay.i_h, lay.i_w).astype(np.float32)
    k = (rng.randn(lay.k_h, lay.k_w, lay.ic // mapping.group, lay.oc)
         * scale).astype(np.float32)
    return x, zero_pruned(mapping, k)


def net_data(net, rng, batch=2):
    """Seeded numpy kernels (x0.1, pruned zeroed) and input of a net."""
    ks = [layer_data(m, rng, batch=1, scale=0.1)[1] for m in net.layers]
    first = net.layers[0].layer
    x = rng.randn(batch, first.ic, first.i_h, first.i_w).astype(np.float32)
    return ks, x


def t(a):
    """numpy -> CPU torch tensor."""
    return torch.as_tensor(np.asarray(a))


def assert_close(got, want, rtol):
    """max|got - want| <= rtol * max|want|, shapes equal."""
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, \
        f"max abs err {err:.3e} > {rtol:g} * max|y| ({scale:.3e})"
