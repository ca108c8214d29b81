"""The port's inter-layer glue (repro_torch.exec.glue) against the JAX
package's (repro.exec.glue): the counterparts of tests/test_glue.py —
fit_spatial / center_crop geometry (odd sizes, identity no-op,
pool-then-pad) and the chain-classification errors, each case run
through both packages on the same numpy input and compared exactly
(the glue only moves, pads and max-pools values)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.exec import glue as jglue                            # noqa: E402
from repro_torch.exec import glue as tglue                      # noqa: E402


def _x(h, w, b=2, c=3, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(b, c, h, w).astype(np.float32)


def _both(fn_name, x, *args):
    """(jax result, port result) of one glue function, as numpy."""
    j = getattr(jglue, fn_name)(jnp.asarray(x), *args)
    t = getattr(tglue, fn_name)(torch.as_tensor(x), *args)
    return np.asarray(j), t.numpy()


def test_fit_spatial_identity_noop():
    x = torch.as_tensor(_x(18, 18))
    assert tglue.fit_spatial(x, 18, 18) is x


def test_fit_spatial_center_pad_even_and_odd():
    x = _x(5, 4)
    j, t = _both("fit_spatial", x, 8, 7)
    assert t.shape[-2:] == (8, 7)
    np.testing.assert_array_equal(t, j)
    # centred: floor(pad/2) before, remainder after; zero padding only
    np.testing.assert_array_equal(t[..., 1:6, 1:5], x)
    assert np.abs(t).sum() == pytest.approx(np.abs(x).sum(), rel=1e-6)


def test_fit_spatial_center_crop_odd_sizes():
    x = _x(9, 7)
    j, t = _both("fit_spatial", x, 6, 4)
    assert t.shape[-2:] == (6, 4)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, x[..., 1:7, 1:5])


def test_fit_spatial_pools_exact():
    """>= 2x on both axes pools (2x2 max) down to the exact target —
    the DenseNet transition shape."""
    x = _x(16, 16)
    j, t = _both("fit_spatial", x, 8, 8)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        t, x.reshape(2, 3, 8, 2, 8, 2).max(axis=(3, 5)))


def test_fit_spatial_pools_then_crops_odd_target():
    """Pooling stops below 2x the target; the odd remainder is cropped
    (a leading slice when the surplus is a single row/column)."""
    x = _x(16, 16)
    j, t = _both("fit_spatial", x, 7, 7)
    assert t.shape[-2:] == (7, 7)
    np.testing.assert_array_equal(t, j)
    pooled = x.reshape(2, 3, 8, 2, 8, 2).max(axis=(3, 5))
    np.testing.assert_array_equal(t, pooled[..., :7, :7])


def test_fit_spatial_pools_only_when_both_axes_large():
    x = _x(16, 6)                 # width below 2x target: no pooling
    j, t = _both("fit_spatial", x, 8, 6)
    assert t.shape[-2:] == (8, 6)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, x[..., 4:12, :])


def test_center_crop_odd_and_identity():
    x = _x(7, 9)
    j, t = _both("center_crop", x, 7, 9)
    np.testing.assert_array_equal(t, x)
    np.testing.assert_array_equal(t, j)
    j, t = _both("center_crop", x, 4, 5)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, x[..., 1:5, 2:7])


def test_resolve_chain_kinds_and_error():
    for rc in (jglue.resolve_chain, tglue.resolve_chain):
        assert rc("a", 32, 16, "b", 32) == "chain"
        assert rc("a", 32, 16, "b", 48) == "concat"
        with pytest.raises(ValueError, match=r"cannot chain a \(oc=32, "
                                             r"carry=16\) into b \(ic=40\)"):
            rc("a", 32, 16, "b", 40)


def test_concat_carry_mismatch_raises_at_compile():
    """A DenseNet-style stack whose concat arithmetic breaks raises the
    clear chaining error from compile_plan (not mid-forward), in both
    packages."""
    from repro import core as jcore
    from repro.exec import compile_plan as j_compile
    from repro_torch import core as tcore
    from repro_torch.exec import compile_plan as t_compile
    for core, compile_plan, kw in ((jcore, j_compile, {}),
                                   (tcore, t_compile, {"device": "cpu"})):
        layers = [
            core.ConvLayerSpec("a", 10, 10, 3, 3, 8, 12),
            core.ConvLayerSpec("b", 8, 8, 3, 3, 20, 12),  # 8 + 12: concat
            core.ConvLayerSpec("c", 6, 6, 3, 3, 13, 8),   # neither 12 nor 32
        ]
        net = core.map_net("bad", layers, core.ArrayConfig(64, 64),
                           "Tetris-SDK", core.MacroGrid(1, 1))
        with pytest.raises(ValueError, match="cannot chain b"):
            compile_plan(net, executor_policy="reference", **kw)
