"""The plain reference against hand-written results at tiny sizes."""
import math

import pytest
import torch
import torch.nn.functional as F

from portbench import reference
from portbench.reference import precision

TINY_CNN = {
    "name": "tiny", "kind": "cnn", "activation": "relu",
    "layers": [
        {"name": "a", "i_h": 8, "i_w": 8, "k_h": 3, "k_w": 3, "ic": 4,
         "oc": 8, "stride": 1},
        {"name": "b", "i_h": 8, "i_w": 8, "k_h": 3, "k_w": 3, "ic": 8,
         "oc": 4, "stride": 1},
        # input 8 + 4 channels: concatenates b's input with its output
        {"name": "c", "i_h": 3, "i_w": 3, "k_h": 3, "k_w": 3, "ic": 12,
         "oc": 6, "stride": 1},
    ],
    "pins": {"a": {"group": 2, "tiles": [[1, 1]]},
             "b": {"group": 1, "tiles": [[3, 1], [4, 0]]},
             "c": {"group": 3, "tiles": [[4, 0]]}},
}


def _kernels(cfg, gen):
    return [torch.randn(ly["k_h"], ly["k_w"],
                        ly["ic"] // cfg["pins"][ly["name"]]["group"],
                        ly["oc"], generator=gen) for ly in cfg["layers"]]


def test_cnn_matches_conv2d_with_pruned_slices_zeroed():
    gen = torch.Generator().manual_seed(0)
    ks = _kernels(TINY_CNN, gen)
    x = torch.randn(3, 4, 8, 8, generator=gen)
    y = reference.forward(TINY_CNN, {}, ks, x)
    # by hand: a keeps channel 0 of each 2-channel group; b keeps 0-2 and
    # 4-7 of its 8; c keeps all
    ka = ks[0].clone()
    ka[:, :, 1] = 0
    kb = ks[1].clone()
    kb[:, :, 3] = 0

    def conv(t, k, g):
        return F.relu(F.conv2d(t, k.permute(3, 2, 0, 1), groups=g))

    h = conv(x, ka, 2)                       # (3, 8, 6, 6)
    h = F.pad(h, (1, 1, 1, 1))               # fitted to 8x8
    hb = conv(h, kb, 1)                      # (3, 4, 6, 6)
    cat = torch.cat([h[..., 1:7, 1:7], hb], dim=1)  # 8 + 4 channels
    cat = F.max_pool2d(cat, 2, 2)            # 6x6 -> 3x3
    want = conv(cat, ks[2], 3)
    assert y.shape == want.shape == (3, 6, 1, 1)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def _lm(layers=2, d=16, hq=4, hkv=2, ff=24, groups=(2, 2, 2, 2)):
    return {"name": "lm", "kind": "transformer", "num_hidden_layers": layers,
            "hidden_size": d, "num_attention_heads": hq,
            "num_key_value_heads": hkv, "intermediate_size": ff,
            "layer_norm_eps": 1e-5, "causal": True,
            "pins": {k: {"group": g, "tiles": [[{"qkv": d, "o": d, "w1": d,
                                                 "w2": ff}[k] // g, 0]]}
                     for k, g in zip(("qkv", "o", "w1", "w2"), groups)}}


def _dense(kernel, g):
    """The (ic, oc) block-diagonal matrix of a grouped kernel."""
    w = kernel[0, 0]
    d_g, oc = w.shape
    f_g = oc // g
    out = torch.zeros(d_g * g, oc)
    for i in range(g):
        out[i * d_g:(i + 1) * d_g, i * f_g:(i + 1) * f_g] = \
            w[:, i * f_g:(i + 1) * f_g]
    return out


def test_transformer_matches_dense_blocks_and_sdpa():
    cfg = _lm()
    gen = torch.Generator().manual_seed(1)
    d, hq, hkv, ff, hd = 16, 4, 2, 24, 4
    shapes = [(d, (hq + 2 * hkv) * hd), (hq * hd, d), (d, ff), (ff, d)] * 2
    ks = [torch.randn(1, 1, ic // 2, oc, generator=gen) * 0.3
          for ic, oc in shapes]
    x = torch.randn(2, d, 7, 1, generator=gen)
    y = reference.forward(cfg, {}, ks, x)

    t = x[..., 0].transpose(1, 2)
    for blk in range(2):
        wq, wo, w1, w2 = (_dense(k, 2) for k in ks[4 * blk:4 * blk + 4])
        qkv = F.layer_norm(t, (d,), eps=1e-5) @ wq
        q = qkv[..., :hq * hd].unflatten(-1, (hq, hd)).transpose(1, 2)
        k = qkv[..., hq * hd:(hq + hkv) * hd].unflatten(-1, (hkv, hd))
        v = qkv[..., (hq + hkv) * hd:].unflatten(-1, (hkv, hd))
        k = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
        v = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
        ctx = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        t = t + ctx.transpose(1, 2).flatten(2) @ wo
        t = t + F.silu(F.layer_norm(t, (d,), eps=1e-5) @ w1) @ w2
    want = t.transpose(1, 2)[..., None]
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -10 + 2 ** -12), 3.0e-5])
    r = precision.to_tf32(x)
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2 ** -9
    assert r[3] == -(1.0 + 2 ** -10)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    torch.testing.assert_close(precision.to_tf32(r), r, rtol=0, atol=0)
    y = torch.randn(10000, generator=torch.Generator().manual_seed(2))
    assert float(((precision.to_tf32(y) - y) / y).abs().max()) <= 2 ** -11


def test_tf32_control_departs_from_f32():
    gen = torch.Generator().manual_seed(3)
    ks = _kernels(TINY_CNN, gen)
    x = torch.randn(4, 4, 8, 8, generator=gen)
    y = reference.forward(TINY_CNN, {}, ks, x)
    c = reference.forward(TINY_CNN, {}, ks, x, precision="tf32")
    err = float((c - y).abs().max() / y.abs().max())
    assert 1e-5 < err < 1e-2
    assert math.isfinite(err)


def test_unknown_precision_and_kind():
    with pytest.raises(ValueError):
        precision.operand(torch.ones(1), "bf16")
    with pytest.raises(ValueError):
        reference.forward({"name": "x", "kind": "rnn"}, {}, [], None)
