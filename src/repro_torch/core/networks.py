"""Benchmark network conv-layer specs (paper §IV-A, Table I).

IFM sizes are the *padded* sizes used by the paper's tables (CNN8 and
Inception rows reproduce Table I exactly: e.g. CNN8-2 is an 18x18 IFM
for a 16x16 feature map under 3x3/pad-1).  DenseNet40 / MobileNet follow
their standard literature configurations; where the paper under-specifies
(it reports only totals), the construction is documented inline.

The same specs feed every stage of the pipeline: the mapping searches
(core/mapper.py), the simulator (§IV-D), the trained CNNs
(cnn/models.py builds its stacks from ``ConvLayerSpec``) and the
mapped-network executor (cnn/mapped_net.py chains these stacks
layer-by-layer — plain for CNN8, dense-concat for DenseNet40).

Invariants:

* layer order is forward-pass order; consecutive specs are chainable
  (next ic == this oc, or == carried channels + oc for dense blocks) —
  relied on by ``mapped_net_apply`` and its tests;
* ``stride``/``groups`` stay in the spec (MobileNet depthwise carries
  ``groups=ic``); nothing is pre-lowered, so every algorithm sees the
  layer the paper's tables describe;
* ``NETWORKS`` maps the paper's four benchmark names to zero-argument
  constructors (the benchmark scripts' registry).
"""
from __future__ import annotations

from typing import List

from .types import ConvLayerSpec


def _c(name, i, k, ic, oc, stride=1, groups=1) -> ConvLayerSpec:
    return ConvLayerSpec(name=name, i_w=i, i_h=i, k_w=k, k_h=k,
                         ic=ic, oc=oc, stride=stride, groups=groups)


def cnn8() -> List[ConvLayerSpec]:
    """CNN8 from VW-SDK [20]; layer 1 excluded (not quantised/accelerated,
    §IV-B).  Rows match Table I verbatim."""
    return [
        _c("CNN8-2", 18, 3, 24, 32),
        _c("CNN8-3", 18, 3, 32, 32),
        _c("CNN8-4", 9, 3, 32, 64),
        _c("CNN8-5", 7, 3, 64, 64),
        _c("CNN8-6", 7, 3, 64, 64),
        _c("CNN8-7", 5, 5, 64, 256),
    ]


def inception() -> List[ConvLayerSpec]:
    """GoogLeNet Inception 5x5 branches (Table I rows)."""
    return [
        _c("Incep-3a", 28, 5, 16, 32),
        _c("Incep-3b", 28, 5, 32, 96),
        _c("Incep-4a", 14, 5, 16, 48),
        _c("Incep-4b", 14, 5, 24, 64),
        _c("Incep-4c", 14, 5, 24, 64),
        _c("Incep-4d", 14, 5, 32, 64),
        _c("Incep-4e", 14, 5, 32, 128),
        _c("Incep-5a", 7, 5, 32, 128),
    ]


def densenet40(growth: int = 12, init_ch: int = 16) -> List[ConvLayerSpec]:
    """DenseNet-40 (3 dense blocks x 12 layers, growth k=12, no
    bottleneck/compression — the original DenseNet(L=40,k=12) [33]).

    3x3 convs inside blocks (pad 1 => IFM+2); 1x1 transition convs between
    blocks.  CIFAR geometry: blocks at 32/16/8 spatial.
    """
    layers: List[ConvLayerSpec] = []
    ch = init_ch
    size = 32
    for b in range(3):
        for li in range(12):
            layers.append(_c(f"DN40-b{b+1}l{li+1}", size + 2, 3, ch, growth))
            ch += growth
        if b < 2:
            layers.append(_c(f"DN40-t{b+1}", size, 1, ch, ch))
            size //= 2
    return layers


def mobilenet(width: int = 32) -> List[ConvLayerSpec]:
    """MobileNetV1 depthwise-separable stack at CIFAR geometry (§IV-C3:
    'mixture of depthwise and pointwise layers limits cross-channel reuse').

    Depthwise layers carry groups=IC (each group is a 1-channel conv);
    pointwise layers are 1x1.  Stride-2 layers keep stride in the spec.
    """
    cfg = [  # (dw stride, out channels) per separable block
        (1, 64), (2, 128), (1, 128), (2, 256), (1, 256),
        (2, 512), (1, 512), (1, 512),
    ]
    layers: List[ConvLayerSpec] = []
    size, ch = width, 32
    for i, (s, oc) in enumerate(cfg):
        layers.append(_c(f"MBN-dw{i+1}", size + 2, 3, ch, ch,
                         stride=s, groups=ch))
        size = size // s
        layers.append(_c(f"MBN-pw{i+1}", size, 1, ch, oc))
        ch = oc
    return layers


NETWORKS = {
    "cnn8": cnn8,
    "inception": inception,
    "densenet40": densenet40,
    "mobilenet": mobilenet,
}
