"""The work a forward needs, counted from a configuration file and a
cell's traffic alone, and the peaks it is measured against.

Every count is of the function the configuration pins (its groups and
the channels each tile keeps), not of what a kernel happens to read or
compute: a grouped layer's useful operations are those of its G diagonal
blocks, and each input, weight and output byte is counted once.

* a conv layer: ``2 * B * oc * o_h * o_w * k_h * k_w * kept`` FLOPs,
  with ``kept`` the input channels one group keeps; bytes: the kept
  input, the kernel and the output, f32, once each;
* a grouped matmul layer (M = B * S tokens): ``2 * M * kept * oc``
  FLOPs (``2 * G * M * D * F`` with D = kept, F = oc / G); bytes: x, w
  and the output once each;
* an attention stage: QK^T and PV over the pairs the mask keeps,
  ``4 * B * H * hd * pairs`` with ``pairs = S * (S + 1) / 2`` causal and
  ``S * S`` otherwise; bytes: q, k, v and the output once each.

:data:`PEAK_F32_FLOPS` and :data:`PEAK_HBM_BYTES_S` are one H100 SXM's
published f32 (outside the tensor cores) and HBM rates at 700 W.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

#: one H100 SXM, f32 on the CUDA cores (FLOP/s): the precision every
#: configuration here runs at
PEAK_F32_FLOPS = 67e12
#: one H100 SXM, HBM3 (bytes/s)
PEAK_HBM_BYTES_S = 3.35e12
F32 = 4


@dataclass(frozen=True)
class Work:
    """One unit of a forward's work: a mapped layer or an attention
    stage (``kind`` ``"conv"``, ``"matmul"`` or ``"attention"``)."""

    name: str
    kind: str
    flops: float
    bytes: float
    group: int = 1

    def min_seconds(self, peak_flops: float = PEAK_F32_FLOPS,
                    peak_bytes_s: float = PEAK_HBM_BYTES_S) -> float:
        """The least time the chip could take: the larger of the
        operations at the FLOP peak and the bytes at the HBM peak."""
        return max(self.flops / peak_flops, self.bytes / peak_bytes_s)


def kept_channels(pin: dict) -> int:
    """Input channels one group keeps: the sum of its tiles' kept
    channels."""
    return sum(kept for kept, _ in pin["tiles"])


def conv_out(size: int, k: int, stride: int) -> int:
    return (size - k) // stride + 1


def conv_work(layer: dict, pin: dict, batch: int) -> Work:
    g = pin["group"]
    kept = kept_channels(pin)
    o_h = conv_out(layer["i_h"], layer["k_h"], layer["stride"])
    o_w = conv_out(layer["i_w"], layer["k_w"], layer["stride"])
    flops = (2 * batch * layer["oc"] * o_h * o_w * layer["k_h"]
             * layer["k_w"] * kept)
    nbytes = F32 * (batch * kept * g * layer["i_h"] * layer["i_w"]
                    + layer["k_h"] * layer["k_w"] * kept * layer["oc"]
                    + batch * layer["oc"] * o_h * o_w)
    return Work(layer["name"], "conv", flops, nbytes, g)


def dense_conv_flops(layer: dict, batch: int) -> float:
    """The layer's FLOPs with no grouping and every channel kept: the
    count of the paper's Table I layer as published."""
    o_h = conv_out(layer["i_h"], layer["k_h"], layer["stride"])
    o_w = conv_out(layer["i_w"], layer["k_w"], layer["stride"])
    return (2 * batch * layer["oc"] * o_h * o_w * layer["k_h"]
            * layer["k_w"] * layer["ic"])


def matmul_work(name: str, tokens: int, ic: int, oc: int, pin: dict
                ) -> Work:
    g = pin["group"]
    kept = kept_channels(pin)
    flops = 2 * tokens * kept * oc
    nbytes = F32 * (tokens * kept * g + kept * oc + tokens * oc)
    return Work(name, "matmul", flops, nbytes, g)


def attention_work(name: str, batch: int, seq: int, heads: int,
                   kv_heads: int, head_dim: int, causal: bool) -> Work:
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    flops = 4 * batch * heads * head_dim * pairs
    nbytes = F32 * batch * seq * head_dim * (2 * heads + 2 * kv_heads)
    return Work(name, "attention", flops, nbytes)


def transformer_dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    hq = cfg["num_attention_heads"]
    hkv = cfg.get("num_key_value_heads") or hq
    hd = cfg.get("head_dim") or d // hq
    return {"d": d, "hq": hq, "hkv": hkv, "hd": hd,
            "ff": cfg["intermediate_size"],
            "layers": cfg["num_hidden_layers"]}


def projections(cfg: dict) -> List[tuple]:
    """(kind, ic, oc) of one block's four mapped matmuls, in order."""
    t = transformer_dims(cfg)
    return [("qkv", t["d"], (t["hq"] + 2 * t["hkv"]) * t["hd"]),
            ("o", t["hq"] * t["hd"], t["d"]),
            ("w1", t["d"], t["ff"]),
            ("w2", t["ff"], t["d"])]


def forward_work(cfg: dict, traffic: dict) -> List[Work]:
    """Every unit of work of one forward of a batch of the cell, in
    execution order; a mapped layer's ``name`` is the program's layer
    name."""
    batch = traffic["batch"]
    if cfg["kind"] == "cnn":
        return [conv_work(layer, cfg["pins"][layer["name"]], batch)
                for layer in cfg["layers"]]
    if cfg["kind"] == "transformer":
        t = transformer_dims(cfg)
        seq = traffic["seq"]
        out = []
        for i in range(t["layers"]):
            for kind, ic, oc in projections(cfg):
                out.append(matmul_work(f"blk{i}.{kind}", batch * seq, ic,
                                       oc, cfg["pins"][kind]))
                if kind == "qkv":
                    out.append(attention_work(
                        f"blk{i}.attention", batch, seq, t["hq"],
                        t["hkv"], t["hd"], cfg.get("causal", True)))
        return out
    raise ValueError(f"{cfg['name']}: unknown kind {cfg['kind']!r}")


def forward_flops(cfg: dict, traffic: dict) -> float:
    """Useful FLOPs of one forward of a batch of the cell."""
    return sum(w.flops for w in forward_work(cfg, traffic))


def roofline_pct(works: List[Work], forwards: int,
                 device_s: float) -> Optional[float]:
    """Percent of the roofline: the least time ``forwards`` forwards of
    ``works`` could take, over the device seconds they took.  None
    where nothing ran."""
    if not works or forwards <= 0 or device_s <= 0:
        return None
    least = forwards * sum(w.min_seconds() for w in works)
    return 100.0 * least / device_s
