"""The count functions against counts made by hand."""
import json
from pathlib import Path

import pytest

from portbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_cnn8_dense_count_is_table_one():
    # Table I's layers as published, no grouping: 7,284,736 MACs an image
    cfg = _cfg("cnn8")
    per_image = sum(counts.dense_conv_flops(ly, 1) for ly in cfg["layers"])
    assert per_image == 2 * 7_284_736
    assert round(per_image / 1e6, 2) == 14.57
    # CNN8-3..7 at batch 8: 5,515,264 MACs an image
    assert sum(counts.dense_conv_flops(ly, 8)
               for ly in cfg["layers"][1:]) == 8 * 2 * 5_515_264
    assert round(8 * 2 * 5_515_264 / 1e6) == 88


def test_cnn8_grouped_count():
    # the pinned groups (4, 2, 4, 4, 4, 1), every channel kept:
    # 9*6*32*256 + 9*16*32*256 + 9*8*64*49 + 2 * 9*16*64*25 + 25*64*256
    macs = (442_368 + 1_179_648 + 225_792 + 2 * 230_400 + 409_600)
    cfg = _cfg("cnn8")
    assert counts.forward_flops(cfg, {"batch": 1}) == 2 * macs
    assert counts.forward_flops(cfg, {"batch": 8192}) == 8192 * 2 * macs


def test_conv_bytes_by_hand():
    layer = {"name": "L", "i_h": 6, "i_w": 5, "k_h": 3, "k_w": 2, "ic": 8,
             "oc": 4, "stride": 1}
    pin = {"group": 2, "tiles": [[2, 1], [1, 0]]}      # 3 of 4 kept a group
    w = counts.conv_work(layer, pin, batch=3)
    o_h, o_w = 4, 4
    assert w.flops == 2 * 3 * 4 * o_h * o_w * 3 * 2 * 3
    assert w.bytes == 4 * (3 * 6 * 6 * 5 + 3 * 2 * 3 * 4 + 3 * 4 * o_h * o_w)
    assert w.group == 2


def test_stablelm_block_counts():
    cfg = _cfg("stablelm-1.6b")
    work = counts.forward_work(cfg, {"batch": 1, "seq": 4096})
    assert len(work) == 24 * 5
    block = work[:5]
    assert [w.name for w in block] == ["blk0.qkv", "blk0.attention",
                                       "blk0.o", "blk0.w1", "blk0.w2"]
    proj = sum(w.flops for w in block if w.kind == "matmul")
    # G = 4: 2 * 4096 * (2048*6144 + 2048*2048 + 2048*5632 + 5632*2048) / 4
    assert proj == 2 * 4096 * (2048 * 6144 + 2048 * 2048
                               + 2 * 2048 * 5632) // 4
    assert round(proj / 1e9, 1) == 81.6
    attn = block[1]
    assert attn.flops == 4 * 32 * 64 * 4096 * 4097 // 2
    assert round(attn.flops / 1e9, 1) == 68.7
    assert attn.bytes == 4 * 4096 * 64 * (2 * 32 + 2 * 32)
    qkv = block[0]
    assert qkv.bytes == 4 * (4096 * 2048 + 512 * 6144 + 4096 * 6144)


def test_roofline_takes_the_larger_bound():
    compute = counts.Work("c", "matmul", flops=67e12, bytes=1.0)
    memory = counts.Work("m", "matmul", flops=1.0, bytes=3.35e12)
    assert compute.min_seconds() == pytest.approx(1.0)
    assert memory.min_seconds() == pytest.approx(1.0)
    assert counts.roofline_pct([compute, memory], 2, 8.0) == \
        pytest.approx(50.0)
    assert counts.roofline_pct([compute], 1, 0.0) is None
    assert counts.roofline_pct([], 1, 1.0) is None
