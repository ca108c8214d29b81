"""On the card, at sizes a test run holds: the timed path on the
configurations' published widths comes out correct, and the TF32
control and the planted faults in its place come out not correct, each
against the limit of the cell it stands for.  Marked ``cuda``; without a
CUDA device each test skips.

    python -m pytest -m cuda portbench/tests/test_cuda.py"""
import json
import time

import pytest
import torch

from portbench import calibrate, harness

from .conftest import ROOT, _copy, add_cell

SEED = 2 ** 31 + 777


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _config(config, **changes):
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      f"{config}.json").read_text())
    return dict(cfg, **changes)


@pytest.fixture
def small(tmp_path):
    """cnn8 at batch 256 and two stablelm-1.6b blocks at batch 1 x 512
    tokens, at published widths, each with its full cell's limit."""
    root = _copy(tmp_path)
    cells = {
        "cnn": add_cell(root, _config("cnn8", name="cnn8-small"),
                        {"traffic": "eval_b256", "unit": "images",
                         "batch": 256, "ring": 2, "samples": 2},
                        like="cnn8.eval_b8192"),
        "lm": add_cell(root, _config("stablelm-1.6b", name="stablelm-2blk",
                                     num_hidden_layers=2),
                       {"traffic": "prefill_s512_b1", "unit": "tokens",
                        "batch": 1, "seq": 512, "ring": 2, "samples": 2},
                       like="stablelm-1.6b.prefill_s512_b4"),
    }
    return root, cells


def _run(root, cell, device, wrap=None, trace=False):
    return harness.run_cell(harness.Bench.load(root), cell, SEED, 0.5,
                            trace, device, time.perf_counter(),
                            forward_wrap=wrap)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_sound_run_on_the_card(card, small, kind):
    root, cells = small
    r = _run(root, cells[kind], card, trace=True)
    assert r.correct, r.check.readings
    assert r.device["platform"] == "gpu" and r.device["busy_s"] > 0
    roofline = "sdk_conv_roofline" if kind == "cnn" else \
        "grouped_matmul_roofline"
    assert 0 < r.metrics[roofline]["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_tf32_control_on_the_card_is_not_correct(card, small, kind):
    root, cells = small
    control = calibrate.control(harness.Bench.load(root), cells[kind], SEED,
                                card)
    r = _run(root, cells[kind], card, wrap=control)
    assert not r.correct and r.check.value > 3 * r.limit


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_faults_on_the_card_are_not_correct(card, small, fault):
    root, cells = small
    r = _run(root, cells["cnn"], card, wrap=calibrate.FAULTS[fault])
    assert not r.correct
