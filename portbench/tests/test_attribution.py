"""The attribution of a traced window's device work to the program's
spans, on a hand-made trace; and on the card (marker ``cuda``), a short
stablelm-shaped forward whose device time the spans claim."""
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import attribution, trace

OFF_S = 5.0                     # host clock = trace clock / 1e6 - OFF_S


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _host_spans():
    out = []
    for b0 in (0.0, 0.010):
        out += [("ring", b0 + 0.000, b0 + 0.001),
                ("dispatch", b0 + 0.001, b0 + 0.004),
                ("synchronize", b0 + 0.004, b0 + 0.009)]
    return [(n, a - OFF_S, b - OFF_S) for n, a, b in out]


def _span(id, parent, forward, kind, name, executor, a_us, b_us):
    """A program span at trace-clock microseconds [a_us, b_us]."""
    ns = lambda us: None if us is None else int((us - OFF_S * 1e6) * 1e3)
    return SimpleNamespace(id=id, parent=parent, forward=forward, kind=kind,
                           name=name, executor=executor, start=ns(a_us),
                           end=ns(b_us))


def _program_spans():
    return [
        _span(1, None, 1, "forward", "lm", None, 1000, 3900),
        _span(2, 1, 1, "layer", "blk0.qkv", "matmul", 1100, 2500),
        _span(3, 2, 1, "glue", "fit", "matmul", 1100, 1200),
        _span(4, 2, 1, "exec", "matmul", "matmul", 1200, 2000),
        _span(5, 4, 1, "kernel", "grouped_matmul_f32", "matmul", 1500, 1700),
        _span(6, 2, 1, "attention", "attention", "matmul", 2000, 2500),
        _span(7, 1, 1, "layer", "blk0.o", "matmul", 2500, 3800),
        _span(8, 7, 1, "exec", "matmul", "matmul", 2500, 3000),
        _span(9, 7, 1, "glue", "carry", "matmul", 3000, 3800),
        _span(10, None, 2, "forward", "cnn", None, 11000, 13000),
        _span(11, 10, 2, "layer", "CNN8-3", "sdk", 11000, 13000),
        _span(12, 11, 2, "exec", "sdk", "sdk", 11100, 12900),
        _span(13, 12, 2, "kernel", "sdk_conv_window", "sdk", 11400, 11600),
        # cut short by an exception: a launch in it goes to its layer
        _span(14, 11, 2, "glue", "act", "sdk", 12950, None),
    ]


def _events():
    rt = "cuda_runtime"
    return [
        _ev(rt, "cudaLaunchKernel", 1300, 10, 1),
        _ev(rt, "cudaLaunchKernel", 1600, 10, 2),
        _ev(rt, "cudaLaunchKernel", 2200, 10, 3),
        _ev(rt, "cudaLaunchKernel", 3500, 10, 4),
        _ev(rt, "cudaMemsetAsync", 500, 10, 5),
        _ev(rt, "cudaMemsetAsync", 11200, 10, 6),
        _ev(rt, "cudaLaunchKernel", 11500, 10, 7),
        _ev(rt, "cudaLaunchKernel", 12960, 10, 8),
        _ev("kernel", "void at::native::elementwise_kernel<128, 2>(int)",
            2000, 500, 1),
        _ev("kernel", "void gemm_f32_kernel<128>(float)", 2500, 1500, 2),
        _ev("kernel", "void at::native::direct_copy(float)", 4000, 500, 3),
        _ev("kernel", "void at::native::add_kernel(float)", 4500, 500, 4),
        _ev("gpu_memset", "Memset (Device)", 600, 200, 5),
        _ev("gpu_memset", "Memset (Device)", 13000, 1000, 6),
        _ev("kernel", "void sdk_window_kernel(float)", 14000, 4000, 7),
        _ev("kernel", "void at::native::relu(float)", 18000, 400, 8),
        _ev("kernel", "void at::native::fill(float)", 18400, 100),
        _ev(rt, "cudaDeviceSynchronize", 4000, 5000),
        _ev(rt, "cudaDeviceSynchronize", 14000, 5000),
    ]


@pytest.fixture
def att():
    return attribution.attribute(_events(), _host_spans(), _program_spans())


def test_each_launch_goes_to_its_innermost_span(att):
    ms = {k: round(s * 1e3, 9) for k, s in att.by_stage.items()}
    assert ms == {("matmul", "exec", False): 0.5,
                  ("matmul", "exec", True): 1.5,   # launched in a kernel span
                  ("matmul", "attention", False): 0.5,
                  ("matmul", "glue", False): 0.5,
                  ("sdk", "exec", False): 1.0,
                  ("sdk", "exec", True): 4.0,
                  # launched in a span an exception cut: its layer's
                  ("sdk", "layer", False): 0.4}
    assert {k: round(s * 1e3, 9) for k, s in att.by_layer.items()} == {
        "blk0.qkv": 2.5, "blk0.o": 0.5, "CNN8-3": 5.4}
    assert {k: round(s * 1e3, 9) for k, s in att.by_glue.items()} == {
        "carry": 0.5}


def test_the_unclaimed_share(att):
    # the memset launched in the ring and the fill with no correlation:
    # 0.3 of 8.7 ms
    assert att.device_s == pytest.approx(0.0087)
    assert att.unclaimed_s == pytest.approx(0.0003)
    assert att.claimed_pct == pytest.approx(100 * 8.4 / 8.7)


def test_sums_reconcile_with_the_other_device_time(att):
    other = att.summary.by_kernel["other"]
    claimed_other = sum(s for (_, _, hw), s in att.by_stage.items()
                        if not hw)
    assert claimed_other + att.unclaimed_s == pytest.approx(other)
    m = attribution.metrics(att, "tokens")
    assert m == pytest.approx({"glue_ms.tokens": 0.25,
                               "launch_host_ms.tokens": 0.2,
                               "layout_ms.tokens": 0.5})
    m = attribution.metrics(att, "images")
    assert m == pytest.approx({"glue_ms.images": 0.25,
                               "launch_host_ms.images": 0.2,
                               "reference_exec_ms.images": 0.0,
                               "sdk_staging_ms.images": 0.5})
    assert att.launches == 2


def test_gap_labels_name_where_the_host_was(att):
    base = trace.summarize(_events(), _host_spans())
    assert [g for _, g in att.gaps] == [g for _, g in base.gaps]
    labels = [n for n, _ in att.gaps]
    assert [n.split("/")[0] for n in labels] == [n for n, _ in base.gaps]
    # [0, 0.6] ms: the ring, outside every program span; [0.8, 2.0]:
    # dispatch, mostly in blk0.qkv's executor call (its kernel launch
    # holds 0.2 of its 0.8 ms); [5, 13] and [18.5, 19]: waiting on the
    # device, the host mostly outside the program
    assert labels == ["ring", "dispatch/blk0.qkv/exec", "synchronize",
                      "synchronize"]
    tree = attribution._Tree(_program_spans(), OFF_S * 1e6)
    assert tree.label(12900, 13000) == "CNN8-3/layer"
    assert tree.label(3850, 3900) == "forward"
    assert tree.label(1520, 1680) == "blk0.qkv/kernel.grouped_matmul_f32"
    assert tree.label(0, 500) is None


def test_existing_fields_unchanged_without_program_spans():
    base = trace.summarize(_events(), _host_spans())
    att = attribution.attribute(_events(), _host_spans(), [])
    assert att.summary == base
    assert att.gaps == base.gaps
    assert att.by_stage == {} and att.unclaimed_s == att.device_s
    assert att.summary.breakdown() == base.breakdown()


def test_clock_fit_residual():
    assert attribution.clock_fit(_events(), _host_spans()) == \
        pytest.approx(0.0)
    events = _events()
    events[-1] = _ev("cuda_runtime", "cudaDeviceSynchronize", 14000, 5003)
    assert attribution.clock_fit(events, _host_spans()) == pytest.approx(3.0)
    assert attribution.clock_fit([], _host_spans()) is None


def test_launch_calls_place_the_spans_finer_than_the_syncs(att):
    """Synchronisation ends 150 us late would place every span 150 us
    late: the hand-written kernels' launch calls pull the spans back
    inside their kernel spans, and the attribution reads as before."""
    assert att.launch_fit_pct == 100.0 and -90 <= att.clock_shift_us <= 100
    late = [dict(e, dur=e["dur"] + 150) if e["name"] == trace.SYNC else e
            for e in _events()]
    moved = attribution.attribute(late, _host_spans(), _program_spans())
    assert moved.launch_fit_pct == 100.0
    assert -240 <= moved.clock_shift_us <= -50
    assert moved.by_stage == pytest.approx(att.by_stage)
    assert moved.by_layer == pytest.approx(att.by_layer)
    assert attribution.launch_fit(_events(), [], 0.0) == (0.0, None)


def test_report_is_per_forward(att):
    r = att.report()
    assert r["launches_per_forward"] == 1.0
    assert r["top_layers_ms"][0] == ["CNN8-3", pytest.approx(2.7)]
    assert r["stage_ms"][0] == ["sdk", "exec", True, pytest.approx(2.0)]
    assert r["idle_gaps"][0][0] == "synchronize"
    assert r["idle_ms_by_stage"] == pytest.approx(
        {"synchronize": 4.25, "exec": 0.6, "ring": 0.3})


@pytest.mark.cuda
def test_the_spans_claim_a_forward_on_the_card(tmp_path):
    """Two stablelm-1.6b blocks at published widths, 1 x 512 tokens:
    every launch in the traced window falls inside a program span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from .conftest import _copy, add_cell
    from .test_cuda import SEED, _config
    root = _copy(tmp_path)
    cell = add_cell(root, _config("stablelm-1.6b", name="stablelm-2blk",
                                  num_hidden_layers=2),
                    {"traffic": "prefill_s512_b1", "unit": "tokens",
                     "batch": 1, "seq": 512, "ring": 2, "samples": 2},
                    like="stablelm-1.6b.prefill_s512_b4")
    card = torch.device("cuda", 0)
    with torch.no_grad():
        forward, ring, _ = attribution.setup(root, cell, SEED, card)
        t = time.perf_counter()
        att = attribution.attribute(*attribution.traced(forward, ring, card,
                                                        0.5))
    assert time.perf_counter() - t < 120
    assert att.claimed_pct >= 99.0, att.report()
    assert att.launches == 10 * att.summary.forwards
    m = attribution.metrics(att, "tokens")
    other = 1e3 * att.summary.by_kernel["other"] / att.summary.forwards
    assert m["layout_ms.tokens"] + m["glue_ms.tokens"] == \
        pytest.approx(other, rel=0.03)
    assert m["layout_ms.tokens"] > 0 and m["launch_host_ms.tokens"] > 0
