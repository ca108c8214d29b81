"""The trace reduction on a hand-made trace."""
import pytest

from portbench import trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _spans(off_s):
    # two batches; host clock = trace clock (us) / 1e6 - off_s
    out = []
    for b0 in (0.0, 0.010):
        out += [("ring", b0 + 0.000, b0 + 0.001),
                ("dispatch", b0 + 0.001, b0 + 0.004),
                ("synchronize", b0 + 0.004, b0 + 0.009)]
    return [(n, a - off_s, b - off_s) for n, a, b in out]


def test_busy_gaps_and_kernels():
    events = [
        _ev("kernel",
            "void (anonymous namespace)::gemm_f32_kernel<128>(float)",
            2000, 3000),
        _ev("kernel", "void at::native::add_kernel(float)", 4000, 2000),
        _ev("gpu_memset", "Memset", 12000, 1000),
        _ev("kernel", "void sdk_window_kernel(float)", 13000, 5000),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 4000, 5000),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 14000, 5000),
        # the profiler's own synchronisation after the last batch
        _ev("cuda_runtime", "cudaDeviceSynchronize", 25000, 100),
        _ev("gpu_user_annotation", "x", 0, 50000),
    ]
    s = trace.summarize(events, _spans(5.0))
    assert s.forwards == 2
    assert s.window_s == pytest.approx(0.019)
    # device: [2, 6] ms and [12, 18] ms
    assert s.busy_s == pytest.approx(0.010)
    assert s.by_kernel["gemm"] == pytest.approx(0.003)
    assert s.by_kernel["sdk_window"] == pytest.approx(0.005)
    assert s.by_kernel["other"] == pytest.approx(0.003)
    gaps = dict((round(g * 1e3, 6), n) for n, g in s.gaps)
    # [0, 2] ms: ring 0-1, dispatch 1-2 -> tie goes to the first;
    # [6, 12]: synchronize 6-9, ring 10-11, dispatch 11-12
    assert sorted(gaps) == [1.0, 2.0, 6.0]
    assert gaps[6.0] == "synchronize"
    bd = s.breakdown()
    assert bd["device_ops"][0] == ["sdk_window_kernel", pytest.approx(0.005)]
    assert ["gemm_f32_kernel<128>", pytest.approx(0.003)] in bd["device_ops"]


def test_alignment_without_synchronisations():
    events = [_ev("kernel", "k", 1001000, 1000)]
    s = trace.summarize(events, [("ring", 0.0, 0.0005),
                                 ("dispatch", 0.0005, 0.001),
                                 ("synchronize", 0.001, 0.003)])
    assert s.busy_s == pytest.approx(0.001)
    assert s.window_s == pytest.approx(0.003)


def test_short_names():
    assert trace.short("void (anonymous namespace)::flash_attention_kernel"
                       "<float, 64>(float const*, int)") == \
        "flash_attention_kernel<float, 64>"
    assert len(trace.short("x" * 300)) == 96
