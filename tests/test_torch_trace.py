"""The port's span recorder (repro_torch.tracing) on smoke-size plans on
the CPU: cnn8 on the reference and sdk executors, and a 2-block
stablelm lowering on the matmul executor.  One forward span a call,
layer spans in plan order with their executors, stages nested under
their layer, nothing recorded or allocated while off, the same output
bit for bit either way, and each thread's spans kept apart.  The
kernel-launch spans need the card (marker ``cuda``)."""
import os
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing                                 # noqa: E402
from repro_torch.core import ArrayConfig, map_net, networks     # noqa: E402
from repro_torch.exec import (compile_plan, execute_oracle,     # noqa: E402
                              execute_plan)
from repro_torch.launch import transformer as tf                # noqa: E402

STAGES = ("exec", "attention", "glue")


def _case(kind, device="cpu"):
    """(plan, kernels, input, activation) of a smoke case."""
    gen = torch.Generator().manual_seed(31)
    if kind == "cnn":
        net = map_net("cnn8", networks.cnn8(), ArrayConfig(512, 512),
                      "TetrisG-SDK", groups=(1, 2, 4))
        plan = compile_plan(net, executor_policy=["reference"] + ["sdk"] * 5,
                            batch=2, device=device)
        act = torch.relu
    else:
        net = tf.transformer_mapping("stablelm_smoke", seq=16, blocks=2,
                                     array=ArrayConfig(64, 64))
        plan = compile_plan(net, executor_policy="matmul", batch=2,
                            device=device)
        act = None
    ks = [torch.randn(m.layer.k_h, m.layer.k_w, m.layer.ic // m.group,
                      m.layer.oc, generator=gen).mul_(0.1).to(device)
          for m in net.layers]
    first = net.layers[0].layer
    x = torch.randn(2, first.ic, first.i_h, first.i_w, generator=gen)
    return plan, ks, x.to(device), act


@pytest.fixture(scope="module", params=["cnn", "lm"])
def case(request):
    return request.param, _case(request.param)


def _recorded(fn):
    with tracing.recording() as rec:
        out = fn()
    return out, rec.drain()


def _forward(case):
    plan, ks, x, act = case[1]
    return lambda: execute_plan(plan, ks, x, activation=act)


def test_one_forward_span_per_call_and_layers_in_plan_order(case):
    plan = case[1][0]
    fwd = _forward(case)
    _, spans = _recorded(lambda: (fwd(), fwd()))
    forwards = [s for s in spans if s.kind == "forward"]
    assert len(forwards) == 2
    assert [f.parent for f in forwards] == [None, None]
    assert forwards[0].forward != forwards[1].forward
    assert all(f.name == plan.net.name for f in forwards)
    for f in forwards:
        layers = [s for s in spans if s.kind == "layer"
                  and s.forward == f.forward]
        assert [s.parent for s in layers] == [f.id] * len(plan.layers)
        assert [(s.name, s.executor) for s in layers] == [
            (lp.mapping.layer.name, lp.executor) for lp in plan.layers]
        assert all(f.start <= s.start <= s.end <= f.end for s in layers)
    assert {s.kind for s in spans} <= set(tracing.KINDS)
    assert not any(s.kind == "kernel" for s in spans)   # none on the CPU


def test_stages_nest_under_their_layer(case):
    kind, (plan, *_) = case
    _, spans = _recorded(_forward(case))
    by_id = {s.id: s for s in spans}
    (fwd,) = [s for s in spans if s.kind == "forward"]
    stages = [s for s in spans if s.kind in STAGES]
    assert all(s.forward == fwd.forward for s in spans)
    for s in stages:
        up = by_id[s.parent]
        assert up.kind == "layer" and up.executor == s.executor
        assert up.start <= s.start <= s.end <= up.end
    per_layer = {}
    for s in stages:
        per_layer.setdefault(by_id[s.parent].name, []).append(
            s.name if s.kind == "glue" else s.kind)
    want = {}
    for lp in plan.layers:
        g = lp.glue
        names = ["fit"] + (["layernorm"] if g.pre == "layernorm" else [])
        names.append("exec")
        if g.act != "none" or kind == "cnn":
            names.append("act")
        if g.post == "attention":
            names.append("attention")
        if g.kind in ("concat", "residual"):
            names.append("carry")
        want[lp.mapping.layer.name] = names
    assert per_layer == want
    execs = [s for s in stages if s.kind == "exec"]
    assert [s.name for s in execs] == list(plan.executors)
    if kind == "lm":
        assert sum(s.kind == "attention" for s in stages) == 2


def test_off_records_and_allocates_nothing(case):
    """While off, a forward leaves every store empty, and a thread that
    runs one gets no store at all: the sites return before touching
    anything."""
    stores = list(tracing._stores)
    t = threading.Thread(target=_forward(case))
    t.start()
    t.join()
    _forward(case)()
    assert tracing._stores == stores
    assert all(st.start == [] and st.open == [] for st in stores)
    assert tracing.begin("layer", "x") is None
    with tracing.recording() as rec:
        pass
    assert rec.drain() == []


def test_outputs_bitwise_equal_on_and_off(case):
    fwd = _forward(case)
    off = fwd()
    on, spans = _recorded(fwd)
    assert spans and torch.equal(on, off)


def test_threads_keep_their_own_trees():
    """Two threads inside one recording, their spans interleaved in
    time: each span's parent is a span of its own thread."""
    (plan, ks, x, _) = _case("lm")
    go = threading.Barrier(2)

    def worker(tag):
        go.wait()
        outer = tracing.begin("forward", tag)
        go.wait()                       # both open before either nests
        inner = tracing.begin("layer", tag)
        go.wait()
        tracing.end(inner)
        tracing.end(outer)
        execute_plan(plan, ks, x)

    with tracing.recording() as rec:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = rec.drain()
    by_id = {s.id: s for s in spans}
    for tag in ("a", "b"):
        (outer,) = [s for s in spans if s.kind == "forward" and s.name == tag]
        (inner,) = [s for s in spans if s.kind == "layer" and s.name == tag]
        assert inner.parent == outer.id and inner.forward == outer.forward
    forwards = [s for s in spans if s.kind == "forward"]
    assert len(forwards) == 4 and len({f.forward for f in forwards}) == 4
    for s in spans:
        if s.parent is not None:
            assert by_id[s.parent].forward == s.forward


def test_many_threads_under_a_short_switch_interval():
    """More threads than cores, switching every microsecond, each
    nesting spans three deep: every span's parent is its own thread's
    (named alike), ids are unique, and none is lost."""
    n_threads, reps = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()

    def worker(tag):
        for _ in range(reps):
            a = tracing.begin("forward", tag)
            b = tracing.begin("layer", tag)
            tracing.end(tracing.begin("kernel", tag))
            tracing.end(b)
            tracing.end(a)

    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            threads = [threading.Thread(target=worker, args=(str(i),))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = rec.drain()
    assert len(spans) == 3 * reps * n_threads
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.kind == "forward":
            assert s.parent is None
        else:
            up = by_id[s.parent]
            assert up.name == s.name and up.forward == s.forward
            assert up.kind == ("forward" if s.kind == "layer" else "layer")
    assert len({s.forward for s in spans}) == reps * n_threads


def test_an_exception_closes_the_spans_it_cut():
    """A forward that raises inside a layer leaves no open span behind:
    the next forward's spans start from an empty stack."""
    plan, ks, x, act = _case("lm")
    bad = list(ks)
    bad[1] = bad[1][..., :-1]          # the o projection's kernel, cut
    with tracing.recording() as rec:
        with pytest.raises(ValueError):
            execute_plan(plan, bad, x)
        execute_plan(plan, ks, x)
    spans = rec.drain()
    forwards = [s for s in spans if s.kind == "forward"]
    assert len(forwards) == 2 and forwards[1].parent is None
    cut = [s for s in spans if s.end is None]
    assert cut and all(s.forward == forwards[0].forward for s in cut)
    assert tracing._store().open == []


def test_recording_is_not_reentrant_and_drain_empties():
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
        tracing.end(tracing.begin("glue", "fit"))
    assert [s.name for s in rec.drain()] == ["fit"]
    assert rec.drain() == []
    assert tracing.begin("glue", "fit") is None


def test_the_oracle_forward_is_a_forward_too():
    plan, ks, x, _ = _case("lm")
    _, spans = _recorded(lambda: execute_oracle(plan, ks, x))
    assert [s.kind for s in spans].count("forward") == 1
    assert sum(s.kind == "layer" for s in spans) == len(plan.layers)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_kernel_spans_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, ks, x, act = _case(kind, "cuda")
    with torch.no_grad():
        execute_plan(plan, ks, x, activation=act)     # builds the kernels
        torch.cuda.synchronize()
        y, spans = _recorded(lambda: execute_plan(plan, ks, x,
                                                  activation=act))
        assert torch.equal(y, execute_plan(plan, ks, x, activation=act))
    by_id = {s.id: s for s in spans}
    kernels = [s for s in spans if s.kind == "kernel"]
    assert kernels
    for s in kernels:
        assert by_id[s.parent].kind in ("exec", "attention")
    names = {s.name for s in kernels}
    if kind == "lm":
        assert "flash_attention_fwd" in names and names <= {
            "grouped_matmul_f32", "tetris_matmul_f32", "flash_attention_fwd"}
        assert len(kernels) == 2 * 5
    else:
        assert names <= {"sdk_conv_window", "sdk_conv_whole"}
        assert all(by_id[s.parent].executor == "sdk" for s in kernels)
