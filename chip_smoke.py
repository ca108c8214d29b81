#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build — ``nvcc`` builds every kernel source of ``src/repro_torch/csrc``
   into ``build/kernels/``;
3. kernels vs plain — both sdk kernels against ``sdk_conv_plain`` on the
   card, on every sdk layer of cnn8, DN40-b2l3, Incep-3b and a stride-2
   layer at batch 8, with launched steps held to ``mapping.cycles``;
4. main path — ``repro_torch.launch.serve_cnn.main`` serves cnn8 with the
   ``auto`` policy; the plan must be reference + five sdk layers, the
   whole kernel's launch count must grow by (warmup + steps) x its
   launches per forward, and a forward must match ``execute_oracle``;
5. window path — the cnn8 forward with ``block="window"`` and the
   densenet40 forward (policy auto) against ``execute_oracle``;
6. sdk times at the main path's shapes;
7. transformer kernels vs plain — tetris_matmul, grouped_matmul and
   flash_attention against their plain versions at the shapes of the
   transformer path and at ragged tails, causal or not, with a
   ``q_offset`` and a GQA case; the attention stage at lengths that do
   not tile by 128 (whisper's 1500-frame window, 136) must launch the
   kernel once and match its plain form;
8. transformer path — ``serve`` (policy auto) of stablelm-1.6b (24
   blocks, seq 512, batch 4) and of the whisper-base encoder (6 blocks,
   seq 1024, batch 4) at full width, each with every launch count set to
   0 just before and read just after: every layer must run on
   ``matmul``, the kernels' launches must equal the forwards times their
   launches per forward, and a forward must match ``execute_oracle``
   (plain functions only); one forward under ``torch.profiler`` gives
   its device time beside the serving loop's wall time;
9. transformer kernel times: device time with the stream held, per-call
   time, the plain version's, the bound and the library call's
   (``torch.matmul``, ``torch.bmm``, ``F.scaled_dot_product_attention``,
   timed as yardsticks only);
10. a ``{"kernels": [...]}`` line: per kernel its launches, error, time
    at its path's shapes, the plain version's time, the least time the
    card could take (its bound) and the library call's time;

then the card line and, last, ``{"ok": true, "device": {...}}``.  The
script needs the checkout beside it (``src/``) and a CUDA device.
Matmuls and convolutions run in full f32: TF32 is switched off for
cuBLAS and cuDNN (``allow_tf32 = False``), for the library yardsticks
too.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BATCH = 8
SEED = 0
WARMUP, STEPS = 2, 20
#: f32 kernel vs plain version: the same products summed in another
#: order (per element k_h*k_w*ic_t terms), relative to max|y|.
KERNEL_RTOL = 1e-5
#: a whole forward vs the F.conv2d oracle: six chained layers, each
#: summed in another order than cuDNN's, relative to max|y|.
FORWARD_RTOL = 1e-4
#: H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
WHOLE_SITE = "src/repro/kernels/im2win_conv.py:380"
WINDOW_SITE = "src/repro/kernels/im2win_conv.py:354"
TETRIS_SITE = "src/repro/kernels/tetris_matmul.py:105"
GROUPED_SITE = "src/repro/kernels/grouped_matmul.py:40"
FLASH_SITE = "src/repro/kernels/flash_attention.py:86"
#: the transformer path: (config, seq, batch), full width and depth
TRANSFORMERS = (("stablelm_1_6b", 512, 4), ("whisper_base", 1024, 4))
TF_WARMUP, TF_STEPS = 1, 20
#: ragged attention-stage lengths per model: whisper's real 30 s window
#: (1500 frames) and a length just past one 128 block
RAGGED_SEQ = {"whisper_base": 1500, "stablelm_1_6b": 136}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, iters: int, warmup: int = 3) -> float:
    """Time of one ``fn()`` call as a caller sees it: CUDA events around
    ``iters`` back-to-back calls after ``warmup`` untimed ones.  Where
    the host enqueues slower than the card runs, this is host time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time of one ``fn()`` call: a spin kernel holds the stream
    while the host enqueues ``iters`` calls between two events, so the
    card runs them back to back and host launch gaps are not counted.
    The hold is checked: the start event must still be pending when the
    host has enqueued everything (``iters`` calls must stay below the
    launch queue's depth)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    hold_s = 2 * (time.perf_counter() - t0)
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_s * 2.0e9))    # cycles, clock <= 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        hold_s *= 2
    raise RuntimeError("could not hold the stream while enqueuing")


def layer_data(mapping, rng, device):
    """Seeded f32 input and grouped HWIO kernel of one layer, pruned
    channels zeroed."""
    import types
    import torch
    from repro_torch.cnn.mapped_net import zero_pruned_kernels
    lay = mapping.layer
    x = torch.as_tensor(rng.randn(BATCH, lay.ic, lay.i_h, lay.i_w)
                        .astype("float32"), device=device)
    k = torch.as_tensor((rng.randn(lay.k_h, lay.k_w, lay.ic // mapping.group,
                                   lay.oc) * 0.1).astype("float32"),
                        device=device)
    one = types.SimpleNamespace(layers=(mapping,))
    return x, zero_pruned_kernels(one, [k])[0]


def conv_bound_ms(mapping) -> tuple:
    """(ms, "bytes" | "operations"): the least time an H100 could take
    for one sdk layer at BATCH — its kept-channel f32 multiply-adds at
    the f32 peak, or its input, kernel and output bytes, once each, at
    the memory rate, whichever is larger."""
    lay = mapping.layer
    kept = sum(t.depth for t in mapping.tiles)            # per group
    flops = 2 * BATCH * lay.oc * lay.o_h * lay.o_w * kept * lay.k_h * lay.k_w
    nbytes = 4 * (BATCH * lay.ic * lay.i_h * lay.i_w
                  + lay.k_h * lay.k_w * (lay.ic // mapping.group) * lay.oc
                  + BATCH * lay.oc * lay.o_h * lay.o_w)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def max_err(y, ref) -> tuple:
    scale = float(ref.abs().max())
    err = float((y - ref).abs().max())
    return err, err / max(scale, 1e-30), scale


def randn(rng, shape, device, scale=1.0):
    import torch
    return torch.as_tensor((rng.randn(*shape) * scale).astype("float32"),
                           device=device)


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(ms, "bytes" | "operations"): f32 FLOPs at the f32 peak or bytes
    at the memory rate, whichever takes longer."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_work(bh, sq, sk, d, causal, q_offset=0) -> tuple:
    """(FLOPs, bytes) attention needs: 4*D FLOPs per visible (query, key)
    pair — the causal mask hides the rest — and q, k, v, out once."""
    if causal:
        pairs = sum(min(sk, q_offset + i + 1) for i in range(sq))
    else:
        pairs = sq * sk
    return 4.0 * d * pairs * bh, 4.0 * bh * d * (2 * sq + 2 * sk)


def block_shapes(plan, batch: int):
    """(G, M, D, F) of each matmul launch of the plan's first block (its
    four layers), M = batch * seq tokens."""
    out = []
    for lp in plan.layers[:4]:
        m = lp.mapping
        out.append((m.group, batch * m.layer.i_h, m.layer.ic // m.group,
                    m.layer.oc // m.group))
    return out


def check(label: str, y, ref) -> float:
    """Print and enforce kernel vs plain within KERNEL_RTOL of max|y|;
    returns the max abs error."""
    import torch
    torch.cuda.synchronize()
    err, rel, scale = max_err(y, ref)
    ok = (y.shape == ref.shape and bool(torch.isfinite(y).all())
          and rel <= KERNEL_RTOL)
    print(f"[kernel] {label}: max_abs_err={err:.3e} rel={rel:.3e} (tol "
          f"{KERNEL_RTOL:g} of max|y|={scale:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version")
    return err


def transformer_kernel_checks(shapes, dev) -> dict:
    """Phase 7: each transformer kernel against its plain version at the
    path's shapes and at ragged tails; returns each kernel's max error."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import tetris_matmul as tm
    rng = np.random.RandomState(SEED)
    errs = {"tetris_matmul": 0.0, "grouped_matmul": 0.0,
            "flash_attention": 0.0}
    mnk = [(m, f, d) for g, m, d, f in shapes["whisper_base"]]
    for m, n, k in mnk + [(1000, 1000, 96), (130, 520, 72)]:
        x, w = randn(rng, (m, k), dev), randn(rng, (k, n), dev)
        e = check(f"tetris_matmul (M,N,K)=({m},{n},{k})",
                  tm.tetris_matmul_cuda(x, w), tm.matmul_ref(x, w))
        errs["tetris_matmul"] = max(errs["tetris_matmul"], e)
    for g, m, d, f in shapes["stablelm_1_6b"] + [(3, 100, 40, 72)]:
        x = randn(rng, (g, m, d), dev)
        # the executor's group-major view of a (D, G*F) kernel
        w = randn(rng, (d, g * f), dev).reshape(d, g, f).transpose(0, 1)
        e = check(f"grouped_matmul (G,M,D,F)=({g},{m},{d},{f})",
                  gm.grouped_matmul_cuda(x, w), gm.grouped_matmul_ref(x, w))
        errs["grouped_matmul"] = max(errs["grouped_matmul"], e)
    cases = [(bh, s, s, hd, c, 0) for bh, s, hd, _ in shapes["attention"]
             for c in (True, False)] + [(8, 128, 384, 64, True, 256)]
    for bh, sq, sk, d, causal, q_off in cases:
        q = randn(rng, (bh, sq, d), dev)
        k, v = randn(rng, (bh, sk, d), dev), randn(rng, (bh, sk, d), dev)
        e = check(f"flash_attention BH={bh} Sq={sq} Sk={sk} D={d} "
                  f"causal={causal} q_offset={q_off}",
                  fa.flash_attention_cuda(q, k, v, causal=causal,
                                          q_offset=q_off),
                  fa.flash_attention_ref(q, k, v, causal=causal,
                                         q_offset=q_off))
        errs["flash_attention"] = max(errs["flash_attention"], e)
    q = randn(rng, (4, 256, 8, 64), dev)
    k, v = randn(rng, (4, 256, 2, 64), dev), randn(rng, (4, 256, 2, 64), dev)
    ref = fa.flash_attention_ref(*fa.fold_heads(q, k, v), causal=True)
    e = check("mha_flash GQA B=4 S=256 hq=8 hkv=2 D=64 causal",
              fa.mha_flash(q, k, v, causal=True),
              ref.reshape(4, 8, 256, 64).transpose(1, 2))
    errs["flash_attention"] = max(errs["flash_attention"], e)
    from repro_torch.exec import glue
    for arch, (batch, heads, causal) in shapes["stage"].items():
        hq, hkv, hd = heads
        m = RAGGED_SEQ[arch]
        y = randn(rng, (batch, (hq + 2 * hkv) * hd, m, 1), dev)
        before = fa.flash_attention_cuda.launches
        got = glue.attention_stage(y, heads, causal)
        torch.cuda.synchronize()
        n = fa.flash_attention_cuda.launches - before
        if n != 1:
            raise AssertionError(f"attention_stage at M={m}: {n} flash "
                                 f"launches, not 1")
        e = check(f"attention_stage {arch} B={batch} M={m} heads={heads} "
                  f"causal={causal} ({n} flash launch)", got,
                  glue.attention_stage(y, heads, causal, plain=True))
        errs["flash_attention"] = max(errs["flash_attention"], e)
    return errs


def reset_all_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import sdk_conv as sk
    from repro_torch.kernels import tetris_matmul as tm
    for mod in (sk, tm, gm, fa):
        mod.reset_counts()


def launch_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import tetris_matmul as tm
    return {"tetris_matmul": tm.tetris_matmul_cuda.launches,
            "grouped_matmul": gm.grouped_matmul_cuda.launches,
            "flash_attention": fa.flash_attention_cuda.launches}


def serve_transformer(net, inputs, batch: int, dev, card: str) -> dict:
    """Phase 8 for one model: serve it through the compiled plan with
    every count at 0 just before, hold the launches to the plan, and the
    forward to the plain-function oracle.  Returns the launches."""
    import torch
    from repro_torch.exec import execute_oracle, execute_plan
    from repro_torch.launch import serve_cnn
    name = net.name
    reset_all_counts()
    stats = serve_cnn.serve(net, batch, TF_STEPS, warmup=TF_WARMUP,
                            seed=SEED, policy="auto", device=dev,
                            inputs=inputs)
    launches = launch_counts()
    plan = stats.plan
    if set(plan.executors) != {"matmul"}:
        raise AssertionError(f"{name} plan executors {set(plan.executors)}")
    per_fwd = {
        "tetris_matmul": sum(lp.mapping.group == 1 for lp in plan.layers),
        "grouped_matmul": sum(lp.mapping.group > 1 for lp in plan.layers),
        "flash_attention": sum(lp.glue.post == "attention"
                               for lp in plan.layers)}
    forwards = TF_WARMUP + TF_STEPS
    print(f"[transformer] {name}: {len(plan.layers)} layers, executors "
          f"{'/'.join(sorted(set(plan.executors)))}, groups "
          f"{sorted(set(lp.mapping.group for lp in plan.layers))}; "
          f"launches over {forwards} forwards {launches} (per forward "
          f"{per_fwd})")
    for k, n in per_fwd.items():
        if launches[k] != forwards * n:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times"
                                 f" != {forwards} forwards x {n}")
    if launches["flash_attention"] == 0 or launches["tetris_matmul"] \
            + launches["grouped_matmul"] == 0:
        raise AssertionError(f"{name}: the serving path launched no "
                             f"matmul or no attention kernel")
    ks, xh = inputs
    xs = torch.as_tensor(xh, device=dev)
    y = execute_plan(plan, ks, xs)
    r = execute_oracle(plan, ks, xs)
    torch.cuda.synchronize()
    err, rel, scale = max_err(y, r)
    print(f"[transformer] {name}: forward vs oracle max_abs_err={err:.3e} "
          f"rel={rel:.3e} (tol {FORWARD_RTOL:g} of max|y|={scale:.3f})")
    first = plan.layers[0].mapping.layer
    if not (bool(torch.isfinite(y).all()) and rel <= FORWARD_RTOL
            and y.shape == (batch, first.ic, first.i_h, 1)):
        raise AssertionError(f"{name} forward disagrees with the oracle")
    print(f"[transformer] {name} batch {batch} seq {first.i_h}: "
          f"{stats.s_per_batch * 1e3:.4f} ms/batch, "
          f"{stats.tokens_per_s:.1f} tokens/s on {card}")
    profile_forward(name, plan, ks, xs, stats.s_per_batch)
    return launches


def profile_forward(name, plan, ks, xs, s_per_batch: float) -> None:
    """The device time of one forward, from ``torch.profiler``'s CUDA
    events (kernels, copies, fills), beside the serving loop's wall time
    per batch: their ratio is the device's busy share while serving.
    Prints the five largest device entries too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.exec import execute_plan
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        execute_plan(plan, ks, xs)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev)
    if total_us == 0:
        print(f"[profile] {name}: device time not measured (the profiler "
              f"recorded no device events)")
        return
    ms = total_us / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    print(f"[profile] {name}: one forward {ms:.4f} ms of device time in "
          f"{sum(e.count for e in dev)} device events, "
          f"{100 * ms / (s_per_batch * 1e3):.1f} % of the serving loop's "
          f"{s_per_batch * 1e3:.4f} ms/batch; largest: " + "; ".join(
              f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.4f}"
              f" ms" for e in top))


def time_transformer_kernels(shapes, dev, card: str) -> dict:
    """Phase 9: per kernel, summed over its path's launches of one block
    (flash: one launch of each model), the kernel's device time (stream
    held) and per-call time, the plain version's per-call time, the
    library call's device time and the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import tetris_matmul as tm
    rng = np.random.RandomState(SEED)
    keys = ("ms", "call_ms", "plain_ms", "library_ms", "flops", "bytes")
    totals = {k: dict.fromkeys(keys, 0.0) for k in
              ("tetris_matmul", "grouped_matmul", "flash_attention")}

    def add(kernel, label, run, plain, library, flops, nbytes):
        t = {"ms": device_ms(run, iters=20), "call_ms": call_ms(run, 20),
             "plain_ms": call_ms(plain, 5), "library_ms":
             device_ms(library, iters=20), "flops": flops, "bytes": nbytes}
        for k in keys:
            totals[kernel][k] += t[k]
        bound, by = bound_ms(flops, nbytes)
        print(f"[time] {kernel} {label}: device {t['ms']:.5f} ms, per call "
              f"{t['call_ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
              f"library {t['library_ms']:.5f} ms, bound {bound:.6f} ms "
              f"({by}); {flops / t['ms'] / 1e9:.3f} TFLOP/s kernel, "
              f"{flops / t['library_ms'] / 1e9:.3f} library on {card}")

    for g, m, d, f in shapes["whisper_base"]:
        x, w = randn(rng, (m, d), dev), randn(rng, (d, f), dev)
        add("tetris_matmul", f"(M,N,K)=({m},{f},{d})",
            lambda: tm.tetris_matmul_cuda(x, w), lambda: tm.matmul_ref(x, w),
            lambda: torch.matmul(x, w), 2.0 * m * f * d,
            4.0 * (m * d + d * f + m * f))
    for g, m, d, f in shapes["stablelm_1_6b"]:
        x = randn(rng, (g, m, d), dev)
        w = randn(rng, (d, g * f), dev).reshape(d, g, f).transpose(0, 1)
        add("grouped_matmul", f"(G,M,D,F)=({g},{m},{d},{f})",
            lambda: gm.grouped_matmul_cuda(x, w),
            lambda: gm.grouped_matmul_ref(x, w), lambda: torch.bmm(x, w),
            2.0 * g * m * d * f, 4.0 * g * (m * d + d * f + m * f))
    for bh, s, d, causal in shapes["attention"]:
        q = randn(rng, (bh, s, d), dev)
        k, v = randn(rng, (bh, s, d), dev), randn(rng, (bh, s, d), dev)
        add("flash_attention", f"BH={bh} S={s} D={d} causal={causal}",
            lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
            lambda: fa.flash_attention_ref(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal),
            *attention_work(bh, s, s, d, causal))
    for t in totals.values():
        t["bound_ms"], t["bound_by"] = bound_ms(t["flops"], t["bytes"])
    return totals


def transformer_phases(dev, card: str) -> list:
    """Phases 7-9; returns the three transformer kernels' rows of the
    kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.core import ArrayConfig
    from repro_torch.launch import serve_cnn
    from repro_torch.launch.transformer import transformer_mapping
    from repro_torch.exec import compile_plan
    nets, shapes = {}, {"attention": [], "stage": {}}
    for arch, seq, batch in TRANSFORMERS:
        t0 = time.perf_counter()
        net = transformer_mapping(get_config(arch), seq=seq,
                                  array=ArrayConfig(512, 512))
        nets[arch] = (net, batch)
        plan = compile_plan(net, executor_policy="auto", batch=batch,
                            device=dev)
        shapes[arch] = block_shapes(plan, batch)
        hq, hkv, hd = net.glue[0].heads
        shapes["attention"].append((batch * hq, seq, hd,
                                    net.glue[0].causal))
        shapes["stage"][arch] = (batch, net.glue[0].heads,
                                 net.glue[0].causal)
        print(f"[transformer] {arch}: mapped {len(net.layers)} layers "
              f"in {time.perf_counter() - t0:.3f} s; block launches "
              f"(G, M, D, F) {shapes[arch]}")
    errs = transformer_kernel_checks(shapes, dev)
    launches = dict.fromkeys(errs, 0)
    for arch, (net, batch) in nets.items():
        t0 = time.perf_counter()
        inputs = serve_cnn.serving_inputs(net, batch, SEED, dev)
        print(f"[transformer] {arch}: drew {len(inputs[0])} kernels and "
              f"the input in {time.perf_counter() - t0:.3f} s")
        for k, n in serve_transformer(net, inputs, batch, dev,
                                      card).items():
            launches[k] += n
        del inputs
    times = time_transformer_kernels(shapes, dev, card)
    paths = {
        "tetris_matmul": ("serve whisper-base encoder --policy auto",
                          "whisper-base block at batch 4, seq 1024: "
                          "qkv, o, w1, w2 launches, summed",
                          TETRIS_SITE, "src/repro_torch/csrc/matmul.cu"),
        "grouped_matmul": ("serve stablelm-1.6b --policy auto",
                           "stablelm-1.6b block at batch 4, seq 512 "
                           "(G=4): qkv, o, w1, w2 launches, summed",
                           GROUPED_SITE, "src/repro_torch/csrc/matmul.cu"),
        "flash_attention": ("serve stablelm-1.6b + whisper-base encoder "
                            "--policy auto",
                            "one stablelm-1.6b causal launch (BH=128, "
                            "S=512) + one whisper-base launch (BH=32, "
                            "S=1024), D=64, summed", FLASH_SITE,
                            "src/repro_torch/csrc/flash_attention.cu")}
    rows = []
    for name, (path, shape, site, source) in paths.items():
        t = times[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": site, "launches": launches[name], "path": path,
            "max_abs_err": errs[name], "ms": t["ms"],
            "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shapes": shape,
            "timing": "ms, library_ms: device time, stream held; call_ms, "
                      "plain_ms: per call incl. host"})
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    import numpy as np
    from repro_torch.core import ArrayConfig, ConvLayerSpec, map_layer
    from repro_torch.exec import compile_plan, execute_oracle, execute_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels import sdk_conv as sk
    from repro_torch.launch import serve_cnn

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. device --------------------------------------------------------
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    built = _build.build_all(sources)
    print(f"[build] {sources} -> {[p.name for p in built.values()]} in "
          f"{time.perf_counter() - t0:.3f} s")

    # -- 3. kernels vs plain, on the card ---------------------------------
    arr = ArrayConfig(512, 512)
    cnn8, _ = serve_cnn.map_for_serving("cnn8", arr, "TetrisG-SDK")
    dn40, _ = serve_cnn.map_for_serving("densenet40", arr, "TetrisG-SDK")
    incep, _ = serve_cnn.map_for_serving("inception", arr, "TetrisG-SDK")
    cnn8_sdk = [m for m, ex in zip(
        cnn8.layers, compile_plan(cnn8, device=dev).executors) if ex == "sdk"]
    strided = map_layer(ConvLayerSpec("s2", 11, 11, 3, 3, 16, 16, stride=2),
                        arr, "VW-SDK")
    cases = cnn8_sdk + [
        next(m for m in dn40.layers if m.layer.name == "DN40-b2l3"),
        next(m for m in incep.layers if m.layer.name == "Incep-3b"),
        strided]
    rng = np.random.RandomState(SEED)
    errors = {"whole": 0.0, "window": 0.0}
    for m in cases:
        if sk.sdk_conv_cycles(m) != m.cycles:
            raise AssertionError(f"{m.layer.name}: sdk_conv_cycles "
                                 f"{sk.sdk_conv_cycles(m)} != cycles "
                                 f"{m.cycles}")
        x, k = layer_data(m, rng, dev)
        ref = sk.sdk_conv_plain(m, x, k)
        torch.cuda.synchronize()
        for mode, fn in (("whole", sk.sdk_whole), ("window", sk.sdk_window)):
            sk.reset_counts()
            y = sk.sdk_conv(m, x, k, block=mode)
            torch.cuda.synchronize()
            err, rel, scale = max_err(y, ref)
            ok = rel <= KERNEL_RTOL and fn.steps == m.cycles
            print(f"[kernel] {m.layer.name:10s} {mode:6s} tiles="
                  f"{len(m.tiles)} G={m.group} launches={fn.launches} "
                  f"steps={fn.steps} cycles={m.cycles} max_abs_err={err:.3e}"
                  f" rel={rel:.3e} (tol {KERNEL_RTOL:g} of max|y|={scale:.3f})"
                  f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{m.layer.name} {mode}: kernel vs "
                                     f"plain or steps vs cycles failed")
            errors[mode] = max(errors[mode], err)

    # -- 4. main path: serve cnn8 through the compiled plan ----------------
    sk.reset_counts()
    stats = serve_cnn.main(["--net", "cnn8", "--policy", "auto", "--batch",
                            str(BATCH), "--steps", str(STEPS), "--warmup",
                            str(WARMUP), "--seed", str(SEED)])
    main_launches = {"whole": sk.sdk_whole.launches,
                     "window": sk.sdk_window.launches}
    plan = stats.plan
    if plan.executors != ("reference", "sdk", "sdk", "sdk", "sdk", "sdk"):
        raise AssertionError(f"cnn8 plan executors {plan.executors}")
    per_fwd = {"whole": 0, "window": 0}
    for lp in plan.layers:
        if lp.executor == "sdk":
            m = lp.mapping
            for t in m.tiles:
                mode = sk.resolve_block(lp.block, BATCH, sk.tile_geom(m, t),
                                        m.layer, lp.vmem_budget)
                per_fwd[mode] += m.group
    forwards = WARMUP + STEPS
    for mode in per_fwd:
        if main_launches[mode] != forwards * per_fwd[mode]:
            raise AssertionError(
                f"{mode} kernel: {main_launches[mode]} launches on the "
                f"serving path != {forwards} forwards x {per_fwd[mode]}")
    if main_launches["whole"] == 0:
        raise AssertionError("the serving path never launched the whole "
                             "kernel")
    ks, xh = serve_cnn.serving_inputs(cnn8, BATCH, SEED, dev)
    xs = torch.as_tensor(xh, device=dev)
    y = execute_plan(plan, ks, xs)
    r = execute_oracle(plan, ks, xs)
    torch.cuda.synchronize()
    err, rel, scale = max_err(y, r)
    print(f"[main] plan={plan.executors} launches whole="
          f"{main_launches['whole']} window={main_launches['window']} over "
          f"{forwards} forwards (per forward whole={per_fwd['whole']} "
          f"window={per_fwd['window']}); forward vs oracle max_abs_err="
          f"{err:.3e} rel={rel:.3e} (tol {FORWARD_RTOL:g} of "
          f"max|y|={scale:.3f})")
    if not (torch.isfinite(y).all() and rel <= FORWARD_RTOL
            and y.shape == (BATCH, 256, 1, 1)):
        raise AssertionError("cnn8 forward disagrees with the oracle")
    print(f"[main] cnn8 batch {BATCH}: {stats.images_per_s:.1f} images/s, "
          f"{stats.s_per_batch * 1e3:.4f} ms/batch on {card}")

    # -- 5. window path -----------------------------------------------------
    sk.reset_counts()
    nets = (("cnn8", cnn8, "window"), ("densenet40", dn40, "auto"))
    outs = []
    for name, net, block in nets:
        p = compile_plan(net, executor_policy="auto", batch=BATCH,
                         device=dev, block=block)
        ks, xh = serve_cnn.serving_inputs(net, BATCH, SEED, dev)
        xs = torch.as_tensor(xh, device=dev)
        outs.append((name, block, p, execute_plan(p, ks, xs), ks, xs))
    torch.cuda.synchronize()
    win_launches = {"whole": sk.sdk_whole.launches,
                    "window": sk.sdk_window.launches}
    for name, block, p, y, ks, xs in outs:
        r = execute_oracle(p, ks, xs)
        err, rel, scale = max_err(y, r)
        print(f"[window] {name} block={block} executors="
              f"{'/'.join(sorted(set(p.executors)))} forward vs oracle "
              f"max_abs_err={err:.3e} rel={rel:.3e} (tol {FORWARD_RTOL:g} "
              f"of max|y|={scale:.3f})")
        if not (torch.isfinite(y).all() and rel <= FORWARD_RTOL):
            raise AssertionError(f"{name} block={block} forward disagrees "
                                 f"with the oracle")
    print(f"[window] launches whole={win_launches['whole']} "
          f"window={win_launches['window']}")
    if win_launches["window"] == 0:
        raise AssertionError("the window path never launched the window "
                             "kernel")

    # -- 6. times at the main path's shapes --------------------------------
    rows = []
    layers = [lp.mapping for lp in plan.layers if lp.executor == "sdk"]
    keys = ("whole", "window", "whole_call", "window_call", "plain",
            "library", "bound")
    totals = dict.fromkeys(keys, 0.0)
    bound_by = {}
    rng = np.random.RandomState(SEED)
    for m in layers:
        x, k = layer_data(m, rng, dev)
        t = {}
        for mode, fn in (("whole", sk.sdk_whole), ("window", sk.sdk_window)):
            cs = sk.tile_calls(m, x, k, block=mode)
            run = (lambda fn=fn, cs=cs: [fn(c.xt, c.kt, c.geom) for c in cs])
            # two kernels (zero fill, sdk) per tile call
            t[mode] = device_ms(run, iters=max(4, 400 // (2 * len(cs))))
            t[mode + "_call"] = call_ms(run, iters=200)
        cs = sk.tile_calls(m, x, k)
        t["plain"] = call_ms(lambda cs=cs: [
            sk.tile_plain(c.xt, c.kt, c.geom, c.mode) for c in cs], iters=20)
        w_oihw = k.permute(3, 2, 0, 1).contiguous()
        t["library"] = device_ms(lambda: torch.nn.functional.conv2d(
            x, w_oihw, stride=m.layer.stride, groups=m.group), iters=100)
        t["bound"], bound_by[m.layer.name] = conv_bound_ms(m)
        for key in totals:
            totals[key] += t[key]
        print(f"[time] {m.layer.name} batch {BATCH}: device whole "
              f"{t['whole']:.5f} ms, window {t['window']:.5f} ms; per call "
              f"whole {t['whole_call']:.5f} ms, window "
              f"{t['window_call']:.5f} ms, plain {t['plain']:.5f} ms; "
              f"F.conv2d {t['library']:.5f} ms; bound {t['bound']:.6f} ms "
              f"({bound_by[m.layer.name]}) on {card}")
    by = ("operations" if list(bound_by.values()).count("operations")
          * 2 > len(bound_by) else "bytes")
    for name, mode, site, launches in (
            ("sdk_whole", "whole", WHOLE_SITE, main_launches["whole"]),
            ("sdk_window", "window", WINDOW_SITE, win_launches["window"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sdk_conv.cu",
            "replaces": site, "launches": launches,
            "path": ("serve cnn8 --policy auto" if mode == "whole" else
                     "cnn8 block=window + densenet40 auto forwards"),
            "max_abs_err": errors[mode], "ms": totals[mode],
            "call_ms": totals[mode + "_call"], "plain_ms": totals["plain"], "bound_ms": totals["bound"],
            "bound_by": by, "library_ms": totals["library"],
            "shapes": "cnn8 sdk layers CNN8-3..7 at batch 8, summed",
            "timing": "ms, library_ms: device time, stream held; call_ms, "
                      "plain_ms: per call incl. host"})
    # -- 7-9. the transformer path ---------------------------------------
    rows += transformer_phases(dev, card)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
