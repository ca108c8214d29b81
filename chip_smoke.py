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
6. a ``{"kernels": [...]}`` line: per kernel its launches, error, time
   at the main path's shapes, the plain version's time, the least time
   the card could take (its bound) and ``F.conv2d``'s time;

then the card line and, last, ``{"ok": true, "device": {...}}``.  The
script needs the checkout beside it (``src/``) and a CUDA device.
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
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
