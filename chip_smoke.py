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
   layer at batch 8, with launched steps held to ``mapping.cycles``, the
   blocks the whole kernel's C entry reports held to
   ``whole_launch_dims``, and each kernel's launch layout (images, run,
   columns, blocks) per tile printed;
4. main path — ``repro_torch.launch.serve_cnn.main`` serves cnn8 with the
   ``auto`` policy; the plan must be reference + five sdk layers, the
   whole kernel's launch count must grow by (warmup + steps) x its
   launches per forward and its blocks by as many times
   ``whole_launch_dims``'s, and a forward must match ``execute_oracle``;
   one forward under ``torch.profiler`` gives the device's busy share;
5. window path — the cnn8 forward with ``block="window"`` and the
   densenet40 forward (policy auto) against ``execute_oracle``, the
   window kernel's launches counted per net (under ``auto`` no served
   mapping reaches it below batch 128, so they all come from cnn8);
6. sdk times: the whole kernel, the window kernel forced and
   ``F.conv2d`` in interleaved rounds (medians) on cnn8's five sdk
   layers (the main path's shapes, summed), DN40-b2l3, Incep-3b and the
   stride-2 layer at batch 8;
7. transformer kernels vs plain — tetris_matmul, grouped_matmul and
   flash_attention against their plain versions at the shapes of the
   transformer path and at ragged tails, causal or not, with a
   ``q_offset`` and a GQA case; each matmul launch prints its block tile,
   its staging instance (16-byte, or 4-byte where K or N % 4 != 0 or x
   is offset by one float) and the blocks the C entry launched, which
   must equal ``gemm_launch_dims``'s; the attention stage at lengths that
   do not tile by 128 (whisper's 1500-frame window, 136) must launch the
   kernel once and match its plain form;
8. transformer path — ``serve`` (policy auto) of stablelm-1.6b (24
   blocks, seq 512, batch 4) and of the whisper-base encoder (6 blocks,
   seq 1024, batch 4) at full width, each with every launch count set to
   0 just before and read just after: every layer must run on
   ``matmul``, the kernels' launches must equal the forwards times their
   launches per forward, the matmul blocks the forwards times
   ``gemm_launch_dims``'s, and a forward must match ``execute_oracle``
   (plain functions only); one forward under ``torch.profiler`` gives
   its device time beside the serving loop's wall time (the busy share)
   and attention's share of it, and one more
   (with Python frames) the device time of the matmul executor's layout
   copies;
9. transformer kernel times: device time with the stream held, per-call
   time, the plain version's, the bound and the library call's
   (``torch.matmul``, ``torch.bmm``, ``F.scaled_dot_product_attention``,
   timed as yardsticks only), and per kernel its share of the bound and
   its ratio to the library call; flash_attention at 128 and at 64 rows
   a block against SDPA in interleaved rounds, SDPA's kernels named;
10. ssd_chunk and im2win_conv vs plain — ``ssd_chunk`` against
    ``ssd_chunk_plain`` at mamba2-130m's prefill shape (B 4, S 2048, H 24,
    P 64, N 128, L 256), at a ragged prompt (S 2000, padded to 2048), at
    S 100 < chunk and at the JAX kernel test's shape (G == H), in f32 and
    bf16 (the bf16 blocks launched held to ``ssd_launch_dims``), and
    through the SSD mixer against ``plain=True``;
    ``ops.conv2d`` (im2win_conv) on the 6 cnn8 and 8 Inception 5x5 layers
    at batch 8 with every count at 0 just before and read just after,
    grid steps held to ``n_cycles`` and the blocks the launches report to
    steps x cluster (each layer's cluster and block tile printed), each
    against ``F.conv2d``, and at the JAX kernel test's shapes;
11. mamba2-130m path — ``launch.serve.generate`` at full width (24
    blocks, weights drawn on the card from the seed) with batch 4, prompt
    2048, gen 32, every count at 0 just before and read just after:
    ``ssd_chunk`` launches == 24 per prefill (its blocks 24 times
    ``ssd_launch_dims``') and none from decode; the prefill's median
    ms over 5 calls after the warm-up ``generate`` and decode's median ms
    a token (phase 17's statistic, one helper), the peak allocation; the
    prefill's last-position logits against the same prefill through the
    plain versions; one prefill and one decode step under
    ``torch.profiler``;
12. the ops surface — ``ops.matmul``, ``ops.gmm``, ``ops.attention`` and
    ``ops.conv2d`` at a path shape, in f32 and in bf16, each launching its
    kernel once (the matmuls the blocks of ``gemm_launch_dims``) and
    returning its operands' dtype; a bf16 result within one bf16 rounding
    of the plain version in f32, with the device time of the casts of the
    three wrappers whose kernel is f32;
13. ssd_chunk and im2win_conv times, as in 9; ssd_chunk's bf16 launch at
    the rule's head slice, at the kernel's other widths and the f32
    instance in interleaved rounds, its bound on the bf16 tensor cores
    with C . B^T counted once per group, and the former bound (f32 rate,
    C . B^T once per head) beside it;
14. training on plans, with every launch count 0 just before each part
    and read just after (each must stay 0: no kernel has a backward):
    a) ``cim_conv2d`` and ``mapped_conv2d`` gradients against
       ``F.conv2d`` autograd on cnn8's six layers (served 512x512
       mapping, and a 64x64 one with G up to 8 whose border windows write
       positions twice) and DN40-b2l3 at batch 8, within 1e-4 of max|g|;
       the sdk entry refuses a kernel that requires grad, ``train_plan``
       refuses the served cnn8 mapping's auto plan (sdk layers); the
       served CNN8-2's forward with one writer per output position and
       with every window's write, timed;
    b) ``launch.train --plan-net`` at full width, batch 32, accum 2:
       cnn8 (6 steps), densenet40's 39 layers (4 steps) with remat off
       and auto; per run the step ms (median after the first), images/s,
       the busy share of one more step under ``torch.profiler``, its
       measured peak allocation beside the plan's estimates and the
       segment count; cnn8's first-step gradients and per-step losses
       against the same run on the CPU (1e-4 of max|g|, 1e-3 relative),
       densenet40's losses remat off against auto (1e-6 relative; bitwise
       printed), the measured peak lower with auto;
    c) the Table II proxy: ``train_cnn`` through the mapped executor at
       G = 1, 2, 4 (150 steps, n_train 1024, n_test 256): accuracy and
       ms/step printed, finite losses gated;
15. arrival-driven serving, each run with every launch count at 0 just
    before and read just after, its launches held to the sum over its
    served batches (warm-up included) of the tier plan's launches a
    forward:
    a) ``serve_cnn.main --max-delay-ms 2`` on cnn8 (policy auto, tiers 1,
       2, 4, 8, 64 requests of 1-4 rows) backlogged, at 500 requests/s
       and backlogged with ``--adaptive-delay``: every request served
       once, exec ms a batch per tier, queue-delay percentiles; at each
       tier served, the request rows of a forward on a zero-padded input
       against ``execute_oracle`` on those rows (pad-and-mask); the
       backlogged run's busy share under ``torch.profiler``;
    b) ``fleet.serve_fleet`` as ``serve_cnn --fleet`` builds it: cnn8,
       Inception's chainable prefix, DenseNet40 and the whisper-base
       encoder at full width (seq 1024), policy auto, max batch 4, 48
       requests at 200/s, a 50 ms SLO, constants shared: the CLI's rows,
       per model exec ms a batch, images/s (tokens/s), queue-delay
       percentiles and SLO attainment; one constants materialization per
       network; the schedule on a fake clock equal to the one a process
       without the card builds; then ``--fleet cnn8 --policy mapped``
       with and without ``--no-share-constants``, and
       ``execute_plan(constants=)`` bitwise the plain forward;
    c) ``serve_cnn.main --replicas 2`` (spawned workers, each with its
       own CUDA context) behind a disk cache warmed first, plain and with
       ``--kill-worker 1``: every request served exactly once (with the
       kill one death and a re-queue), each worker's start-up ms, table
       builds and disk hits;
16. the measured-feedback autotuner (``repro_torch.tune``), each search
    with every launch count at 0 just before and read just after, its
    sdk launches held to the sum over its trials of (rounds + warm-up) x
    the candidate plan's launches a forward:
    a) ``autotune`` of cnn8 at the served width (512x512, batch 8), the
       fixed profile, the default budget, over lookahead 1 and the sdk
       block modes auto / whole / window, twice with ``force=True``: the
       shortlist, each stage's medians, the winner against the baseline
       (medians, speedup, rounds, measured steps, seconds), whether the
       two winners agree; each winner's plan forward against
       ``execute_oracle``;
    b) the ragged profile on cnn8 (64 backlogged requests of 1-4 rows,
       max delay 2 ms, tiers 1/2/4/8 or the top tier alone,
       ``SMOKE_BUDGET``): every measured drain serves every request once,
       its launches those of the tier plans over the served batches;
    c) Inception's layer set through the ``execute_layerwise`` runner
       (``SMOKE_BUDGET``);
    d) ``python -m repro_torch.launch.serve_cnn --net cnn8 --batch 8
       --autotune --cache-dir D`` in two fresh processes: the first
       searches, the second reports ``[cache]`` with 0 table builds;
       then ``--policy tuned`` serves the winner's executors and block;
17. the decoder attention family (``mixer="gqa"``; plain PyTorch ops,
    as the JAX package's are plain ``jnp``), with every launch count at 0
    at its start and read at its end, when each must still be 0:
    a) stablelm-1.6b at full width and depth (24 blocks, d 2048, 32
       heads, LayerNorm, 16 rotary dims), weights drawn on the card from
       the seed (their count == ``param_count``): ``generate`` at batch
       4, prompt 2048 (four q blocks of 512), gen 32; the prefill's median
       ms over 3 calls, decode's median ms a token, tokens/s, the peak
       allocation, and one prefill and one decode step under
       ``torch.profiler`` (the busy share);
    b) on the same model in f32 compute (TF32 off): at batch 1, prompt
       512, the decode logits at position 512 within 1e-3 of max|logit|
       of the train forward's there, with the same argmax; the bf16 gap
       printed beside it;
    c) stablelm-1.6b at full width cut to 2 blocks, weights drawn on the
       CPU and copied to the card: in f32 compute the card's train logits
       at batch 1, prompt 64 within 1e-4 of max|logit| of the CPU's;
    d) qwen1.5-32b (64 -> 2 units), deepseek-67b (95 -> 2) and
       mistral-large-123b (88 -> 2) at full width (GQA groups 1, 8 and
       12, head_dim 128, QKV bias), each drawn on the card and freed
       before the next: ``generate`` at batch 2, prompt 1024 (two q
       blocks), gen 8 as in a), then b)'s check at that batch and prompt;
18. the last model families (MoE, MLA, RG-LRU, the vision prefix, the
    encoder-decoder; plain PyTorch ops, as the JAX package's are plain
    ``jnp``), with every launch count at 0 at its start and read at its
    end, when each must still be 0; each model drawn on the card from the
    seed (its count == ``param_count``) and freed before the next:
    a) deepseek-v2-lite-16b at full width and depth (27 blocks: MLA, a
       dense first layer, then 64 experts top-6 with 2 shared, MoE chunks
       of 512): ``generate`` at batch 4, prompt 2048, gen 32 with phase
       17a's timings, peak and profiles;
    b) recurrentgemma-9b at full width and depth (38 blocks: (rec, rec,
       attn) x 12 + (rec, rec); MQA with a 2048 window): ``generate`` at
       batch 2, prompt 2560 (the prefill rolls its ring), gen 32 (decode
       wraps it), as in a);
    c) phase 17b's f32 consistency on each, with the conv tails kept in
       f32 too: deepseek-v2-lite-16b at batch 1, prompt 511 (capacity 60
       as at 512 tokens; the assignments of position 511 that the train
       forward drops are printed per MoE layer, and with any the f32
       reading is printed, not gated), recurrentgemma-9b at batch 1,
       prompt 2560 (the ring decode against the windowed train forward);
    d) card vs CPU, f32, each stage cut to 2 units, the weights drawn on
       the card and copied to the CPU: deepseek-v2-lite-16b,
       recurrentgemma-9b, mixtral-8x7b and whisper-base (1500 encoder
       frames), train logits at batch 1, prompt 64, within 1e-4 of
       max|logit|;
    e) mixtral-8x7b (32 -> 2 units; window 4096, 8 experts top-2) and
       internvl2-26b (48 -> 2) at full width, ``generate`` at batch 2,
       prompt 1024, gen 8, internvl2-26b also one prefill through
       ``make_prefill_step`` with its 256 prefix embeddings; whisper-base
       at full width and depth (6 + 6 blocks) with 1500 encoder frames,
       batch 4, prompt 64, gen 32; each with a)'s timings;
19. the LM training loop (``launch.steps.make_train_step``: microbatched
    gradient accumulation, each unit recomputed in the backward, AdamW;
    ``loss_fn`` runs the plain versions, as no kernel has a backward),
    with every launch count at 0 at its start and read at its end, when
    each must still be 0; each model drawn on the card from the seed (its
    count == ``param_count``) and freed before the next:
    a) stablelm-1.6b at full width and depth at seq 4096 (the JAX
       package's train_4k sequence), global batch 4 as 4 microbatches of
       1, batches from ``TokenStream``: one warm-up and 4 timed steps, the
       step's median ms, tokens/s, the losses (finite), the peak
       allocation, and one more step under ``torch.profiler``;
    b) the same model at seq 1024, batch 1, remat on vs off: the loss
       bitwise, the gradients within 1e-6 of each leaf's max|g|, the
       backward's peak allocation lower with remat, a step's ms in each
       mode;
    c) mamba2-130m at full width and depth, seq 2048, global batch 8 as 2
       microbatches, as in a);
    d) card vs CPU in f32 compute, stablelm-1.6b and mamba2-130m with each
       stage cut to 2 units at full width (weights drawn on the card and
       copied to the CPU), batch 2, seq 64: the loss within 1e-5 relative
       and every gradient leaf within 1e-4 of its max|g|;
    e) ``launch.train --arch mamba2_130m --steps 20 --batch 8 --seq 512
       --save-every 10`` uninterrupted, then the same run losing its
       worker at step 15 and ``--resume`` from the checkpoint at 10: the
       resumed run reads the same token batches bit for bit and its
       losses are within 1e-4 relative of the uninterrupted run's
       (bitwise printed);
20. a ``{"kernels": [...]}`` line: per kernel its launches, error, time
    at its path's shapes, the plain version's time, the least time the
    card could take (its bound) and the library call's time (and, for
    the kernels phases 15 and 16 run, their launches there);

then the card line and, last, ``{"ok": true, "device": {...}}``.  The
script needs the checkout beside it (``src/``) and a CUDA device.
Matmuls and convolutions run in full f32: TF32 is switched off for
cuBLAS and cuDNN (``allow_tf32 = False``), for the library yardsticks
too.
"""
from __future__ import annotations

import contextlib
import json
import re
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
#: H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, bf16 dense
#: on the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
WHOLE_SITE = "src/repro/kernels/im2win_conv.py:380"
WINDOW_SITE = "src/repro/kernels/im2win_conv.py:354"
TETRIS_SITE = "src/repro/kernels/tetris_matmul.py:105"
GROUPED_SITE = "src/repro/kernels/grouped_matmul.py:40"
FLASH_SITE = "src/repro/kernels/flash_attention.py:86"
SSD_SITE = "src/repro/kernels/ssd_chunk.py:67"
IM2WIN_SITE = "src/repro/kernels/im2win_conv.py:128"
#: bf16 kernel output vs the plain version in f32 on the same inputs: one
#: bf16 rounding (2**-8 of the value) plus the f32 summation order
BF16_RTOL = 2.0 ** -8 + KERNEL_RTOL
#: the mamba2-130m path: full width and depth, batch 4, prompt 2048
MAMBA = ("mamba2_130m", 4, 2048, 32)
MAMBA_PREFILLS = 5
#: prefill logits through the kernel vs through the plain versions, both
#: in f32 compute, 24 blocks; relative to max|logit|.  In bf16 (as served)
#: the random-weight model amplifies the kernels' one-ulp rounding
#: differences through its 24 blocks about as far as bf16 itself moves
#: the logits from f32, so that comparison is printed beside that floor
LOGITS_RTOL = 2e-2
#: phase 17, the decoder attention family: (config, batch, prompt, gen)
#: of stablelm-1.6b at full width and depth, the prefill calls timed,
#: and (batch, prompt) of the f32 consistency check
DECODER = ("stablelm_1_6b", 4, 2048, 32)
DECODER_PREFILLS = 3
DECODER_CHECK = (1, 512)
#: the decode logits at S vs the train forward's at S, f32 compute (TF32
#: off), relative to max|logit|: the same function, the softmax over the
#: cache instead of the sequence, summed in another order
CONSISTENCY_RTOL = 1e-3
#: stablelm-1.6b cut to 2 blocks, f32 compute: card vs CPU train logits
CARD_CPU = (2, 1, 64)
CARD_CPU_RTOL = 1e-4
#: the three large configs at full width, depth cut to 2 units; (batch,
#: prompt, gen) of their generate, whose prompt also serves the check
DECODER_CUTS = ("qwen1_5_32b", "deepseek_67b", "mistral_large_123b")
CUT_UNITS = 2
CUT_RUN = (2, 1024, 8)
#: phase 18, the last model families (MoE, MLA, RG-LRU, the vision
#: prefix, the encoder-decoder): (config, batch, prompt, gen, (batch,
#: prompt) of the f32 consistency check) of the two configs run at full
#: width and depth.  deepseek-v2-lite-16b's check prompt 511 has the
#: capacity of the train forward's 512 tokens (60 slots), so its last
#: token is held to the prefill's capacity; recurrentgemma-9b's prompts
#: pass the 2048 window (the prefill rolls its ring, decode wraps it)
ZOO_FULL = (("deepseek_v2_lite_16b", 4, 2048, 32, (1, 511)),
            ("recurrentgemma_9b", 2, 2560, 32, (1, 2560)))
#: phase 18d: card vs CPU, f32, each stage cut to CUT_UNITS units, train
#: logits at (batch, prompt) of CARD_CPU
ZOO_CARD_CPU = ("deepseek_v2_lite_16b", "recurrentgemma_9b", "mixtral_8x7b",
                "whisper_base")
#: phase 18e: (config, units a stage keeps (None: all), batch, prompt,
#: gen); internvl2-26b's prefill also takes its 256 prefix embeddings
ZOO_OTHERS = (("mixtral_8x7b", CUT_UNITS, 2, 1024, 8),
              ("internvl2_26b", CUT_UNITS, 2, 1024, 8),
              ("whisper_base", None, 4, 64, 32))
#: whisper-base's encoder frames: its 30 s window
WHISPER_FRAMES = 1500
#: the transformer path: (config, seq, batch), full width and depth
TRANSFORMERS = (("stablelm_1_6b", 512, 4), ("whisper_base", 1024, 4))
TF_WARMUP, TF_STEPS = 1, 20
#: interleaved rounds of the kernel-vs-kernel timings (medians)
ROUNDS = 5
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


def sdk_layout(mode: str, geom) -> tuple:
    """(b_chunk, run, oc_b, blocks) of the whole or window kernel's launch
    on one tile at BATCH."""
    from repro_torch.kernels import sdk_conv as sk
    rule = sk.whole_launch_dims if mode == "whole" else sk.window_launch_dims
    d = rule(BATCH, geom)
    return d.b_chunk, d.run, d.oc_b, d.blocks


def whole_blocks(mapping) -> int:
    """Blocks of the whole kernel's launches on one sdk layer at BATCH
    under whole_launch_dims: every tile once per group."""
    from repro_torch.kernels import sdk_conv as sk
    return mapping.group * sum(
        sk.whole_launch_dims(BATCH, sk.tile_geom(mapping, t)).blocks
        for t in mapping.tiles)


def interleaved_ms(fns: dict, iters: int, rounds: int) -> dict:
    """Median device time (stream held) of each ``fns`` entry over
    ``rounds`` rounds that take the entries in turn."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(device_ms(fn, iters))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def sdk_times(m, rng, dev) -> dict:
    """One sdk layer at BATCH: the whole kernel, the window kernel forced
    and F.conv2d interleaved (device time, a launch per tile call, no zero
    fill: every timed tile covers its output), each kernel's per-call time
    and the plain version's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import sdk_conv as sk
    x, k = layer_data(m, rng, dev)
    runs = {}
    for mode, fn in (("whole", sk.sdk_whole), ("window", sk.sdk_window)):
        cs = sk.tile_calls(m, x, k, block=mode)
        runs[mode] = (lambda fn=fn, cs=cs: [fn(c.xt, c.kt, c.geom)
                                            for c in cs])
    w_oihw = k.permute(3, 2, 0, 1).contiguous()
    runs["library"] = lambda: F.conv2d(x, w_oihw, stride=m.layer.stride,
                                       groups=m.group)
    cs = sk.tile_calls(m, x, k)
    t = interleaved_ms(runs, max(8, 200 // len(cs)), ROUNDS)
    for mode in ("whole", "window"):
        t[mode + "_call"] = call_ms(runs[mode], iters=200)
    t["plain"] = call_ms(lambda: [sk.tile_plain(c.xt, c.kt, c.geom, c.mode)
                                  for c in cs], iters=20)
    torch.cuda.synchronize()
    return t


def max_err(y, ref) -> tuple:
    scale = float(ref.abs().max())
    err = float((y - ref).abs().max())
    return err, err / max(scale, 1e-30), scale


def randn(rng, shape, device, scale=1.0):
    import torch
    return torch.as_tensor((rng.randn(*shape) * scale).astype("float32"),
                           device=device)


def bound_ms(flops: float, nbytes: float,
             rate: float = PEAK_F32_FLOPS) -> tuple:
    """(ms, "bytes" | "operations"): FLOPs at ``rate`` (the f32 peak
    unless given) or bytes at the memory rate, whichever takes longer."""
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES_PER_S
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


def check(label: str, y, ref, tol: float = KERNEL_RTOL) -> float:
    """Print and enforce kernel vs plain within ``tol`` of max|ref| (any
    float types, compared in f32); returns the max abs error."""
    import torch
    torch.cuda.synchronize()
    err, rel, scale = max_err(y.float(), ref.float())
    ok = (y.shape == ref.shape and bool(torch.isfinite(y).all())
          and rel <= tol)
    print(f"[kernel] {label}: max_abs_err={err:.3e} rel={rel:.3e} (tol "
          f"{tol:.3g} of max|y|={scale:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version")
    return err


def gemm_check(label: str, fn, plain, x, w, groups: int, m: int,
               n: int) -> float:
    """One launch of a matmul wrapper ``fn`` against its plain version,
    with its block tile, staging instance and the blocks the C entry
    reports launched printed; the blocks must equal the launch rule's.
    Returns the max abs error."""
    import torch
    from repro_torch.kernels import tetris_matmul as tm
    before = fn.blocks
    y = fn(x, w)
    torch.cuda.synchronize()
    blocks = fn.blocks - before
    d = tm.gemm_launch_dims(groups, m, n, tm.sm_count(y.device))
    inst = "16-byte" if tm.vector_staging(x, w, y) else "4-byte"
    if blocks != d.blocks:
        raise AssertionError(f"{label}: {blocks} blocks launched != "
                             f"gemm_launch_dims's {d.blocks}")
    return check(f"{label} tile {d.bm}x{d.bn} {inst} staging, blocks "
                 f"{blocks} (rule {d.blocks})", y, plain(x, w))


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
    mnk = [(m, f, d, 0) for g, m, d, f in shapes["whisper_base"]]
    # ragged tails; tile multiples +-1; K or N % 4 != 0 and an x offset by
    # one float (x[:, 1:]) force the 4-byte instance
    for m, n, k, off in mnk + [(1000, 1000, 96, 0), (130, 520, 72, 0),
                               (128, 128, 32, 0), (127, 129, 33, 0),
                               (129, 127, 31, 0), (4096, 516, 512, 0),
                               (4096, 512, 510, 0), (4096, 512, 512, 1)]:
        x = randn(rng, (m, k + off), dev)[:, off:]
        w = randn(rng, (k, n), dev)
        e = gemm_check(f"tetris_matmul (M,N,K)=({m},{n},{k})"
                       + (f" x[:, {off}:]" if off else ""),
                       tm.tetris_matmul_cuda, tm.matmul_ref, x, w, 1, m, n)
        errs["tetris_matmul"] = max(errs["tetris_matmul"], e)
    for g, m, d, f in shapes["stablelm_1_6b"] + [
            (3, 100, 40, 72), (4, 129, 64, 127), (2, 127, 63, 128)]:
        x = randn(rng, (g, m, d), dev)
        # the executor's group-major view of a (D, G*F) kernel
        w = randn(rng, (d, g * f), dev).reshape(d, g, f).transpose(0, 1)
        e = gemm_check(f"grouped_matmul (G,M,D,F)=({g},{m},{d},{f})",
                       gm.grouped_matmul_cuda, gm.grouped_matmul_ref, x, w,
                       g, m, f)
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
    from repro_torch.kernels import im2win_conv as iw
    from repro_torch.kernels import sdk_conv as sk
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import tetris_matmul as tm
    for mod in (sk, tm, gm, fa, sc, iw):
        mod.reset_counts()


def launch_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import im2win_conv as iw
    from repro_torch.kernels import sdk_conv as sk
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import tetris_matmul as tm
    return {"tetris_matmul": tm.tetris_matmul_cuda.launches,
            "grouped_matmul": gm.grouped_matmul_cuda.launches,
            "flash_attention": fa.flash_attention_cuda.launches,
            "sdk_whole": sk.sdk_whole.launches,
            "sdk_window": sk.sdk_window.launches,
            "ssd_chunk": sc.ssd_chunk_cuda.launches,
            "im2win_conv": iw.im2win_conv_cuda.launches}


def serve_transformer(net, inputs, batch: int, dev, card: str) -> dict:
    """Phase 8 for one model: serve it through the compiled plan with
    every count at 0 just before, hold the launches to the plan, the
    matmul blocks to gemm_launch_dims, and the forward to the
    plain-function oracle.  Returns (launches, matmul blocks)."""
    import torch
    from repro_torch.exec import execute_oracle, execute_plan
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import tetris_matmul as tm
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
    blocks, tiles = gemm_blocks_per_forward(plan, batch)
    got = {"tetris_matmul": tm.tetris_matmul_cuda.blocks,
           "grouped_matmul": gm.grouped_matmul_cuda.blocks}
    print(f"[transformer] {name}: matmul blocks launched {got} over "
          f"{forwards} forwards (gemm_launch_dims per forward {blocks}; "
          f"(G, M, N) -> tile {tiles})")
    for k, n in blocks.items():
        if got[k] != forwards * n:
            raise AssertionError(f"{name}: {k} launched {got[k]} blocks "
                                 f"!= {forwards} forwards x {n}")
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
    profile_call(f"{name} one forward", lambda: execute_plan(plan, ks, xs),
                 stats.s_per_batch * 1e3, "flash_attention")
    executor_copies(name, lambda: execute_plan(plan, ks, xs))
    return launches, got


def gemm_blocks_per_forward(plan, batch: int) -> tuple:
    """({kernel: blocks per forward}, {(G, M, N): "bm x bn"}) of the
    plan's matmul layers under gemm_launch_dims."""
    from repro_torch.kernels import tetris_matmul as tm
    blocks = {"tetris_matmul": 0, "grouped_matmul": 0}
    tiles = {}
    for lp in plan.layers:
        lay, g = lp.mapping.layer, lp.mapping.group
        gmn = (g, batch * lay.i_h, lay.oc // g)
        d = tm.gemm_launch_dims(*gmn, tm.sm_count("cuda"))
        blocks["grouped_matmul" if g > 1 else "tetris_matmul"] += d.blocks
        tiles[gmn] = f"{d.bm}x{d.bn}"
    return blocks, tiles


@contextlib.contextmanager
def labelled_matmul_executor():
    """Within the block, each ``matmul_exec.matmul_layer`` call of the
    plan runs in a ``record_function`` range ``matmul_layer``, and its
    call of the matmul kernel's wrapper in a range ``matmul_kernel``."""
    import torch
    from repro_torch.exec import run
    from repro_torch.kernels import matmul_exec as me
    saved = (run.matmul_layer, me.grouped_matmul, me.tetris_matmul)

    def label(name, fn):
        def labelled(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return labelled
    run.matmul_layer = label("matmul_layer", saved[0])
    me.grouped_matmul = label("matmul_kernel", saved[1])
    me.tetris_matmul = label("matmul_kernel", saved[2])
    try:
        yield
    finally:
        run.matmul_layer, me.grouped_matmul, me.tetris_matmul = saved


def executor_copies(label: str, fn) -> None:
    """One ``fn()`` under ``torch.profiler`` with the matmul executor
    labelled: the device time spent in ``matmul_layer`` outside its call
    of the kernel's wrapper — the executor's permute/reshape copies —
    against the forward's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with labelled_matmul_executor(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    layers = [e for e in cpu if e.name == "matmul_layer"]
    copies_us = (sum(e.device_time_total for e in layers)
                 - sum(e.device_time_total for e in cpu
                       if e.name == "matmul_kernel"))
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key not in ("matmul_layer", "matmul_kernel"))
    if not layers or total_us == 0:
        print(f"[profile] {label}: matmul executor copies not measured "
              f"({len(layers)} matmul_layer ranges, {total_us:.1f} us of "
              f"device time)")
        return
    print(f"[profile] {label} one forward: the matmul executor's layout "
          f"copies take {copies_us / 1e3:.4f} ms of device time over "
          f"{len(layers)} matmul_layer calls ({100 * copies_us / total_us:.1f}"
          f" % of the forward's {total_us / 1e3:.4f} ms)")


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

    def tile(g, m, n):
        d = tm.gemm_launch_dims(g, m, n, tm.sm_count(dev))
        return f" tile {d.bm}x{d.bn}, {d.blocks} blocks"

    for g, m, d, f in shapes["whisper_base"]:
        x, w = randn(rng, (m, d), dev), randn(rng, (d, f), dev)
        add("tetris_matmul", f"(M,N,K)=({m},{f},{d})" + tile(1, m, f),
            lambda: tm.tetris_matmul_cuda(x, w), lambda: tm.matmul_ref(x, w),
            lambda: torch.matmul(x, w), 2.0 * m * f * d,
            4.0 * (m * d + d * f + m * f))
    for g, m, d, f in shapes["stablelm_1_6b"]:
        x = randn(rng, (g, m, d), dev)
        w = randn(rng, (d, g * f), dev).reshape(d, g, f).transpose(0, 1)
        add("grouped_matmul", f"(G,M,D,F)=({g},{m},{d},{f})" + tile(g, m, f),
            lambda: gm.grouped_matmul_cuda(x, w),
            lambda: gm.grouped_matmul_ref(x, w), lambda: torch.bmm(x, w),
            2.0 * g * m * d * f, 4.0 * g * (m * d + d * f + m * f))
    for bh, s, d, causal in shapes["attention"]:
        q = randn(rng, (bh, s, d), dev)
        k, v = randn(rng, (bh, s, d), dev), randn(rng, (bh, s, d), dev)
        rule = fa.flash_launch_dims(bh, s, d, tm.sm_count(dev),
                                    causal=causal)
        runs = {rows: (lambda rows=rows: fa.flash_attention_cuda(
            q, k, v, causal=causal, rows=rows)) for rows in fa.BLOCK_ROWS}
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
        t = interleaved_ms(runs, 20, ROUNDS)
        flops, nbytes = attention_work(bh, s, s, d, causal)
        got = {"ms": t[rule.rows], "call_ms": call_ms(runs[rule.rows], 20),
               "plain_ms": call_ms(lambda: fa.flash_attention_ref(
                   q, k, v, causal=causal), 5),
               "library_ms": t["sdpa"], "flops": flops, "bytes": nbytes}
        for key in keys:
            totals["flash_attention"][key] += got[key]
        bound, by = bound_ms(flops, nbytes)
        print(f"[time] flash_attention BH={bh} S={s} D={d} causal={causal} "
              f"(medians of {ROUNDS} interleaved rounds): 128 rows "
              f"{t[128]:.5f} ms ({flops / t[128] / 1e9:.3f} TFLOP/s), 64 rows "
              f"{t[64]:.5f} ms ({flops / t[64] / 1e9:.3f} TFLOP/s); the rule "
              f"takes {rule.rows} rows ({rule.blocks} blocks); per call "
              f"{got['call_ms']:.5f} ms, plain {got['plain_ms']:.5f} ms; SDPA "
              f"{t['sdpa']:.5f} ms ({flops / t['sdpa'] / 1e9:.3f} TFLOP/s; "
              f"its kernels {device_kernel_names(runs['sdpa'])}); bound "
              f"{bound:.6f} ms ({by}) on {card}")
    for name, t in totals.items():
        t["bound_ms"], t["bound_by"] = bound_ms(t["flops"], t["bytes"])
        print(f"[time] {name} summed: device {t['ms']:.5f} ms = "
              f"{100 * t['bound_ms'] / t['ms']:.1f} % of its bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}), "
              f"{t['flops'] / t['ms'] / 1e9:.3f} TFLOP/s, "
              f"{t['ms'] / t['library_ms']:.3f}x the library call's "
              f"{t['library_ms']:.5f} ms on {card}")
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
    blocks = {}
    for arch, (net, batch) in nets.items():
        t0 = time.perf_counter()
        inputs = serve_cnn.serving_inputs(net, batch, SEED, dev)
        print(f"[transformer] {arch}: drew {len(inputs[0])} kernels and "
              f"the input in {time.perf_counter() - t0:.3f} s")
        got, got_blocks = serve_transformer(net, inputs, batch, dev, card)
        for k in launches:
            launches[k] += got[k]
        for k, n in got_blocks.items():
            blocks[k] = blocks.get(k, 0) + n
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
        if name in blocks:          # blocks launched on its path
            rows[-1]["blocks"] = blocks[name]
    return rows


def ssd_inputs(rng, b, s, h, p, g, n, dev, dtype):
    """The JAX kernel test's distributions: dt > 0 small, a_log ~ 0."""
    import numpy as np
    import torch

    def on(a):
        return torch.as_tensor(a.astype("float32"), device=dev).to(dtype)
    return (on(rng.randn(b, s, h, p)), on(np.abs(rng.randn(b, s, h)) * 0.1
                                          + 0.05),
            torch.as_tensor((rng.randn(h) * 0.3).astype("float32"),
                            device=dev),
            on(rng.randn(b, s, g, n) * 0.3), on(rng.randn(b, s, g, n) * 0.3))


def ssd_kernel_checks(dev) -> float:
    """Phase 10, ssd_chunk: the kernel against ssd_chunk_plain (f32 on the
    same values) at the path's shape, a ragged prompt padded as
    ``ssd_chunked`` pads it, S < chunk and the JAX test's shape, then the
    mixer against ``plain=True``.  Returns the largest error on y or S."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import ssm
    rng = np.random.RandomState(SEED)
    arch, b, prompt, _ = MAMBA
    cfg = get_config(arch).ssm
    h, p, g, n = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    worst = 0.0
    cases = [((b, s, h, p, g, n), min(cfg.chunk, s))
             for s in (prompt, prompt - 48, 100)]
    cases += [((2, 128, 4, 16, 4, 8), 128), ((2, 128, 4, 16, 4, 8), 32)]
    for shape, chunk in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a_log, bm, cm = ssd_inputs(rng, *shape, dev, dtype)
            if shape[1] % chunk:            # pad as ssd_chunked does
                pad = chunk - shape[1] % chunk
                x, dt, bm, cm = (torch.cat([a, a.new_zeros(
                    (a.shape[0], pad) + a.shape[2:])], 1)
                    for a in (x, dt, bm, cm))
            sc.reset_counts()
            y, st = sc.ssd_chunk_cuda(x, dt, a_log, bm, cm, chunk=chunk)
            torch.cuda.synchronize()
            launched = sc.ssd_chunk_cuda.launches
            want_y, want_s = sc.ssd_chunk_plain(
                *(a.float() for a in (x, dt)), a_log, bm.float(), cm.float(),
                chunk=chunk)
            bf = dtype == torch.bfloat16
            layout = ""
            if bf:            # the bf16 blocks launched == the rule's
                lay = sc.ssd_launch_dims(*x.shape, *bm.shape[2:], chunk,
                                         sc.sm_count(dev))
                layout = (f" heads/block={lay.heads} state_level="
                          f"{lay.state_level} blocks={sc.ssd_chunk_cuda.blocks}"
                          f" (rule {lay.blocks})")
                if sc.ssd_chunk_cuda.blocks != lay.blocks:
                    raise AssertionError(f"ssd_chunk launched "
                                         f"{sc.ssd_chunk_cuda.blocks} blocks,"
                                         f" ssd_launch_dims {lay.blocks}")
            label = (f"ssd_chunk {'bf16' if bf else 'f32'} (B,S,H,P,G,N)="
                     f"{tuple(x.shape[:3]) + shape[3:]} from S={shape[1]} "
                     f"L={chunk} launches={launched}{layout}")
            worst = max(worst,
                        check(label + " y", y, want_y,
                              BF16_RTOL if bf else KERNEL_RTOL),
                        check(label + " states", st, want_s))
            if launched != 1:
                raise AssertionError(f"{label}: {launched} launches, not 1")
    s = prompt - 48                             # ragged: padded to prompt
    x, dt, a_log, bm, cm = ssd_inputs(rng, b, s, h, p, g, n, dev,
                                      torch.float32)
    d = torch.ones(h, device=dev)
    sc.reset_counts()
    y, st = ssm.ssd_chunked(x, dt, a_log, bm, cm, d, cfg)
    launches = sc.ssd_chunk_cuda.launches
    want_y, want_s = ssm.ssd_chunked(x, dt, a_log, bm, cm, d, cfg,
                                     plain=True)
    check(f"ssd_chunked f32 (B,S,H,P,G,N)={(b, s, h, p, g, n)} "
          f"launches={launches} y", y, want_y)
    check(f"ssd_chunked f32 S={s} final state", st, want_s)
    if launches != 1:
        raise AssertionError(f"ssd_chunked: {launches} kernel launches, "
                             f"not 1")
    return worst


def conv_path(dev) -> tuple:
    """Phase 10, im2win_conv: ``ops.conv2d`` over the paper's 14 layers at
    batch 8, every count at 0 just before and read just after, the grid
    steps held to n_cycles and the blocks to steps x cluster; each output
    against F.conv2d (the plain version), then the JAX kernel test's
    shapes.  Returns (launches on the path, largest error, the layers'
    inputs, {"steps", "blocks", "cluster"} of the path)."""
    import numpy as np
    import torch
    from repro_torch.core import networks
    from repro_torch.kernels import im2win_conv as iw
    from repro_torch.kernels import ops
    rng = np.random.RandomState(SEED)
    layers = networks.cnn8() + networks.inception()
    data = [(lay, randn(rng, (BATCH, lay.i_h, lay.i_w, lay.ic), dev),
             randn(rng, (lay.k_h, lay.k_w, lay.ic, lay.oc), dev, 0.1))
            for lay in layers]
    cycles, want_blocks, clusters = 0, 0, []
    for lay, x, w in data:
        o_h, o_w, th, tw = iw.conv_window(x.shape, w.shape)
        cluster, tile = iw.cluster_split(th, tw, lay.oc, lay.ic, lay.k_h,
                                         lay.k_w)
        steps = iw.n_cycles(o_h, o_w, th, tw, BATCH)
        cycles += steps
        want_blocks += steps * cluster
        clusters.append(cluster)
        print(f"[conv] {lay.name} window ({th},{tw}) x O={lay.oc}: {steps} "
              f"steps x cluster {cluster}, block tile {tile.pos} positions "
              f"x {tile.oc} channels ({tile.co} channel parts), cs "
              f"{tile.cs}, ks {tile.ks}, smem {tile.smem} B")
    reset_all_counts()
    outs = [ops.conv2d(x, w) for _, x, w in data]
    torch.cuda.synchronize()
    counts = launch_counts()
    steps, blocks = iw.im2win_conv_cuda.steps, iw.im2win_conv_cuda.blocks
    print(f"[conv] ops.conv2d over {len(data)} layers at batch {BATCH}: "
          f"im2win_conv launches={counts['im2win_conv']} steps={steps} "
          f"n_cycles={cycles} blocks launched={blocks} (steps x cluster "
          f"{want_blocks}); other launches "
          f"{ {k: v for k, v in counts.items() if k != 'im2win_conv'} }")
    if counts["im2win_conv"] != len(data) or steps != cycles \
            or blocks != want_blocks or any(
                v for k, v in counts.items() if k != "im2win_conv"):
        raise AssertionError("the ops.conv2d path did not launch exactly one "
                             "im2win_conv per layer over n_cycles clusters "
                             "of cluster_split's size")
    worst = 0.0
    for (lay, x, w), y, cluster in zip(data, outs, clusters):
        o_h, o_w, th, tw = iw.conv_window(x.shape, w.shape)
        worst = max(worst, check(
            f"im2win_conv {lay.name} batch {BATCH} window ({th},{tw}) "
            f"steps={iw.n_cycles(o_h, o_w, th, tw, BATCH)} cluster="
            f"{cluster}", y, iw.im2win_conv_plain(x, w), KERNEL_RTOL))
    for b, h, w_, c, k, o in ((2, 18, 18, 24, 3, 32), (1, 12, 12, 8, 5, 16),
                              (2, 9, 9, 32, 3, 64), (1, 7, 7, 3, 3, 5)):
        x = randn(rng, (b, h, w_, c), dev)
        w = randn(rng, (k, k, c, o), dev, 0.1)
        worst = max(worst, check(
            f"im2win_conv JAX test cfg {(b, h, w_, c, k, o)}",
            iw.im2win_conv_cuda(x, w), iw.im2win_conv_plain(x, w),
            KERNEL_RTOL))
    grid = {"steps": steps, "blocks": blocks, "cluster": clusters}
    return counts["im2win_conv"], worst, data, grid


def mamba_phase(dev, card: str) -> int:
    """Phase 11: serve mamba2-130m through ``generate`` at full width;
    returns ssd_chunk's launches on that path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import transformer as T
    arch, batch, prompt, gen = MAMBA
    cfg = get_config(arch)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(cfg, g, dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                            device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in T.tree_leaves(params))
    print(f"[mamba] {cfg.name}: {cfg.n_layers} blocks, d {cfg.d_model}, "
          f"{n_par} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    if n_par != cfg.param_count():
        raise AssertionError(f"{n_par} parameters != param_count "
                             f"{cfg.param_count()}")

    reset_all_counts()
    launches, n_pre, n_dec = time_generate(cfg.name, cfg, params, prompts,
                                           gen, MAMBA_PREFILLS, card,
                                           "ssd_chunk")
    print(f"[mamba] launches: {launches} in the warm-up generate, "
          f"ssd_chunk {n_pre['ssd_chunk']} in the timed prefills, "
          f"{n_dec['ssd_chunk']} in decode")
    if launches["ssd_chunk"] != cfg.n_layers or any(
            v for k, v in launches.items() if k != "ssd_chunk"):
        raise AssertionError(f"generate launched {launches}, not "
                             f"ssd_chunk x {cfg.n_layers} (one prefill) only")
    if (n_pre["ssd_chunk"] != cfg.n_layers * MAMBA_PREFILLS
            or n_dec["ssd_chunk"] != 0):
        raise AssertionError(f"ssd_chunk launched {n_pre['ssd_chunk']} "
                             f"times in {MAMBA_PREFILLS} prefills and "
                             f"{n_dec['ssd_chunk']} in decode")
    m = cfg.ssm
    lay = sc.ssd_launch_dims(batch, prompt, m.n_heads, m.head_dim,
                             m.n_groups, m.d_state, min(m.chunk, prompt),
                             sc.sm_count(dev))
    n_all = sc.ssd_chunk_cuda.launches
    print(f"[mamba] ssd_chunk blocks launched {sc.ssd_chunk_cuda.blocks} == "
          f"{n_all} launches x ssd_launch_dims {lay.blocks} ({lay.heads} "
          f"heads a y block, state_level {lay.state_level}, {lay.smem} B of "
          f"shared memory): "
          f"{sc.ssd_chunk_cuda.blocks == n_all * lay.blocks}")
    if sc.ssd_chunk_cuda.blocks != n_all * lay.blocks:
        raise AssertionError("the prefill's ssd_chunk launches ran other "
                             "blocks than ssd_launch_dims gives")

    logits = {}
    for dtype in (torch.float32, torch.bfloat16):
        with compute_dtype(dtype):
            for plain in (False, True):
                logits[dtype, plain] = T.forward(
                    params, cfg, tokens=prompts, mode="prefill",
                    plain=plain)[0].float()
    torch.cuda.synchronize()
    err, rel, scale = max_err(logits[torch.float32, False],
                              logits[torch.float32, True])
    print(f"[mamba] prefill logits in f32 compute, kernel vs plain versions:"
          f" max_abs_err={err:.3e} rel={rel:.3e} (tol {LOGITS_RTOL:g} of "
          f"max|logit|={scale:.3f})")
    lk, lp = logits[torch.bfloat16, False], logits[torch.bfloat16, True]
    _, rel_bf, _ = max_err(lk, lp)
    _, floor, _ = max_err(lp, logits[torch.float32, True])
    print(f"[mamba] prefill logits in bf16 compute (as served), kernel vs "
          f"plain: rel={rel_bf:.3e}; the plain path's own bf16 vs f32 "
          f"rel={floor:.3e}; argmax equal in "
          f"{int((lk.argmax(-1) == lp.argmax(-1)).sum())}/{batch}")
    if not (rel <= LOGITS_RTOL and all(bool(torch.isfinite(v).all())
                                       for v in logits.values())
            and lk.shape == (batch, 1, cfg.padded_vocab)):
        raise AssertionError("mamba2-130m prefill disagrees with its plain "
                             "version")
    return launches["ssd_chunk"]


@contextlib.contextmanager
def compute_dtype(dtype):
    """The port's model compute type (bf16 as served) and the type a
    prefill stores its conv tails in (bf16 as the reference writes) set
    to ``dtype`` for the block, then restored."""
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    old = common.COMPUTE_DTYPE, T.CONV_TAIL_DTYPE
    common.COMPUTE_DTYPE = T.CONV_TAIL_DTYPE = dtype
    try:
        yield
    finally:
        common.COMPUTE_DTYPE, T.CONV_TAIL_DTYPE = old


def device_kernel_names(fn) -> list:
    """The names of the device kernels one ``fn()`` runs (torch.profiler),
    each cut to 60 characters."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:60] for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def profile_call(label: str, fn, wall_ms: float, kernel: str = "",
                 host: bool = True) -> None:
    """One ``fn()`` under ``torch.profiler``: its device time (kernels,
    copies, fills) beside the call's wall time when it serves (their
    ratio is the device's busy share), the part of the device entries
    whose name holds ``kernel`` with the names it matched, and the
    largest entries.  ``host=False`` records the device activity alone
    (a training step's hundreds of thousands of host events take tens of
    seconds to sum)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if host:
        acts.insert(0, ProfilerActivity.CPU)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev)
    if total_us == 0:
        print(f"[profile] {label}: device time not measured (the profiler "
              f"recorded no device events); {wall_ms:.4f} ms wall time")
        return
    part = ""
    if kernel:
        hits = [e for e in dev if kernel in e.key]
        k_us = sum(e.self_device_time_total for e in hits)
        part = (f"{kernel} {k_us / 1e3:.4f} ms ({100 * k_us / total_us:.1f} "
                f"%) in " + (", ".join(f"{e.key} x{e.count}" for e in hits)
                             or "no entry") + "; ")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    cost = "" if host else (f" (profiled and summed in "
                            f"{time.perf_counter() - t0:.3f} s)")
    print(f"[profile] {label}{cost}: {total_us / 1e3:.4f} ms of device time "
          f"in {sum(e.count for e in dev)} device events, "
          f"{100 * total_us / 1e3 / wall_ms:.1f} % of its {wall_ms:.4f} ms "
          f"wall time; {part}largest: " + "; ".join(
              f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.4f}"
              f" ms" for e in top))


def ops_phase(dev, card: str) -> None:
    """Phase 12: each public wrapper once at a path shape on the card, in
    f32 and in bf16, each launching its own kernel exactly once; a bf16
    result in bf16 within one bf16 rounding of the plain version in f32.
    For the three wrappers that cast bf16 to f32 around their f32 kernel,
    the casts' device time beside the kernel's."""
    import numpy as np
    import torch
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tetris_matmul as tm
    rng = np.random.RandomState(SEED)
    calls = {
        "tetris_matmul": ("ops.matmul (4096,512)@(512,1536)", ops.matmul,
                          ref.matmul_ref, (randn(rng, (4096, 512), dev),
                                           randn(rng, (512, 1536), dev))),
        "grouped_matmul": ("ops.gmm (4,2048,512)@(4,512,1536)", ops.gmm,
                           ref.grouped_matmul_ref,
                           (randn(rng, (4, 2048, 512), dev),
                            randn(rng, (4, 512, 1536), dev))),
        "flash_attention": ("ops.attention BH=32 S=1024 D=64", ops.attention,
                            ref.flash_attention_ref,
                            tuple(randn(rng, (32, 1024, 64), dev)
                                  for _ in range(3))),
        "im2win_conv": ("ops.conv2d Incep-3b batch 8", ops.conv2d,
                        ref.conv2d_ref, (randn(rng, (8, 28, 28, 32), dev),
                                         randn(rng, (5, 5, 32, 96), dev,
                                               0.1)))}
    gemms = {"tetris_matmul": tm.tetris_matmul_cuda,
             "grouped_matmul": gm.grouped_matmul_cuda}
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        for name, (label, fn, plain, f32_args) in calls.items():
            args = tuple(a.to(dtype) for a in f32_args)
            label = f"{label} {'bf16' if bf else 'f32'}"
            before = launch_counts()
            blocks = gemms[name].blocks if name in gemms else 0
            y = fn(*args)
            torch.cuda.synchronize()
            after = launch_counts()
            moved = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            check(f"{label} -> {str(y.dtype)[6:]} ({moved})", y,
                  plain(*(a.float() for a in args)),
                  BF16_RTOL if bf else KERNEL_RTOL)
            if moved != {name: 1} or y.dtype != dtype:
                raise AssertionError(f"{label} launched {moved}, not {name} "
                                     f"once, or returned {y.dtype}")
            if name in gemms:
                gmn = (1,) + tuple(y.shape) if y.dim() == 2 else tuple(
                    y.shape)
                want = tm.gemm_launch_dims(*gmn, tm.sm_count(dev)).blocks
                if gemms[name].blocks - blocks != want:
                    raise AssertionError(f"{label}: "
                                         f"{gemms[name].blocks - blocks} "
                                         f"blocks launched != {want}")
            if bf:
                ops_bf16_times(label, name, fn, args, card)


def ops_bf16_times(label: str, name: str, fn, args, card: str) -> None:
    """Device times of one bf16 wrapper call: the call, the same wrapper
    on f32 copies of its operands (the kernel alone for the three f32
    kernels) and, for those three, the casts the bf16 call adds (operands
    to f32, the result to bf16)."""
    import torch
    f32 = tuple(a.float() for a in args)
    y32 = fn(*f32)
    runs = {"bf16": lambda: fn(*args), "f32": lambda: fn(*f32)}
    if name != "flash_attention":
        runs["casts"] = lambda: ([a.float() for a in args],
                                 y32.to(torch.bfloat16))
    t = interleaved_ms(runs, 20, 3)
    casts = (f", its casts {t['casts']:.5f} ms" if "casts" in t else
             " (the kernel loads bf16 itself)")
    print(f"[time] {label}: device {t['bf16']:.5f} ms, the f32 call "
          f"{t['f32']:.5f} ms{casts} on {card}")


def ssd_work(b, s, h, p, g, n, chunk) -> tuple:
    """(FLOPs, FLOPs with C . B^T once per head, bytes) of one ssd_chunk
    call: per (batch * chunk) the causal pairs L (L + 1) / 2 times 2 N for
    C . B^T per group and 2 P for y per head, and 2 L P N per head for the
    state; x, dt, B, C (bf16), a_log read once, y (bf16) and the states
    (f32) written once."""
    bc, pairs = b * (s // chunk), chunk * (chunk + 1) / 2
    head = bc * h * (pairs * 2 * p + 2 * chunk * p * n)
    nbytes = (2 * (2 * b * s * h * p + b * s * h + 2 * b * s * g * n)
              + 4 * h + 4 * bc * h * p * n)
    return (bc * g * pairs * 2 * n + head, bc * h * pairs * 2 * n + head,
            nbytes)


def time_new_kernels(conv_data, dev, card: str) -> dict:
    """Phase 13: ssd_chunk at the path's shape (one block's prefill, bf16
    as served) and im2win_conv over the 14 layers, summed: device time
    (stream held), per-call time, the plain version's, the library
    call's (F.conv2d; none computes ssd_chunk) and the bound.  For
    ssd_chunk the bf16 kernel at the rule's head slice and at each other
    width the kernel has, and the f32 instance (the first port's CUDA-core
    body) on f32 copies, in interleaved rounds; the bound on the bf16
    tensor cores with C . B^T once per group, and the former bound (f32
    rate, C . B^T once per head) beside it."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import im2win_conv as iw
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.configs import get_config
    rng = np.random.RandomState(SEED)
    arch, b, s, _ = MAMBA
    m = get_config(arch).ssm
    h, p, g, n, chunk = (m.n_heads, m.head_dim, m.n_groups, m.d_state,
                         min(m.chunk, s))
    x, dt, a_log, bm, cm = ssd_inputs(rng, b, s, h, p, g, n, dev,
                                      torch.bfloat16)
    f32 = [t.float() for t in (x, dt)] + [a_log] + [t.float()
                                                     for t in (bm, cm)]
    flops, flops_per_head, nbytes = ssd_work(b, s, h, p, g, n, chunk)
    lay = sc.ssd_launch_dims(b, s, h, p, g, n, chunk, sc.sm_count(dev))
    runs = {"bf16": lambda: sc.ssd_chunk_cuda(x, dt, a_log, bm, cm,
                                              chunk=chunk)}
    for w in sc.SLICE_HEADS:
        try:
            sc.ssd_launch_dims(b, s, h, p, g, n, chunk, sc.sm_count(dev),
                               slice_heads=w)
        except ValueError:
            continue
        if w != lay.heads:
            runs[f"bf16 {w} heads a block"] = (
                lambda w=w: sc.ssd_chunk_cuda(x, dt, a_log, bm, cm,
                                              chunk=chunk, slice_heads=w))
    runs["f32 instance"] = lambda: sc.ssd_chunk_cuda(*f32, chunk=chunk)
    t = interleaved_ms(runs, 20, ROUNDS)
    run = runs["bf16"]
    t_ssd = {"ms": t["bf16"], "call_ms": call_ms(run, 20),
             "plain_ms": call_ms(lambda: sc.ssd_chunk_plain(
                 x, dt, a_log, bm, cm, chunk=chunk), 3, warmup=1),
             "library_ms": None}
    t_ssd["bound_ms"], t_ssd["bound_by"] = bound_ms(flops, nbytes,
                                                    PEAK_BF16_FLOPS)
    t_ssd["bound_f32_ms"], by_f32 = bound_ms(flops_per_head, nbytes)
    print(f"[time] ssd_chunk bf16 (B,S,H,P,G,N,L)=({b},{s},{h},{p},{g},{n},"
          f"{chunk}), {lay.heads} heads a y block, {lay.blocks} blocks: "
          f"device {t_ssd['ms']:.5f} ms (median of {ROUNDS} interleaved "
          f"rounds), per call {t_ssd['call_ms']:.5f} ms, plain "
          f"{t_ssd['plain_ms']:.5f} ms; {flops / 1e9:.4f} GFLOP with "
          f"C.B^T once per group, {flops / t_ssd['ms'] / 1e9:.3f} TFLOP/s; "
          f"bound {t_ssd['bound_ms']:.6f} ms ({t_ssd['bound_by']}, bf16 "
          f"tensor cores at {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s, "
          f"{nbytes / 1e6:.3f} MB at {PEAK_BYTES_PER_S / 1e12:g} TB/s); "
          f"former bound {t_ssd['bound_f32_ms']:.6f} ms ({by_f32}, "
          f"{flops_per_head / 1e9:.4f} GFLOP with C.B^T once per head at "
          f"the f32 rate) on {card}")
    for name, ms in t.items():
        print(f"[time] ssd_chunk {name}: device {ms:.5f} ms "
              f"({ms / t['bf16']:.3f}x the bf16 launch) on {card}")
    t_ssd["f32_instance_ms"] = t["f32 instance"]

    keys = ("ms", "call_ms", "plain_ms", "library_ms", "flops", "bytes")
    t_conv = dict.fromkeys(keys, 0.0)
    for lay, x, w in conv_data:
        o_h, o_w = lay.i_h - lay.k_h + 1, lay.i_w - lay.k_w + 1
        xn = x.permute(0, 3, 1, 2).contiguous()
        wn = w.permute(3, 2, 0, 1).contiguous()
        run = (lambda x=x, w=w: iw.im2win_conv_cuda(x, w))
        t = {"ms": device_ms(run, iters=20), "call_ms": call_ms(run, 20),
             "plain_ms": call_ms(lambda x=x, w=w: iw.im2win_conv_plain(x, w),
                                 20),
             "library_ms": device_ms(lambda xn=xn, wn=wn: F.conv2d(xn, wn),
                                     iters=50),
             "flops": 2.0 * BATCH * o_h * o_w * lay.oc * lay.k_h * lay.k_w
             * lay.ic,
             "bytes": 4.0 * (x.numel() + w.numel()
                             + BATCH * o_h * o_w * lay.oc)}
        for k in keys:
            t_conv[k] += t[k]
        bound, by = bound_ms(t["flops"], t["bytes"])
        print(f"[time] im2win_conv {lay.name} batch {BATCH}: device "
              f"{t['ms']:.5f} ms, per call {t['call_ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms, F.conv2d {t['library_ms']:.5f} ms, "
              f"bound {bound:.6f} ms ({by}) on {card}")
    t_conv["bound_ms"], t_conv["bound_by"] = bound_ms(t_conv["flops"],
                                                      t_conv["bytes"])
    return {"ssd_chunk": t_ssd, "im2win_conv": t_conv}


def ssd_conv_phases(dev, card: str) -> list:
    """Phases 10-13; returns ssd_chunk's and im2win_conv's rows of the
    kernels line."""
    ssd_err = ssd_kernel_checks(dev)
    conv_launches, conv_err, conv_data, conv_grid = conv_path(dev)
    mamba_launches = mamba_phase(dev, card)
    ops_phase(dev, card)
    times = time_new_kernels(conv_data, dev, card)
    timing = ("ms, library_ms: device time, stream held; call_ms, plain_ms: "
              "per call incl. host")
    rows = []
    for name, launches, err, path, shape, site in (
            ("ssd_chunk", mamba_launches, ssd_err,
             "launch.serve.generate mamba2-130m batch 4 prompt 2048 gen 32 "
             "(one prefill; decode runs no kernel)",
             "one block's prefill, bf16: (B,S,H,P,N,L)=(4,2048,24,64,128,"
             "256), G=1; library_ms null: no single PyTorch call computes "
             "the masked-decay product and the chunk states", SSD_SITE),
            ("im2win_conv", conv_launches, conv_err,
             "ops.conv2d over cnn8 + Inception 5x5 layers at batch 8",
             "the 14 layers at batch 8, summed; one cluster per grid step",
             IM2WIN_SITE)):
        t = times[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": site,
            "launches": launches, "path": path, "max_abs_err": err,
            "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shapes": shape, "timing": timing})
    # ssd_chunk: the former bound (f32 rate, C.B^T once per head) and the
    # f32 instance's time beside the bf16 launch's
    rows[0].update({k: times["ssd_chunk"][k] for k in
                    ("bound_f32_ms", "f32_instance_ms")})
    # the path's grid steps (== n_cycles), blocks (== steps x cluster) and
    # each layer's cluster, in layer order
    rows[-1].update(conv_grid)
    return rows


#: the training phases: the plan trainer's batch and accumulation, its
#: steps on cnn8 and densenet40, and the Table II proxy's steps
TRAIN_BATCH, TRAIN_ACCUM = 32, 2
TRAIN_STEPS = {"cnn8": 6, "densenet40": 4}
TABLE2_STEPS = 150
#: gradients on the card vs F.conv2d's (TF32 off), relative to max|g|
GRAD_RTOL = 1e-4
#: cnn8's plan trainer on the card vs the same run on the CPU: the first
#: step's gradients relative to max|g|, per-step losses relative (Adam
#: turns rounding-level gradient differences into updates of up to lr)
TRAIN_GRAD_RTOL, TRAIN_LOSS_RTOL = 1e-4, 1e-3
#: densenet40's losses with remat off and with remat auto
REMAT_LOSS_RTOL = 1e-6


def _grads(fn, x, k):
    """(dL/dx, dL/dk) of L = sum(fn(x, k)**2)."""
    import torch
    x, k = x.clone().requires_grad_(True), k.clone().requires_grad_(True)
    return torch.autograd.grad((fn(x, k) ** 2).sum(), (x, k))


def grad_phase(dev, card: str) -> None:
    """Phase 14a: cim_conv2d's and mapped_conv2d's gradients on the card
    against F.conv2d autograd (pruned channels' kernel gradient zeroed:
    the executors skip them) on cnn8's six layers (the serving mapping,
    and the 64x64 one whose border windows write positions twice) and
    DN40-b2l3 at batch 8; a kernel that requires grad is refused by the
    sdk entry, and train_plan refuses the served cnn8 mapping's auto plan
    (five sdk layers).  Then the serving cost of one writer per output
    position on the served CNN8-2, the one layer the cnn8 serving plan
    runs on cim_conv2d (:func:`scatter_cost`)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import types
    from repro_torch.cnn import cim_conv2d, mapped_conv2d
    from repro_torch.cnn.mapped_net import zero_pruned_kernels
    from repro_torch.cnn.train import train_plan
    from repro_torch.core import ArrayConfig, MacroGrid, map_net, networks
    from repro_torch.kernels import sdk_conv as sk
    from repro_torch.launch import serve_cnn
    reset_all_counts()
    arr = ArrayConfig(512, 512)
    cnn8, _ = serve_cnn.map_for_serving("cnn8", arr, "TetrisG-SDK")
    cnn8_g8 = map_net("cnn8", networks.cnn8(), ArrayConfig(64, 64),
                      "TetrisG-SDK", MacroGrid(1, 1), groups=(1, 2, 4, 8))
    dn40, _ = serve_cnn.map_for_serving("densenet40", arr, "TetrisG-SDK")
    cases = ([("512x512", m) for m in cnn8.layers]
             + [("64x64 G<=8", m) for m in cnn8_g8.layers]
             + [("512x512", next(m for m in dn40.layers
                                 if m.layer.name == "DN40-b2l3"))])
    rng = np.random.RandomState(SEED)
    worst = 0.0
    for label, m in cases:
        x, k = layer_data(m, rng, dev)
        lay = m.layer
        want = _grads(lambda x, k: F.conv2d(
            x, k.permute(3, 2, 0, 1), stride=lay.stride, groups=m.group),
            x, k)
        # the executors skip pruned channels: no gradient reaches them
        one = types.SimpleNamespace(layers=(m,))
        want = (want[0], zero_pruned_kernels(one, [want[1]])[0])
        errs = []
        for fn in (cim_conv2d, mapped_conv2d):
            got = _grads(lambda x, k: fn(m, x, k), x, k)
            errs += [max_err(a, b)[1] for a, b in zip(got, want)]
        torch.cuda.synchronize()
        worst = max(worst, *errs)
        print(f"[grad] {lay.name:10s} {label:10s} G={m.group}: cim dx "
              f"{errs[0]:.2e} dk {errs[1]:.2e}, mapped dx {errs[2]:.2e} dk "
              f"{errs[3]:.2e} of max|g| vs F.conv2d (tol {GRAD_RTOL:g})")
        if max(errs) > GRAD_RTOL:
            raise AssertionError(f"{lay.name} {label}: executor gradients "
                                 f"disagree with F.conv2d's")
    m = cnn8.layers[1]
    x, k = layer_data(m, rng, dev)
    try:
        sk.sdk_conv(m, x, k.requires_grad_(True))
    except RuntimeError as e:
        print(f"[grad] sdk_conv with a kernel that requires grad: {e}")
    else:
        raise AssertionError("sdk_conv accepted a kernel that requires grad")
    try:
        train_plan(cnn8, steps=1, batch=TRAIN_BATCH, executor_policy="auto",
                   device=dev)
    except ValueError as e:
        print(f"[grad] train_plan(executor_policy='auto') on the served "
              f"cnn8 mapping: {e}")
    else:
        raise AssertionError("train_plan trained through sdk layers")
    print(f"[grad] {len(cases)} layers x 2 executors, worst {worst:.2e} of "
          f"max|g|")
    scatter_cost(cnn8.layers[0], dev, card)
    counts = launch_counts()
    print(f"[grad] kernel launches over phase 14a: {counts}")
    if any(counts.values()):
        raise AssertionError("the gradient checks launched a kernel")


def _every_write(layer, tile):
    """Every window's every write, duplicates included: the executors'
    scatter before they kept one writer per output position."""
    import numpy as np
    from repro_torch.cnn import cim_conv
    out = []
    for (ph, pw), origins in cim_conv.placement_groups(layer, tile).items():
        s = layer.stride
        oy, ox = np.broadcast_arrays(*cim_conv.scatter_indices(
            origins, (ph - layer.k_h) // s + 1, (pw - layer.k_w) // s + 1, s))
        out.append((np.arange(oy.size), oy.reshape(-1), ox.reshape(-1)))
    return tuple(out)


def scatter_cost(m, dev, card: str) -> None:
    """The serving cost of one writer per output position: cim_conv2d's
    forward on ``m`` at batch 8 with the kept writes and with every
    window's write, in interleaved rounds (medians): the device time of
    one call under torch.profiler, and the time per call.  The forward
    copies its index tensors from the host on every call, so the stream
    cannot be held (``device_ms``) while it enqueues."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cnn import cim_conv
    x, k = layer_data(m, np.random.RandomState(SEED), dev)
    kept = cim_conv.kept_writes

    def every():
        cim_conv.kept_writes = _every_write
        try:
            return cim_conv.cim_conv2d(m, x, k)
        finally:
            cim_conv.kept_writes = kept

    def device_time(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    fns = {"kept": lambda: cim_conv.cim_conv2d(m, x, k), "every": every}
    dev_t = {n: [] for n in fns}
    call = {n: [] for n in fns}
    for _ in range(ROUNDS):
        for n, f in fns.items():
            dev_t[n].append(device_time(f))
            call[n].append(call_ms(f, 50))
    med = {n: (sorted(dev_t[n])[ROUNDS // 2], sorted(call[n])[ROUNDS // 2])
           for n in fns}
    n = sum(len(o) for t in m.tiles
            for o in cim_conv.placement_groups(m.layer, t).values())
    print(f"[grad] scatter cost, cim_conv2d {m.layer.name} batch {BATCH} "
          f"({n} windows; medians of {ROUNDS} interleaved rounds): device "
          f"{med['kept'][0]:.5f} ms a call with one writer per position vs "
          f"{med['every'][0]:.5f} ms with every write; per call "
          f"{med['kept'][1]:.5f} vs {med['every'][1]:.5f} ms on {card}")


def _step_stats(name: str, remat, dev, card: str, step_ms: float) -> dict:
    """One more optimizer step of ``name``'s plan trainer on the card: the
    device's peak allocation over it (above what was allocated before)
    and its busy share under torch.profiler."""
    import torch
    from repro_torch.cnn.train import _make_step, plan_training
    from repro_torch.launch.train import plan_net_mapping
    from repro_torch.optim import adamw_init
    tr = plan_training(plan_net_mapping(name), batch=TRAIN_BATCH,
                       accum=TRAIN_ACCUM, remat=remat, device=dev)
    step = _make_step(tr.loss_sum, 1e-3)
    params, opt = tr.params, adamw_init(tr.params)
    params, opt, _ = step(params, opt, *tr.batch_at(0))      # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(params, opt, *tr.batch_at(1))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    profile_call(f"{name} remat={remat} one train step (batch "
                 f"{TRAIN_BATCH}, accum {TRAIN_ACCUM})",
                 lambda: step(params, opt, *tr.batch_at(1)), step_ms)
    return {"peak_mb": peak / 1e6, "above_mb": (peak - base) / 1e6,
            "est_mb": tr.plan.peak_bytes / 1e6,
            "unremat_mb": tr.plan.unremat_peak_bytes / 1e6,
            "segments": len(tr.plan.spans)}


def _train_cli(name: str, remat: str, device: str):
    """``launch.train --plan-net`` as a user runs it; returns its result,
    losses and step seconds."""
    from repro_torch.launch import train
    return train.main(["--plan-net", name, "--remat", remat, "--steps",
                       str(TRAIN_STEPS[name]), "--batch", str(TRAIN_BATCH),
                       "--accum", str(TRAIN_ACCUM), "--seed", str(SEED),
                       "--device", device])


def _first_step_grads(name: str, device: str) -> list:
    """The first optimizer step's gradients of ``name``'s plan trainer."""
    from repro_torch.cnn.train import _accum_grads, plan_training
    from repro_torch.launch.train import plan_net_mapping
    from repro_torch.optim import tree_leaves
    tr = plan_training(plan_net_mapping(name), batch=TRAIN_BATCH,
                       accum=TRAIN_ACCUM, device=device)
    _, g = _accum_grads(tr.loss_sum, tr.params, *tr.batch_at(0))
    return tree_leaves(g)


def train_phase(dev, card: str) -> None:
    """Phase 14b: the plan trainer at full width through ``launch.train
    --plan-net`` (module docstring), every launch count 0 after it."""
    import statistics
    import numpy as np
    import torch
    reset_all_counts()
    runs = {}
    for name, remat in (("cnn8", "off"), ("densenet40", "off"),
                        ("densenet40", "auto")):
        t0 = time.perf_counter()
        r, losses, secs = _train_cli(name, remat, dev.type)
        wall = time.perf_counter() - t0
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name} remat={remat}: a loss is not "
                                 f"finite: {losses}")
        step_ms = statistics.median(secs[1:]) * 1e3
        st = _step_stats(name, None if remat == "off" else remat, dev, card,
                         step_ms)
        runs[(name, remat)] = (r, losses, st)
        print(f"[train] {name} remat={remat} batch {TRAIN_BATCH} accum "
              f"{TRAIN_ACCUM}: {len(losses)} steps in {wall:.3f} s; step "
              f"{step_ms:.4f} ms (median after the first, first "
              f"{secs[0] * 1e3:.4f} ms), {TRAIN_BATCH / step_ms * 1e3:.1f} "
              f"images/s; losses {losses}; measured peak {st['peak_mb']:.1f}"
              f" MB ({st['above_mb']:.1f} MB above the step's start) vs "
              f"estimate peak_mb {r.peak_mb:.1f} / unremat_peak_mb "
              f"{r.unremat_peak_mb:.1f}; {r.segments} segment(s) on {card}")
    # cnn8: the same run on the CPU
    g_card = _first_step_grads("cnn8", dev.type)
    g_cpu = _first_step_grads("cnn8", "cpu")
    errs = [max_err(a.cpu(), b)[1] for a, b in zip(g_card, g_cpu)]
    _, cpu_losses, _ = _train_cli("cnn8", "off", "cpu")
    card_losses = runs[("cnn8", "off")][1]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    print(f"[train] cnn8 card vs CPU: first-step gradients within "
          f"{max(errs):.2e} of max|g| (tol {TRAIN_GRAD_RTOL:g}); per-step "
          f"losses within {rel:.2e} relative (tol {TRAIN_LOSS_RTOL:g}); CPU "
          f"losses {cpu_losses}")
    if max(errs) > TRAIN_GRAD_RTOL or rel > TRAIN_LOSS_RTOL:
        raise AssertionError("cnn8's plan trainer on the card disagrees with "
                             "the CPU")
    # densenet40: remat off vs auto
    off, auto = runs[("densenet40", "off")], runs[("densenet40", "auto")]
    rel = max(abs(a - b) / abs(a) for a, b in zip(off[1], auto[1]))
    again = _train_cli("densenet40", "off", dev.type)[1]
    why = "" if off[1] == again else (
        " (the patch gather's backward, index_put_ with accumulate, and "
        "index_select's, index_add_, sum with atomics on CUDA)")
    print(f"[train] densenet40 remat off vs auto: losses within {rel:.2e} "
          f"relative (tol {REMAT_LOSS_RTOL:g}), bitwise {off[1] == auto[1]};"
          f" remat off run twice bitwise {off[1] == again}{why}; "
          f"{auto[0].segments} segments; measured step peak "
          f"{off[2]['above_mb']:.1f} -> "
          f"{auto[2]['above_mb']:.1f} MB above the step's start, estimate "
          f"{off[0].peak_mb:.1f} -> {auto[0].peak_mb:.1f} MB")
    if rel > REMAT_LOSS_RTOL:
        raise AssertionError("densenet40's losses move with remat")
    if not (auto[2]["peak_mb"] < off[2]["peak_mb"]
            and auto[2]["above_mb"] < off[2]["above_mb"]):
        raise AssertionError("remat auto did not lower the measured peak")
    counts = launch_counts()
    print(f"[train] kernel launches over the training phases: {counts}")
    if any(counts.values()):
        raise AssertionError("the training path launched a kernel")


def table2_phase(dev, card: str) -> None:
    """Phase 14c: the Table II proxy, train_cnn through the mapped
    executor at G = 1, 2, 4; finite losses gate, accuracy is printed."""
    import math
    from repro_torch.cnn.models import cnn8_config
    from repro_torch.cnn.train import train_cnn
    reset_all_counts()
    t0 = time.perf_counter()
    for g in (1, 2, 4):
        t1 = time.perf_counter()
        r = train_cnn(cnn8_config(group=g), steps=TABLE2_STEPS,
                      n_train=1024, n_test=256, executor="mapped",
                      device=dev)
        ms = (time.perf_counter() - t1) / TABLE2_STEPS * 1e3
        print(f"[table2] cnn8-g{g} mapped {TABLE2_STEPS} steps batch 64: "
              f"final loss {r.final_loss:.4f}, train_acc {r.train_acc:.4f}, "
              f"test_acc {r.test_acc:.4f}; {ms:.4f} ms/step (the call's "
              f"wall time over its steps: draws and accuracy included) on "
              f"{card}")
        if not math.isfinite(r.final_loss):
            raise AssertionError(f"Table II proxy G={g}: loss not finite")
    counts = launch_counts()
    print(f"[table2] {time.perf_counter() - t0:.1f} s; kernel launches "
          f"{counts}")
    if any(counts.values()):
        raise AssertionError("the Table II proxy launched a kernel")


#: phase 15, arrival-driven serving: cnn8's dynamic runs (max batch 8,
#: requests of 1-4 rows), the fleet (max batch 4, 48 requests at 200/s,
#: a 50 ms queue-delay SLO) with whisper-base at full width, and two
#: spawned replicas (max batch 4, 48 backlogged requests)
DYN_ARGS = ["--net", "cnn8", "--policy", "auto", "--max-batch", "8",
            "--max-delay-ms", "2", "--max-request", "4", "--requests", "64",
            "--warmup", "1", "--seed", str(SEED)]
# the fixed and the adaptive delay backlogged twice each, interleaved, so
# the spread between two runs of one policy stands beside their difference
DYN_RUNS = (("backlogged", ["--arrival-rate", "0"]),
            ("500/s", ["--arrival-rate", "500"]),
            ("backlogged, adaptive delay", ["--arrival-rate", "0",
                                            "--adaptive-delay"]),
            ("backlogged, repeat", ["--arrival-rate", "0"]),
            ("backlogged, adaptive delay, repeat", ["--arrival-rate", "0",
                                                    "--adaptive-delay"]))
FLEET_NETS = ("cnn8", "inception", "densenet40")
FLEET_WHISPER = ("whisper_base", 1024)
FLEET_MAX_BATCH, FLEET_REQUESTS, FLEET_RATE, FLEET_SLO_MS = 4, 48, 200.0, 50.0
REPLICA_ARGS = ["--net", "cnn8", "--replicas", "2", "--max-batch", "4",
                "--max-delay-ms", "2", "--requests", "48", "--policy",
                "auto", "--warmup", "1", "--seed", str(SEED)]
SERVED_KERNELS = ("sdk_whole", "sdk_window", "tetris_matmul",
                  "grouped_matmul", "flash_attention")


def expected_launches(served: dict) -> dict:
    """Sum over ``{plan: forwards}`` of the plan's launches a forward
    (`NetworkPlan.launches_per_forward`)."""
    total = dict.fromkeys(SERVED_KERNELS, 0)
    for plan, forwards in served.items():
        for k, n in plan.launches_per_forward().items():
            total[k] += forwards * n
    return total


def check_served(label: str, served: dict) -> dict:
    """The launches counted since the last reset against the plans'
    prediction; returns the counted launches of the served kernels."""
    counts = launch_counts()
    got = {k: counts[k] for k in SERVED_KERNELS}
    want = expected_launches(served)
    print(f"[serve] {label}: launches {got}, predicted from the tier plans "
          f"{want}")
    if got != want or any(counts[k] for k in counts
                          if k not in SERVED_KERNELS):
        raise AssertionError(f"{label}: the served launches {counts} differ "
                             f"from the tier plans' {want}")
    return got


def dynamic_phase(cnn8, dev, card: str) -> dict:
    """Phase 15a: ``serve_cnn.main --max-delay-ms`` on cnn8 (policy auto),
    backlogged, at 500 requests/s and backlogged with the adaptive delay,
    then backlogged with each delay policy again;
    every request served once, the launches of each run equal to the
    tier plans' over its batches (warm-up included), pad-and-mask held
    to the oracle at each tier served, and the backlogged run's busy
    share.  Returns the backlogged run's launches."""
    import torch
    from repro_torch.exec import compile_plan, execute_oracle, execute_plan
    from repro_torch.launch import serve_cnn
    first = None
    used = set()
    for label, extra in DYN_RUNS:
        reset_all_counts()
        s = serve_cnn.main(DYN_ARGS + extra)
        rate = float(extra[1])
        trace = serve_cnn.poisson_arrivals(64, rate, 4, seed=SEED)
        if s.request_images != sum(r for _, r in trace):
            raise AssertionError(f"dynamic {label}: {s.request_images} "
                                 f"images served of the trace's "
                                 f"{sum(r for _, r in trace)}")
        warm = s.warmup_steps // len(s.tiers)
        plans = {t: compile_plan(cnn8, executor_policy="auto", batch=t,
                                 device=dev) for t in s.tiers}
        got = check_served(f"dynamic cnn8 {label}", {
            plans[t]: ts.batches + warm for t, ts in s.tiers.items()})
        for t, ts in sorted(s.tiers.items()):
            if ts.batches:
                used.add(t)
                print(f"[serve] dynamic cnn8 {label} tier {t}: {ts.batches} "
                      f"batches, exec_s {ts.exec_s / ts.batches * 1e3:.4f} ms"
                      f" a batch, {ts.request_images}/{ts.padded_images} "
                      f"images on {card}")
        print(f"[serve] dynamic cnn8 {label}: {s.images_per_s:.1f} images/s"
              f" ({s.padded_images_per_s:.1f} padded), queue delay p50 "
              f"{s.delay_ms(50):.4f} p95 {s.delay_ms(95):.4f} p99 "
              f"{s.delay_ms(99):.4f} ms, wall {s.wall_s * 1e3:.3f} ms on "
              f"{card}")
        if first is None:
            first = (s, got)
    # pad-and-mask on the card: a tier's forward on a zero-padded input
    # keeps its request rows
    ks, xh = serve_cnn.serving_inputs(cnn8, 8, SEED, dev)
    any_batch = compile_plan(cnn8, executor_policy="auto", device=dev)
    for t in sorted(used):
        rows = max(1, t - 1)
        x = torch.zeros((t,) + xh.shape[1:], device=dev)
        x[:rows] = torch.as_tensor(xh[:rows], device=dev)
        plan = compile_plan(cnn8, executor_policy="auto", batch=t,
                            device=dev)
        y = execute_plan(plan, ks, x)[:rows]
        r = execute_oracle(any_batch, ks, x[:rows])
        torch.cuda.synchronize()
        err, rel, scale = max_err(y, r)
        print(f"[serve] pad-and-mask tier {t}: {rows} request rows of a "
              f"zero-padded forward vs the oracle on those rows, "
              f"max_abs_err={err:.3e} rel={rel:.3e} (tol {FORWARD_RTOL:g} "
              f"of max|y|={scale:.3f})")
        if not (bool(torch.isfinite(y).all()) and rel <= FORWARD_RTOL):
            raise AssertionError(f"tier {t}: padded rows leak into the "
                                 f"request rows")
    s, got = first
    reqs = serve_cnn.poisson_arrivals(64, 0.0, 4, seed=SEED)
    profile_call("dynamic cnn8 backlogged (64 requests)",
                 lambda: serve_cnn.serve_dynamic(
                     cnn8, reqs, max_batch=8, max_delay_ms=2.0,
                     policy="auto", warmup=0, seed=SEED, device=dev),
                 s.wall_s * 1e3, "sdk_whole")
    return got


def fleet_phase(dev, card: str) -> dict:
    """Phase 15b: ``fleet.serve_fleet`` as ``serve_cnn --fleet`` builds it
    — cnn8, Inception's chainable prefix, DenseNet40 and the whisper-base
    encoder at full width, policy auto, shared constants: every request
    served once, launches equal to the tier plans' over the served
    batches (warm-up included), one constants materialization per
    network, and the schedule on a fake clock equal to the one a CPU-only
    process builds.  Then cnn8 alone under ``--policy mapped`` with and
    without shared constants (the constants path, no kernel), and the
    constants-fed forward bitwise the plain one.  Returns the launches."""
    import dataclasses
    import os
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import ArrayConfig, memo
    from repro_torch.exec import (compile_plan, constant_counts,
                                  execute_plan, prepare_constants)
    from repro_torch.launch import batching, fleet, serve_cnn
    from repro_torch.launch.transformer import transformer_mapping
    arr = ArrayConfig(512, 512)
    mappings, dropped, _ = serve_cnn.fleet_mappings(FLEET_NETS, arr,
                                                    "TetrisG-SDK")
    name, seq = FLEET_WHISPER
    mappings[name] = transformer_mapping(get_config(name), seq=seq,
                                         array=arr)
    dropped[name] = 0
    names = list(mappings)
    config = fleet.FleetConfig(models=tuple(
        fleet.ModelSpec(n, max_batch=FLEET_MAX_BATCH, max_delay_s=2e-3,
                        slo_ms=FLEET_SLO_MS) for n in names))
    trace = fleet.mixed_poisson_trace(names, FLEET_REQUESTS, FLEET_RATE,
                                      FLEET_MAX_BATCH, seed=SEED)
    st = memo.snapshot()
    reset_all_counts()
    t0 = time.perf_counter()
    stats, _ = fleet.serve_fleet(mappings, config, trace, policy="auto",
                                 warmup=1, seed=SEED, dropped_layers=dropped,
                                 device=dev)
    print(f"[serve] fleet {'/'.join(names)}: served in "
          f"{time.perf_counter() - t0:.3f} s with set-up (ladders, weights "
          f"and warm-up)")
    serve_cnn._print_fleet(stats, tag="none", max_batch=FLEET_MAX_BATCH,
                           max_delay_ms=2.0, st=st)
    if stats.request_images != sum(r for _, _, r in trace):
        raise AssertionError("the fleet did not serve every request once")
    served = {}
    for n in names:
        for t in batching.batch_tiers(FLEET_MAX_BATCH):
            plan = compile_plan(mappings[n], executor_policy="auto",
                                batch=t, device=dev)
            ts = stats.models[n].tiers.get(t)
            served[plan] = 1 + (ts.batches if ts else 0)
    got = check_served("fleet", served)
    exec_total = 0.0
    for n in names:
        ms = stats.models[n]
        ex = sum(t.exec_s for t in ms.tiers.values())
        exec_total += ex
        toks = ("" if ms.request_tokens is None else
                f", {ms.request_tokens / stats.wall_s:.1f} tokens/s")
        ds = ms.delays_s
        print(f"[serve] fleet {n}: {ms.batches} batches, exec_s "
              f"{ex / max(ms.batches, 1) * 1e3:.4f} ms a batch "
              f"(tiers {sorted(ms.tiers)}), "
              f"{ms.request_images / stats.wall_s:.1f} images/s "
              f"({ms.padded_images / stats.wall_s:.1f} padded){toks}, queue "
              f"delay p50 {batching.percentile(ds, 50) * 1e3:.4f} p95 "
              f"{batching.percentile(ds, 95) * 1e3:.4f} p99 "
              f"{batching.percentile(ds, 99) * 1e3:.4f} ms, SLO "
              f"{FLEET_SLO_MS:g} ms attained {ms.slo_attainment:.3f} on "
              f"{card}")
        cc = constant_counts(net=mappings[n])
        if list(cc.values()) != [1]:
            raise AssertionError(f"{n}: constants materialized {cc}, not "
                                 f"once for its {len(ms.tiers)} tiers")
    print(f"[serve] fleet wall {stats.wall_s * 1e3:.3f} ms, sum of the "
          f"models' exec_s {exec_total * 1e3:.3f} ms; constants one "
          f"materialization per network")
    # a served whisper-base batch as the fleet runs it: the padded host
    # batch uploaded (8 MB at tier 4), then the forward
    wb = stats.models[name].tiers
    tier = max(wb)
    ks, xh = serve_cnn.serving_inputs(mappings[name], tier, SEED, dev)
    plan = compile_plan(mappings[name], executor_policy="auto", batch=tier,
                        device=dev)
    profile_call(f"fleet {name} tier-{tier} batch (upload + forward)",
                 lambda: execute_plan(plan, ks,
                                      torch.as_tensor(xh, device=dev)),
                 wb[tier].exec_s / wb[tier].batches * 1e3, "Memcpy")
    # the upload alone, on the host clock and under the profiler
    t0 = time.perf_counter()
    torch.as_tensor(xh, device=dev)
    torch.cuda.synchronize()
    profile_call(f"fleet {name} tier-{tier} upload alone ({xh.nbytes} "
                 f"bytes, pageable)", lambda: torch.as_tensor(xh, device=dev),
                 (time.perf_counter() - t0) * 1e3, "Memcpy")
    # the schedule, on a fake clock, here and in a process with no card
    vclk = batching.VClock()
    here = [dataclasses.astuple(r) for r in fleet.run_fleet(
        fleet.FleetScheduler(config), trace, clock=vclk, sleep=vclk.sleep)]
    code = ("import sys, json, dataclasses\n"
            "from repro_torch.launch import batching, fleet\n"
            f"cfg = fleet.FleetConfig(models=tuple(fleet.ModelSpec(n, "
            f"max_batch={FLEET_MAX_BATCH}, max_delay_s=2e-3, slo_ms="
            f"{FLEET_SLO_MS}) for n in {names!r}))\n"
            f"tr = fleet.mixed_poisson_trace({names!r}, {FLEET_REQUESTS}, "
            f"{FLEET_RATE}, {FLEET_MAX_BATCH}, seed={SEED})\n"
            "c = batching.VClock()\n"
            "print(repr([dataclasses.astuple(r) for r in fleet.run_fleet("
            "fleet.FleetScheduler(cfg), tr, clock=c, sleep=c.sleep)]))\n"
            "assert 'torch' not in sys.modules\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(SRC))
    cpu = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    same = repr(here) == cpu.strip()
    print(f"[serve] fleet schedule on a fake clock: {len(here)} launches, "
          f"equal to a CPU-only process's (no torch imported there): {same}")
    if not same:
        raise AssertionError("the fleet schedule depends on the process")
    # the constants path: cnn8 under the mapped executor
    for share in (True, False):
        serve_cnn.main(["--fleet", "cnn8", "--policy", "mapped",
                        "--max-batch", "4", "--max-delay-ms", "2",
                        "--requests", "16", "--arrival-rate", "200",
                        "--slo-ms", str(FLEET_SLO_MS), "--warmup", "1",
                        "--seed", str(SEED)]
                       + ([] if share else ["--no-share-constants"]))
    cnn8 = mappings["cnn8"]
    plan = compile_plan(cnn8, executor_policy="mapped", batch=4, device=dev)
    ks, xh = serve_cnn.serving_inputs(cnn8, 4, SEED, dev)
    x = torch.as_tensor(xh, device=dev)
    c = prepare_constants(plan, ks)
    y_on = execute_plan(plan, ks, x, constants=c)
    y_off = execute_plan(plan, ks, x)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(y_on, y_off))
    print(f"[serve] cnn8 mapped batch 4: execute_plan(constants=) bitwise "
          f"the forward without them: {bitwise}")
    if not bitwise:
        raise AssertionError("the constants-fed forward differs")
    return got


def replica_phase(card: str) -> None:
    """Phase 15c: ``serve_cnn.main --replicas 2`` behind a disk cache
    warmed here, once plain and once with worker 1 killed: every request
    served exactly once.  The kernels were built in phase 2, so the
    workers' start-up measures mapping and loading."""
    import shutil
    import tempfile
    from repro_torch.core import ArrayConfig, memo
    from repro_torch.launch import batching, serve_cnn
    cache = tempfile.mkdtemp(prefix="chip-smoke-cache-")
    try:
        memo.set_disk_cache(cache)
        memo.clear()                    # so the warm-up writes the disk
        cnn8, _ = serve_cnn.map_for_serving("cnn8", ArrayConfig(512, 512),
                                            "TetrisG-SDK")
        batching.PlanLadder(cnn8, batching.batch_tiers(4), policy="auto")
        trace = serve_cnn.poisson_arrivals(48, 0.0, 4, seed=SEED)
        for kill in (None, 1):
            extra = [] if kill is None else ["--kill-worker", str(kill)]
            t0 = time.perf_counter()
            rs = serve_cnn.main(REPLICA_ARGS + ["--cache-dir", cache]
                                + extra)
            wall = time.perf_counter() - t0
            ok = (rs.request_images == sum(r for _, r in trace)
                  and sum(v.served_requests for v in rs.workers.values())
                  == len(trace) and rs.duplicate_serves == 0
                  and rs.deaths == (kill is not None)
                  and (kill is None or rs.requeued > 0))
            print(f"[serve] replicas kill={kill}: " + "; ".join(
                f"w{w} start-up {v.startup_s * 1e3:.1f} ms table_builds "
                f"{v.table_misses} disk_hits {v.disk_hits}"
                for w, v in sorted(rs.workers.items()))
                + f"; deaths {rs.deaths} requeued {rs.requeued} duplicates "
                f"{rs.duplicate_serves}; {rs.images_per_s:.1f} images/s over "
                f"{rs.wall_s * 1e3:.3f} ms of serving, {wall:.3f} s with "
                f"start-up on {card}")
            if not ok:
                raise AssertionError(f"replicas kill={kill}: not every "
                                     f"request served exactly once")
    finally:
        memo.set_disk_cache(None)
        shutil.rmtree(cache, ignore_errors=True)


def serving_phase(cnn8, dev, card: str) -> dict:
    """Phase 15: arrival-driven serving.  Returns {kernel: {run:
    launches}} for the kernels line."""
    got = {"dynamic": dynamic_phase(cnn8, dev, card),
           "fleet": fleet_phase(dev, card)}
    replica_phase(card)
    return {k: {run: n[k] for run, n in got.items()} for k in SERVED_KERNELS}


#: phase 16, the autotuner: cnn8 at the served width and batch, over the
#: choices the card really has (lookahead is inert in the port, so one
#: value); the ragged profile's requests (64 of 1-4 rows, backlogged)
TUNE_LOOKAHEADS, TUNE_BLOCKS = (1,), ("auto", "whole", "window")
TUNE_REQUESTS, TUNE_MAX_ROWS, TUNE_DELAY_MS = 64, 4, 2.0
TUNE_LINE = re.compile(r"^autotune: .*\[(cache|search \((\d+) measured "
                       r"steps\))\]$", re.M)


def search_launches(net, res, budget, batch: int, dev) -> dict:
    """The launches a fixed-profile search makes: each trial's rounds
    plus its warm-up, times its candidate plan's launches a forward."""
    from repro_torch.exec import compile_plan
    from repro_torch.tune import search
    chained = search._chains(net)
    total = dict.fromkeys(SERVED_KERNELS, 0)
    for t in res.trials:
        c = t.candidate
        plan = compile_plan(net, executor_policy=c.policy, batch=batch,
                            chained=chained, lookahead=c.lookahead,
                            block=c.block, vmem_budget=c.vmem_budget,
                            remat=c.remat, device=dev)
        for k, n in plan.launches_per_forward().items():
            total[k] += (t.rounds + budget.warmup) * n
    return total


def check_search(label: str, want: dict) -> dict:
    """The launches counted since the last reset against ``want``; only
    the served kernels may have launched."""
    counts = launch_counts()
    got = {k: counts[k] for k in SERVED_KERNELS}
    print(f"[tune] {label}: launches {got}, predicted from the candidate "
          f"plans {want}")
    if got != want or any(counts[k] for k in counts
                          if k not in SERVED_KERNELS):
        raise AssertionError(f"{label}: the search's launches {counts} "
                             f"differ from its candidate plans' {want}")
    return got


def cand_text(c) -> str:
    """A candidate with its per-layer executors spelt out (``describe``
    gives only their set)."""
    rest = c.describe().split(" ", 1)[1]
    return f"[{','.join(e[:3] for e in c.policy)}] {rest}"


def print_search(label: str, net, res, space, budget, seconds: float,
                 dev, card: str) -> None:
    """The shortlist, each stage's medians and the winner against the
    baseline."""
    from repro_torch.tune import baseline_candidate, shortlist
    cfg = res.config
    base = baseline_candidate(net, batch=BATCH, device=dev)
    short = shortlist(net, space, budget.shortlist, baseline=base)
    print(f"[tune] {label}: space {len(space)} candidates, shortlist "
          f"{len(short)}: " + "; ".join(cand_text(c) for c in short))
    for r in sorted({t.rounds for t in res.trials}):
        print(f"[tune] {label} stage of {r} rounds: " + "; ".join(
            f"{cand_text(t.candidate)} {t.median_s * 1e3:.4f} ms"
            for t in res.trials if t.rounds == r))
    print(f"[tune] {label}: winner {cand_text(cfg.candidate)} "
          f"{cfg.median_s * 1e3:.4f} ms vs baseline {cand_text(base)} "
          f"{cfg.baseline_s * 1e3:.4f} ms, speedup {cfg.speedup:.4f}, "
          f"{cfg.rounds} final rounds, {res.measurements} measured steps, "
          f"search {seconds:.3f} s, fleet {cfg.fleet} on {card}")


def winner_forward(label: str, net, cand, batch: int, dev) -> None:
    """The winner's plan forward against ``execute_oracle``."""
    import torch
    from repro_torch.exec import compile_plan, execute_oracle, execute_plan
    from repro_torch.launch import serve_cnn
    plan = compile_plan(net, executor_policy=cand.policy, batch=batch,
                        lookahead=cand.lookahead, block=cand.block,
                        vmem_budget=cand.vmem_budget, device=dev)
    ks, xh = serve_cnn.serving_inputs(net, batch, SEED, dev)
    x = torch.as_tensor(xh, device=dev)
    y = execute_plan(plan, ks, x)
    r = execute_oracle(plan, ks, x)
    torch.cuda.synchronize()
    err, rel, scale = max_err(y, r)
    print(f"[tune] {label}: winner's forward ({'/'.join(plan.executors)}) "
          f"vs the oracle max_abs_err={err:.3e} rel={rel:.3e} (tol "
          f"{FORWARD_RTOL:g} of max|y|={scale:.3f})")
    if not (bool(torch.isfinite(y).all()) and rel <= FORWARD_RTOL):
        raise AssertionError(f"{label}: the winner's forward disagrees with "
                             f"the oracle")


def tune_fixed(cnn8, dev, card: str) -> dict:
    """Phase 16a: two forced fixed-profile searches of cnn8 at batch 8
    over the sdk block modes, with the default budget."""
    from repro_torch import tune
    space = tune.enumerate_space(cnn8, batch=BATCH, device=dev,
                                 lookaheads=TUNE_LOOKAHEADS,
                                 blocks=TUNE_BLOCKS)
    budget = tune.TuneBudget()
    winners, got = [], {}
    for run in (1, 2):
        reset_all_counts()
        t0 = time.perf_counter()
        res = tune.autotune(cnn8, batch=BATCH, device=dev, space=space,
                            budget=budget, seed=SEED, force=True)
        seconds = time.perf_counter() - t0
        label = f"cnn8 fixed batch {BATCH}, search {run}"
        got = check_search(label, search_launches(cnn8, res, budget, BATCH,
                                                  dev))
        print_search(label, cnn8, res, space, budget, seconds, dev, card)
        if res.config.median_s > res.config.baseline_s:
            raise AssertionError(f"{label}: the winner lost to the baseline "
                                 f"in its own rounds")
        winner_forward(label, cnn8, res.config.candidate, BATCH, dev)
        winners.append(res.config.candidate)
    print(f"[tune] cnn8 fixed: the two searches' winners agree: "
          f"{winners[0] == winners[1]} ({cand_text(winners[0])} / "
          f"{cand_text(winners[1])})")
    return got


def tune_ragged(cnn8, dev, card: str) -> dict:
    """Phase 16b: the ragged profile on cnn8 — every measured step one
    backlogged serve_dynamic drain; each drain must serve every request
    once, and the launches equal the tier plans' over its batches."""
    from repro_torch import tune
    from repro_torch.exec import compile_plan
    from repro_torch.launch import serve_cnn
    reqs = serve_cnn.poisson_arrivals(TUNE_REQUESTS, 0.0, TUNE_MAX_ROWS,
                                      seed=SEED)
    sizes = tuple(r for _, r in reqs)
    drains = []
    serve_dynamic = serve_cnn.serve_dynamic

    def recording(net, requests, **kw):     # the runner's own call
        s = serve_dynamic(net, requests, **kw)
        drains.append((s, kw))
        return s
    reset_all_counts()
    serve_cnn.serve_dynamic = recording
    try:
        t0 = time.perf_counter()
        res = tune.autotune(cnn8, batch=BATCH, device=dev, ragged=sizes,
                            max_delay_ms=TUNE_DELAY_MS,
                            budget=tune.SMOKE_BUDGET, seed=SEED, force=True)
        seconds = time.perf_counter() - t0
    finally:
        serve_cnn.serve_dynamic = serve_dynamic
    want = dict.fromkeys(SERVED_KERNELS, 0)
    for s, kw in drains:
        if s.request_images != sum(sizes):
            raise AssertionError(f"a ragged drain served {s.request_images} "
                                 f"of {sum(sizes)} request rows")
        for t, ts in s.tiers.items():
            plan = compile_plan(cnn8, executor_policy=kw["policy"], batch=t,
                                lookahead=kw["lookahead"], block=kw["block"],
                                vmem_budget=kw["vmem_budget"], device=dev)
            for k, n in plan.launches_per_forward().items():
                want[k] += ts.batches * n
    if len(drains) != res.measurements:
        raise AssertionError(f"{len(drains)} drains for {res.measurements} "
                             f"measured steps")
    label = (f"cnn8 ragged ({TUNE_REQUESTS} backlogged requests of 1-"
             f"{TUNE_MAX_ROWS} rows, max batch {BATCH})")
    got = check_search(label, want)
    print(f"[tune] {label}: {len(drains)} drains, each served all "
          f"{sum(sizes)} request rows once")
    print_search(label, cnn8, res, tune.enumerate_space(
        cnn8, batch=BATCH, device=dev, tiers_options=(None, (BATCH,))),
        tune.SMOKE_BUDGET, seconds, dev, card)
    winner_forward(label, cnn8, res.config.candidate, BATCH, dev)
    return got


def tune_layer_set(incep, dev, card: str) -> dict:
    """Phase 16c: Inception's layer set through the execute_layerwise
    runner."""
    from repro_torch import tune
    from repro_torch.tune import search
    if search._chains(incep):
        raise AssertionError("Inception's layer set unexpectedly chains")
    reset_all_counts()
    t0 = time.perf_counter()
    res = tune.autotune(incep, batch=BATCH, device=dev,
                        budget=tune.SMOKE_BUDGET, seed=SEED, force=True)
    seconds = time.perf_counter() - t0
    label = f"inception layer set (layerwise) batch {BATCH}"
    got = check_search(label, search_launches(incep, res, tune.SMOKE_BUDGET,
                                              BATCH, dev))
    print_search(label, incep, res, tune.enumerate_space(
        incep, batch=BATCH, device=dev), tune.SMOKE_BUDGET, seconds, dev,
        card)
    return got


def tune_cli(cnn8, dev, card: str) -> None:
    """Phase 16d: ``serve_cnn --autotune`` in two fresh processes on one
    cache directory (the second measures nothing and builds no search
    table), then ``--policy tuned`` serving the persisted winner."""
    import os
    import shutil
    import tempfile
    from repro_torch import tune
    from repro_torch.core import memo
    from repro_torch.launch import serve_cnn
    cache = tempfile.mkdtemp(prefix="chip-smoke-tune-")
    args = ["--net", "cnn8", "--batch", str(BATCH), "--seed", str(SEED),
            "--cache-dir", cache]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    try:
        outs = []
        for run in (1, 2):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve_cnn",
                 *args, "--autotune"], env=env, check=True,
                capture_output=True, text=True, timeout=300).stdout
            wall = time.perf_counter() - t0
            line = TUNE_LINE.search(out)
            builds = re.search(r"table_builds=(\d+)", out)
            if line is None or builds is None:
                raise AssertionError(f"--autotune run {run} printed no "
                                     f"autotune line:\n{out}")
            print(f"[tune] serve_cnn --autotune process {run} ({wall:.3f} s"
                  f" with start-up): {line.group(0)}; table_builds="
                  f"{builds.group(1)}")
            print("\n".join(f"[tune]   {ln}" for ln in out.splitlines()
                            if ln.startswith(("serve/", "device="))))
            outs.append((line, int(builds.group(1))))
        (first, _), (second, builds2) = outs
        if first.group(1) == "cache" or int(first.group(2)) == 0:
            raise AssertionError("the first --autotune process measured "
                                 "nothing")
        if second.group(1) != "cache" or builds2 != 0:
            raise AssertionError("the second --autotune process did not "
                                 "load the winner from the cache")
        memo.set_disk_cache(cache)
        memo.clear()
        cfg = tune.tuned_config(cnn8, batch=BATCH, device=dev)
        if cfg is None:
            raise AssertionError("no winner persisted for the card's fleet")
        s = serve_cnn.main(args + ["--policy", "tuned", "--steps", "5"])
        blocks = {lp.block for lp in s.plan.layers}
        print(f"[tune] --policy tuned: executors {s.plan.executors}, block "
              f"{blocks}, the winner {cand_text(cfg.candidate)}; "
              f"{s.s_per_batch * 1e3:.4f} ms/batch on {card}")
        if s.plan.executors != cfg.candidate.policy or \
                blocks != {cfg.candidate.block}:
            raise AssertionError("--policy tuned did not serve the winner")
    finally:
        memo.set_disk_cache(None)
        memo.clear()
        shutil.rmtree(cache, ignore_errors=True)


def tune_phase(cnn8, incep, dev, card: str) -> dict:
    """Phase 16.  Returns {kernel: {search: launches}} for the kernels
    line."""
    from repro_torch.core import memo
    t0 = time.perf_counter()
    memo.clear()
    got = {"fixed": tune_fixed(cnn8, dev, card),
           "ragged": tune_ragged(cnn8, dev, card),
           "inception": tune_layer_set(incep, dev, card)}
    memo.clear()
    tune_cli(cnn8, dev, card)
    print(f"[tune] phase 16 in {time.perf_counter() - t0:.3f} s")
    return {k: {run: n[k] for run, n in got.items()}
            for k in ("sdk_whole", "sdk_window")}


def cut_depth(cfg, units: int):
    """``cfg`` at full width with each stage cut to at most ``units``
    units."""
    import dataclasses
    return dataclasses.replace(cfg, stages=tuple(
        dataclasses.replace(st, n_units=min(st.n_units, units))
        for st in cfg.stages))


def time_generate(label: str, cfg, params, prompts, gen: int,
                  prefills: int, card: str, kernel: str = "",
                  enc_embeds=None) -> tuple:
    """``generate`` once (the warm-up; an encoder-decoder's with its
    ``enc_embeds``), then ``prefills`` prefills and gen - 1 decode steps
    timed (host clock, each ending in a synchronize; medians), the peak
    allocation over them, and one prefill and one decode step under
    ``torch.profiler`` (``kernel``: the entries to part out).  Returns
    the launches of the warm-up, of the timed prefills and of the timed
    decode steps; the counts are read, never reset."""
    import statistics
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    batch, prompt = prompts.shape

    def since(before):
        return {k: v - before[k] for k, v in launch_counts().items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, gen, enc_embeds=enc_embeds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = since(before)
    if not (out.shape == (batch, prompt + gen)
            and torch.equal(out[:, :prompt], prompts)
            and int(out.min()) >= 0 and int(out.max()) < cfg.vocab):
        raise AssertionError(f"{label}: generate returned {tuple(out.shape)}"
                             f" tokens outside the vocabulary or the prompt")
    prefill = make_prefill_step(cfg, cache_len=prompt + gen)
    serve = make_serve_step(cfg)
    batch_in = {"tokens": prompts}
    if enc_embeds is not None:
        batch_in["enc_embeds"] = enc_embeds
    before = launch_counts()
    t_pre = []
    for _ in range(prefills):
        t0 = time.perf_counter()
        nxt, cache = prefill(params, batch_in)
        torch.cuda.synchronize()
        t_pre.append(time.perf_counter() - t0)
    n_pre = since(before)
    before = launch_counts()
    tok = nxt[:, None]
    t_dec = []
    for i in range(gen - 1):
        t0 = time.perf_counter()
        tok, cache = serve(params, cache, tok, prompt + i)
        torch.cuda.synchronize()
        t_dec.append(time.perf_counter() - t0)
    n_dec = since(before)
    peak = torch.cuda.max_memory_allocated()
    pre_ms = 1e3 * statistics.median(t_pre)
    dec_ms = 1e3 * statistics.median(t_dec)
    print(f"[generate] {label} batch {batch} prompt {prompt} gen {gen}: "
          f"first call {first_s:.3f} s; prefill {pre_ms:.4f} ms (median of "
          f"{len(t_pre)}; {batch * prompt / pre_ms * 1e3:.1f} tokens/s), "
          f"decode {dec_ms:.4f} ms a token (median of {len(t_dec)} steps, "
          f"{min(t_dec) * 1e3:.4f}-{max(t_dec) * 1e3:.4f}; "
          f"{batch / dec_ms * 1e3:.1f} tokens/s); peak allocation "
          f"{peak / 2**30:.3f} GiB; on {card}")
    # the next step writes at prompt + gen - 1, the cache's last slot
    profile_call(f"{label} prefill", lambda: prefill(params, batch_in),
                 pre_ms, kernel)
    profile_call(f"{label} decode step", lambda: serve(
        params, cache, tok, prompt + gen - 1), dec_ms, kernel)
    return first, n_pre, n_dec


def decoder_prompts(cfg, batch: int, prompt: int, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    return torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                         device=dev)


@contextlib.contextmanager
def last_token_drops(record: list):
    """Append, for each MoE route call in the block, the assignments of
    the chunk's last token that its experts' capacity dropped (one count
    per batch row)."""
    from repro_torch.models import moe
    route = moe.route

    def counting(logits, cfg, cap):
        disp, comb = route(logits, cfg, cap)
        record.append(cfg.top_k - disp[:, -1].sum((-2, -1)))
        return disp, comb

    moe.route = counting
    try:
        yield
    finally:
        moe.route = route


def decoder_consistency(label: str, cfg, params, batch: int, s: int,
                        dev) -> None:
    """The JAX package's ``test_prefill_decode_consistency`` on the card:
    the decode logits at position ``s`` after a prefill of ``s`` tokens
    against the train forward's at ``s``, gated in f32 compute (the conv
    tails kept in f32 too) and printed in bf16 (as served).  A MoE
    model's check holds only if the train forward keeps every expert
    assignment of position ``s`` (a decode token is never dropped): the
    dropped ones are printed per MoE layer, and with any the f32 reading
    is printed, not gated."""
    import torch
    from repro_torch.models import transformer as T
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (batch, s + 1), generator=g,
                         device=dev)
    gaps, drops = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        with compute_dtype(dtype):
            with last_token_drops(drops if dtype == torch.float32 else []):
                full = T.forward(params, cfg, tokens=toks,
                                 mode="train")[:, s]
            _, cache = T.forward(params, cfg, tokens=toks[:, :s],
                                 mode="prefill", cache_len=s + 8)
            dl = T.forward(params, cfg, tokens=toks[:, s:], mode="decode",
                           cache=cache, pos=s)[0][:, 0]
            del cache
        err, rel, scale = max_err(dl.float(), full.float())
        same = bool(torch.equal(dl.float().argmax(-1),
                                full.float().argmax(-1)))
        finite = bool(torch.isfinite(dl).all()
                      and torch.isfinite(full).all())
        gaps[dtype] = (err, rel, scale, same, finite)
    err, rel, scale, same, finite = gaps[torch.float32]
    bf = gaps[torch.bfloat16]
    dropped = [int(d.max()) for d in drops]
    gated = not any(dropped)
    moe = (f"; assignments of position {s} dropped by the train forward "
           f"per MoE layer {dropped}" if cfg.moe is not None else "")
    print(f"[decoder] {label} prefill {s} + decode vs train forward at "
          f"position {s}, batch {batch}: f32 compute max_abs_err={err:.3e} "
          f"rel={rel:.3e} (tol {CONSISTENCY_RTOL:g} of max|logit|="
          f"{scale:.3f}{'' if gated else '; not gated'}), argmax equal "
          f"{same}; bf16 compute (not gated) rel={bf[1]:.3e}, argmax equal "
          f"{bf[3]}{moe}")
    if not (finite and bf[4] and (not gated or (rel <= CONSISTENCY_RTOL
                                                and same))):
        raise AssertionError(f"{label}: decode disagrees with the train "
                             f"forward")


def decoder_phase(dev, card: str) -> None:
    """Phase 17: the decoder attention family through ``generate`` (module
    docstring); raises on any failed check."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    reset_all_counts()
    arch, batch, prompt, gen = DECODER
    cfg = get_config(arch)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(cfg, g, dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in T.tree_leaves(params))
    print(f"[decoder] {cfg.name}: {cfg.n_layers} blocks, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, head_dim "
          f"{cfg.head_dim}, {T._rope_dims(cfg)} rotary dims, {cfg.norm}; "
          f"{n_par} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    if n_par != cfg.param_count():
        raise AssertionError(f"{n_par} parameters != param_count "
                             f"{cfg.param_count()}")
    time_generate(cfg.name, cfg, params,
                  decoder_prompts(cfg, batch, prompt, dev), gen,
                  DECODER_PREFILLS, card)
    decoder_consistency(cfg.name, cfg, params, *DECODER_CHECK, dev)
    del params
    torch.cuda.empty_cache()

    units, cb, cs = CARD_CPU
    small = cut_depth(cfg, units)
    t0 = time.perf_counter()
    cpu_params = T.init_params(small, torch.Generator().manual_seed(SEED))
    on_card = T.tree_map(lambda a: a.to(dev), cpu_params)
    toks = torch.randint(0, cfg.vocab, (cb, cs),
                         generator=torch.Generator().manual_seed(SEED + 3))
    with compute_dtype(torch.float32):
        want = T.forward(cpu_params, small, tokens=toks, mode="train")
        got = T.forward(on_card, small, tokens=toks.to(dev), mode="train")
    err, rel, scale = max_err(got, want.to(dev))
    print(f"[decoder] {cfg.name} cut to {units} blocks, f32 compute, train "
          f"logits batch {cb} prompt {cs}, card vs CPU: max_abs_err="
          f"{err:.3e} rel={rel:.3e} (tol {CARD_CPU_RTOL:g} of max|logit|="
          f"{scale:.3f}); {time.perf_counter() - t0:.3f} s with the CPU "
          f"draws")
    if not (rel <= CARD_CPU_RTOL and torch.isfinite(got).all()):
        raise AssertionError(f"{cfg.name}: card disagrees with the CPU")
    del cpu_params, on_card, want, got

    for arch in DECODER_CUTS:
        full = get_config(arch)
        cut = cut_depth(full, CUT_UNITS)
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(SEED)
        params = T.init_params(cut, g, dev)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in T.tree_leaves(params))
        label = (f"{full.name} ({full.stages[0].n_units} -> {CUT_UNITS} "
                 f"units)")
        print(f"[decoder] {label}: d {cut.d_model}, {cut.n_heads} heads / "
              f"{cut.n_kv_heads} kv (groups of "
              f"{cut.n_heads // cut.n_kv_heads}), head_dim {cut.head_dim}, "
              f"qkv_bias {cut.qkv_bias}; {n_par} parameters "
              f"({4 * n_par / 1e9:.1f} GB in f32) drawn on the card in "
              f"{time.perf_counter() - t0:.3f} s")
        if n_par != cut.param_count():
            raise AssertionError(f"{n_par} parameters != param_count "
                                 f"{cut.param_count()}")
        cb, cp, cg = CUT_RUN
        time_generate(label, cut, params,
                      decoder_prompts(cut, cb, cp, dev), cg,
                      DECODER_PREFILLS, card)
        decoder_consistency(label, cut, params, *CUT_RUN[:2], dev)
        del params
        torch.cuda.empty_cache()

    counts = launch_counts()
    print(f"[decoder] kernel launches over phase 17: {counts}")
    if any(counts.values()):
        raise AssertionError(f"the decoder attention family launched "
                             f"{counts}; its path has no kernel")
    print(f"[decoder] phase 17 in {time.perf_counter() - t_phase:.3f} s")


def draw_on_card(label: str, cfg, dev, tag: str = "zoo"):
    """The model's weights drawn on the card from the seed; their count
    must equal ``param_count``."""
    import torch
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           dev)
    torch.cuda.synchronize()
    n_par = sum(a.numel() for a in T.tree_leaves(params))
    units = " + ".join(f"{st.n_units} x {len(st.unit)}"
                       for st in cfg.stages)
    if cfg.kind == "encdec":
        units += f" + {cfg.n_enc_layers} encoder"
    print(f"[{tag}] {label}: {cfg.n_layers} blocks ({units}), d "
          f"{cfg.d_model}; {n_par} parameters ({4 * n_par / 2**30:.2f} "
          f"GiB in f32) drawn on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    if n_par != cfg.param_count():
        raise AssertionError(f"{label}: {n_par} parameters != param_count "
                             f"{cfg.param_count()}")
    return params


def frames(cfg, batch: int, n: int, dev):
    """Encoder (or prefix) embeddings (batch, n, d_model), bf16, drawn
    from the seed as the JAX ``main`` draws its frames."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    return torch.randn((batch, n, cfg.d_model), generator=g, device=dev,
                       dtype=torch.bfloat16)


def zoo_card_vs_cpu(arch: str, dev) -> None:
    """Phase 18d for one config: each stage cut to CUT_UNITS units, the
    weights drawn on the card and copied to the CPU, f32 compute: the
    card's train logits within CARD_CPU_RTOL of max|logit| of the
    CPU's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    full = get_config(arch)
    cfg = cut_depth(full, CUT_UNITS)
    label = f"{full.name} ({full.n_layers} -> {cfg.n_layers} blocks)"
    on_card = draw_on_card(label, cfg, dev)
    t0 = time.perf_counter()
    on_cpu = T.tree_map(lambda a: a.cpu(), on_card)
    _, cb, cs = CARD_CPU
    toks = torch.randint(0, cfg.vocab, (cb, cs),
                         generator=torch.Generator().manual_seed(SEED + 3))
    kw_cpu = {}
    if cfg.kind == "encdec":
        kw_cpu["enc_embeds"] = frames(cfg, cb, WHISPER_FRAMES, dev).cpu()
    with compute_dtype(torch.float32):
        want = T.forward(on_cpu, cfg, tokens=toks, mode="train", **kw_cpu)
        got = T.forward(on_card, cfg, tokens=toks.to(dev), mode="train",
                        **{k: v.to(dev) for k, v in kw_cpu.items()})
    err, rel, scale = max_err(got, want.to(dev))
    print(f"[zoo] {label}, f32 compute, train logits batch {cb} prompt {cs}"
          f"{' (1500 encoder frames)' if kw_cpu else ''}, card vs CPU: "
          f"max_abs_err={err:.3e} rel={rel:.3e} (tol {CARD_CPU_RTOL:g} of "
          f"max|logit|={scale:.3f}); {time.perf_counter() - t0:.3f} s with "
          f"the copy and the CPU forward")
    if not (rel <= CARD_CPU_RTOL and torch.isfinite(got).all()):
        raise AssertionError(f"{label}: card disagrees with the CPU")


def prefix_prefill(label: str, cfg, params, prompts, dev, card: str) -> None:
    """internvl2-26b's prefill through ``make_prefill_step`` with its
    ``n_prefix`` vision embeddings before the prompt: the next tokens in
    the vocabulary, a cache over prefix + prompt + 8 positions; timed."""
    import torch
    from repro_torch.launch.steps import make_prefill_step
    batch, prompt = prompts.shape
    step = make_prefill_step(cfg, cache_len=cfg.n_prefix + prompt + 8)
    feed = {"tokens": prompts,
            "prefix_embeds": frames(cfg, batch, cfg.n_prefix, dev)}
    step(params, feed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt, cache = step(params, feed)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    k = cache[0][0]["attn"]["k"]
    print(f"[zoo] {label} prefill with {cfg.n_prefix} prefix embeddings + "
          f"prompt {prompt}, batch {batch}: {ms:.4f} ms; cache k "
          f"{tuple(k.shape)}; next tokens {nxt.tolist()} on {card}")
    if not (k.shape[2] == cfg.n_prefix + prompt + 8
            and int(nxt.min()) >= 0 and int(nxt.max()) < cfg.vocab):
        raise AssertionError(f"{label}: the prefix prefill returned "
                             f"{tuple(k.shape)}, {nxt.tolist()}")


def zoo_phase(dev, card: str) -> None:
    """Phase 18: MoE, MLA, RG-LRU, the vision prefix and the
    encoder-decoder through ``generate`` (module docstring); raises on
    any failed check."""
    import torch
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    reset_all_counts()
    for arch, batch, prompt, gen, check_at in ZOO_FULL:
        cfg = get_config(arch)
        params = draw_on_card(cfg.name, cfg, dev)
        time_generate(cfg.name, cfg, params,
                      decoder_prompts(cfg, batch, prompt, dev), gen,
                      DECODER_PREFILLS, card)
        decoder_consistency(cfg.name, cfg, params, *check_at, dev)
        del params
        torch.cuda.empty_cache()
    for arch in ZOO_CARD_CPU:
        zoo_card_vs_cpu(arch, dev)
        torch.cuda.empty_cache()
    for arch, units, batch, prompt, gen in ZOO_OTHERS:
        full = get_config(arch)
        cfg = full if units is None else cut_depth(full, units)
        label = (full.name if units is None else
                 f"{full.name} ({full.n_layers} -> {cfg.n_layers} blocks)")
        params = draw_on_card(label, cfg, dev)
        prompts = decoder_prompts(cfg, batch, prompt, dev)
        enc = (frames(cfg, batch, WHISPER_FRAMES, dev)
               if cfg.kind == "encdec" else None)
        time_generate(label, cfg, params, prompts, gen, DECODER_PREFILLS,
                      card, enc_embeds=enc)
        if cfg.n_prefix:
            prefix_prefill(label, cfg, params, prompts, dev, card)
        del params
        torch.cuda.empty_cache()
    counts = launch_counts()
    print(f"[zoo] kernel launches over phase 18: {counts}")
    if any(counts.values()):
        raise AssertionError(f"the model families of phase 18 launched "
                             f"{counts}; their path has no kernel")
    print(f"[zoo] phase 18 in {time.perf_counter() - t_phase:.3f} s")


#: phase 19, LM training: (config, seq, global batch, microbatches) of
#: the two runs at full width and depth.  stablelm-1.6b at the JAX
#: package's train_4k sequence (launch/shapes.py), its global batch of 256
#: cut to 4 for one card and the time limit; one warm-up step, then
#: LM_TRAIN_STEPS timed
LM_TRAIN = (("stablelm_1_6b", 4096, 4, 4), ("mamba2_130m", 2048, 8, 2))
LM_TRAIN_STEPS = 4
#: 19b: stablelm-1.6b remat on vs off at (seq, batch); the gradients the
#: same function recomputed, relative to each leaf's max|g|
LM_REMAT = (1024, 1)
LM_REMAT_GRAD_RTOL = 1e-6
#: 19d: card vs CPU, f32 compute (TF32 off), each stage cut to CUT_UNITS
#: units, at (batch, seq): the loss relative, each gradient leaf relative
#: to its max|g|
LM_CARD_CPU = ("stablelm_1_6b", "mamba2_130m")
LM_CARD_CPU_RUN = (2, 64)
LM_CARD_CPU_LOSS_RTOL = 1e-5
LM_CARD_CPU_GRAD_RTOL = 1e-4
#: 19e: the CLI at full width, uninterrupted; then the supervisor losing
#: its worker at LM_CLI_FAIL_AT and ``--resume`` from the last checkpoint;
#: the resumed losses relative to the uninterrupted run's
LM_CLI = ["--arch", "mamba2_130m", "--steps", "20", "--batch", "8", "--seq",
          "512", "--save-every", "10", "--seed", str(SEED)]
LM_CLI_FAIL_AT = 15
LM_RESUME_RTOL = 1e-4


def lm_train_run(arch: str, seq: int, batch: int, n_mb: int, dev,
                 card: str) -> None:
    """Phase 19a/c for one model: drawn on the card, ``make_train_step``
    over batches of the token stream, one warm-up and LM_TRAIN_STEPS timed
    steps (host clock, each ending in a synchronize), the losses (finite),
    the peak allocation over the timed steps, and one more step under
    ``torch.profiler``."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedDataPipeline, TokenStream
    from repro_torch.launch.steps import TrainConfig, make_train_step
    from repro_torch.optim import adamw_init
    cfg = get_config(arch)
    params = draw_on_card(cfg.name, cfg, dev, tag="lm-train")
    state = {"params": params, "opt": adamw_init(params)}
    del params
    step = make_train_step(cfg, TrainConfig(
        microbatches=n_mb, peak_lr=1e-3, warmup_steps=2, total_steps=100))
    pipe = ShardedDataPipeline(TokenStream(vocab=cfg.vocab, seq_len=seq,
                                           global_batch=batch, seed=SEED))

    def feed():
        return {"tokens": torch.as_tensor(pipe.next(), device=dev)}
    losses, secs = [], []
    for i in range(1 + LM_TRAIN_STEPS):
        b = feed()
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    step_ms = 1e3 * statistics.median(secs[1:])
    tokens = batch * seq
    print(f"[lm-train] {cfg.name} seq {seq} global batch {batch} as {n_mb} "
          f"microbatches of {batch // n_mb}: step {step_ms:.4f} ms (median "
          f"of {LM_TRAIN_STEPS} after the warm-up, "
          f"{min(secs[1:]) * 1e3:.4f}-{max(secs[1:]) * 1e3:.4f}; first "
          f"{secs[0] * 1e3:.4f} ms), {tokens / step_ms * 1e3:.1f} tokens/s; "
          f"losses {losses}; last grad_norm {float(m['grad_norm']):.4f}, lr "
          f"{float(m['lr']):.3e}; peak allocation {peak / 2**30:.3f} GiB over "
          f"the timed steps on {card}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cfg.name}: a training loss is not finite")
    b = feed()
    profile_call(f"{cfg.name} one train step (seq {seq}, batch {batch}, "
                 f"{n_mb} microbatches)", lambda: step(state, b), step_ms,
                 host=False)


def lm_remat_check(dev, card: str) -> None:
    """Phase 19b: stablelm-1.6b at full width, one sequence of LM_REMAT's
    length: the loss and gradients with each unit recomputed vs kept (the
    loss bitwise, the gradients within LM_REMAT_GRAD_RTOL of each leaf's
    max|g|), the peak allocation of each backward above its start (lower
    with remat), and a train step's ms in each mode."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (TrainConfig, loss_and_grads,
                                          make_train_step)
    from repro_torch.optim import adamw_init, tree_leaves
    seq, batch = LM_REMAT
    cfg = get_config("stablelm_1_6b")
    params = draw_on_card(f"{cfg.name} (remat on vs off)", cfg, dev,
                          tag="lm-train")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    feed = {"tokens": torch.randint(0, cfg.vocab, (batch, seq + 1),
                                    generator=g, device=dev)}
    got = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = loss_and_grads(params, cfg, feed, remat=remat)
        torch.cuda.synchronize()
        got[remat] = (loss, tree_leaves(grads),
                      torch.cuda.max_memory_allocated() - base)
        del grads
    (l_on, g_on, p_on), (l_off, g_off, p_off) = got[True], got[False]
    bitwise = bool(torch.equal(l_on, l_off))
    rel = max(max_err(a, b)[1] for a, b in zip(g_on, g_off))
    same = all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    del got, g_on, g_off
    state = {"params": params, "opt": adamw_init(params)}
    del params
    ms = {}
    for remat in (True, False):
        step = make_train_step(cfg, TrainConfig(), remat=remat)
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, feed)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        ms[remat] = 1e3 * statistics.median(secs[1:])
    print(f"[lm-train] {cfg.name} seq {seq} batch {batch}, remat on vs off: "
          f"loss {float(l_on):.6f} vs {float(l_off):.6f} (bitwise {bitwise});"
          f" gradients within {rel:.3e} of max|g| (tol "
          f"{LM_REMAT_GRAD_RTOL:g}; bitwise {same}); backward peak "
          f"{p_on / 2**30:.3f} GiB with remat vs {p_off / 2**30:.3f} GiB "
          f"without, above its start; train step {ms[True]:.4f} ms vs "
          f"{ms[False]:.4f} ms (median of 2 after one) on {card}")
    if not (bitwise and rel <= LM_REMAT_GRAD_RTOL and p_on < p_off):
        raise AssertionError("stablelm-1.6b: remat changed the loss or the "
                             "gradients, or did not lower the peak")


def lm_card_vs_cpu(arch: str, dev) -> None:
    """Phase 19d for one config: each stage cut to CUT_UNITS units, the
    weights drawn on the card and copied to the CPU, f32 compute: the loss
    and every gradient leaf of ``loss_fn`` on the card against the
    CPU's."""
    import torch
    from repro_torch.checkpoint.store import _flatten   # the leaves' paths
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import transformer as T
    from repro_torch.optim import tree_leaves
    full = get_config(arch)
    cfg = cut_depth(full, CUT_UNITS)
    label = f"{full.name} ({full.n_layers} -> {cfg.n_layers} blocks)"
    on_card = draw_on_card(label, cfg, dev, tag="lm-train")
    t0 = time.perf_counter()
    on_cpu = T.tree_map(lambda a: a.cpu(), on_card)
    cb, cs = LM_CARD_CPU_RUN
    toks = torch.randint(0, cfg.vocab, (cb, cs + 1),
                         generator=torch.Generator().manual_seed(SEED + 6))
    with compute_dtype(torch.float32):
        l_cpu, g_cpu = loss_and_grads(on_cpu, cfg, {"tokens": toks})
        l_card, g_card = loss_and_grads(on_card, cfg,
                                        {"tokens": toks.to(dev)})
    rel_loss = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    errs = [max_err(a.cpu(), b)[1]
            for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu))]
    worst = _flatten(g_cpu)[errs.index(max(errs))][0]
    print(f"[lm-train] {label}, f32 compute, batch {cb} seq {cs}, card vs "
          f"CPU: loss {float(l_card):.6f} vs {float(l_cpu):.6f} (rel "
          f"{rel_loss:.3e}, tol {LM_CARD_CPU_LOSS_RTOL:g}); gradients: "
          f"worst leaf {worst} {max(errs):.3e} of its max|g| (tol "
          f"{LM_CARD_CPU_GRAD_RTOL:g}) over {len(errs)} leaves; "
          f"{time.perf_counter() - t0:.3f} s with the copy and the CPU "
          f"backward")
    if not (rel_loss <= LM_CARD_CPU_LOSS_RTOL
            and max(errs) <= LM_CARD_CPU_GRAD_RTOL):
        raise AssertionError(f"{label}: training on the card disagrees with "
                             f"the CPU")


@contextlib.contextmanager
def recorded_batches(log: dict):
    """Record every token batch the CLI's ``TokenStream`` hands out,
    keyed by step."""
    from repro_torch import data

    class Recording(data.TokenStream):
        def batch_at(self, step, shard=0, n_shards=1):
            out = super().batch_at(step, shard, n_shards)
            log[step] = out.copy()
            return out

    old = data.TokenStream
    data.TokenStream = Recording
    try:
        yield log
    finally:
        data.TokenStream = old


def lm_cli_check(card: str) -> None:
    """Phase 19e: ``launch.train --arch`` as a user runs it on the card,
    uninterrupted; then the same run losing its worker at LM_CLI_FAIL_AT
    (checkpoint at 10) and ``--resume``: the resumed run must read the
    same token batches bit for bit and reach the uninterrupted run's
    losses within LM_RESUME_RTOL."""
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.runtime.recovery import WorkerLost
    name = get_config("mamba2_130m").name
    with tempfile.TemporaryDirectory(prefix="lm-train-") as root:
        t0 = time.perf_counter()
        with recorded_batches({}) as seen_a:
            ref = train.main(LM_CLI + ["--ckpt-dir", f"{root}/a"])
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            with recorded_batches({}):
                train.main(LM_CLI + ["--ckpt-dir", f"{root}/b"],
                           inject_failure_at=LM_CLI_FAIL_AT)
        except WorkerLost as e:
            lost = str(e)
        else:
            raise AssertionError("the injected failure did not stop the run")
        saved = latest_step(f"{root}/b/{name}")
        with recorded_batches({}) as seen_c:
            got = train.main(LM_CLI + ["--ckpt-dir", f"{root}/b",
                                       "--resume"])
        t_res = time.perf_counter() - t0
    same_batches = (sorted(seen_c) == list(range(saved, ref.last)) and all(
        np.array_equal(seen_c[s], seen_a[s]) for s in seen_c))
    want = [m["loss"] for m in ref.metrics[saved:]]
    have = [m["loss"] for m in got.metrics]
    rel = max(abs(a - b) / abs(b) for a, b in zip(have, want))
    print(f"[lm-train] launch.train {' '.join(LM_CLI)}: {ref.last} steps in "
          f"{t_ref:.3f} s, losses {[m['loss'] for m in ref.metrics]}; "
          f"{lost} (last checkpoint {saved}), --resume ran steps "
          f"{saved + 1}-{got.last} ({t_res:.3f} s with the lost run): the "
          f"same token batches {same_batches}, losses within {rel:.3e} "
          f"relative of the uninterrupted run's (tol {LM_RESUME_RTOL:g}; "
          f"bitwise {have == want}); events {got.events} on {card}")
    if not (saved == 10 and got.last == ref.last == 20 and same_batches
            and len(have) == len(want) and rel <= LM_RESUME_RTOL):
        raise AssertionError("the resumed run is not restart-exact")


def lm_train_phase(dev, card: str) -> None:
    """Phase 19: the LM training loop (module docstring); raises on any
    failed check."""
    import torch
    t_phase = time.perf_counter()
    reset_all_counts()
    parts = [(f"{part} {run[0]}", lm_train_run, run + (dev, card))
             for part, run in zip("ac", LM_TRAIN)]
    parts.insert(1, ("b", lm_remat_check, (dev, card)))
    parts += [(f"d {arch}", lm_card_vs_cpu, (arch, dev))
              for arch in LM_CARD_CPU]
    parts.append(("e", lm_cli_check, (card,)))
    for name, fn, args in parts:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.empty_cache()
        print(f"[lm-train] 19{name} in {time.perf_counter() - t0:.3f} s")
    counts = launch_counts()
    print(f"[lm-train] kernel launches over phase 19: {counts}")
    if any(counts.values()):
        raise AssertionError(f"the LM training loop launched {counts}; its "
                             f"path has no kernel (ssd_chunk has no "
                             f"backward: loss_fn runs the plain version)")
    print(f"[lm-train] phase 19 in {time.perf_counter() - t_phase:.3f} s")


def main() -> int:
    t_main = time.perf_counter()
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
            dims = " (b_chunk, run, oc_b, blocks) " + " ".join(
                str(sdk_layout(mode, sk.tile_geom(m, t))) for t in m.tiles)
            if mode == "whole":
                dims += (f"; blocks launched {sk.sdk_whole.blocks} "
                         f"(whole_launch_dims {whole_blocks(m)})")
                ok = ok and sk.sdk_whole.blocks == whole_blocks(m)
            print(f"[kernel] {m.layer.name:10s} {mode:6s} tiles="
                  f"{len(m.tiles)} G={m.group} launches={fn.launches} "
                  f"steps={fn.steps} cycles={m.cycles} max_abs_err={err:.3e}"
                  f" rel={rel:.3e} (tol {KERNEL_RTOL:g} of max|y|={scale:.3f})"
                  f" {'ok' if ok else 'FAIL'}{dims}")
            if not ok:
                raise AssertionError(f"{m.layer.name} {mode}: kernel vs "
                                     f"plain, steps vs cycles or blocks vs "
                                     f"whole_launch_dims failed")
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
    main_blocks = sk.sdk_whole.blocks
    per_fwd = {"whole": 0, "window": 0}
    blocks_per_fwd = 0
    for lp in plan.layers:
        if lp.executor == "sdk":
            m = lp.mapping
            for t in m.tiles:
                g = sk.tile_geom(m, t)
                mode = sk.resolve_block(lp.block, BATCH, g, m.layer,
                                        lp.vmem_budget)
                per_fwd[mode] += m.group
                if mode == "whole":
                    blocks_per_fwd += m.group * sk.whole_launch_dims(
                        BATCH, g).blocks
    forwards = WARMUP + STEPS
    for mode in per_fwd:
        if main_launches[mode] != forwards * per_fwd[mode]:
            raise AssertionError(
                f"{mode} kernel: {main_launches[mode]} launches on the "
                f"serving path != {forwards} forwards x {per_fwd[mode]}")
    print(f"[main] sdk_whole blocks launched {main_blocks} over {forwards} "
          f"forwards == whole_launch_dims {forwards} x {blocks_per_fwd}: "
          f"{main_blocks == forwards * blocks_per_fwd}")
    if main_blocks != forwards * blocks_per_fwd:
        raise AssertionError("the served sdk_whole launches ran other blocks "
                             "than whole_launch_dims gives")
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
    profile_call("cnn8 one forward", lambda: execute_plan(plan, ks, xs),
                 stats.s_per_batch * 1e3, "sdk_whole")

    # -- 5. window path -----------------------------------------------------
    nets = (("cnn8", cnn8, "window"), ("densenet40", dn40, "auto"))
    win_launches = {"whole": 0, "window": 0}
    for name, net, block in nets:
        p = compile_plan(net, executor_policy="auto", batch=BATCH,
                         device=dev, block=block)
        ks, xh = serve_cnn.serving_inputs(net, BATCH, SEED, dev)
        xs = torch.as_tensor(xh, device=dev)
        sk.reset_counts()
        y = execute_plan(p, ks, xs)
        torch.cuda.synchronize()
        net_launches = {"whole": sk.sdk_whole.launches,
                        "window": sk.sdk_window.launches}
        for k in win_launches:
            win_launches[k] += net_launches[k]
        r = execute_oracle(p, ks, xs)
        err, rel, scale = max_err(y, r)
        print(f"[window] {name} block={block} executors="
              f"{'/'.join(sorted(set(p.executors)))}: launches whole="
              f"{net_launches['whole']} window={net_launches['window']}; "
              f"forward vs oracle max_abs_err={err:.3e} rel={rel:.3e} (tol "
              f"{FORWARD_RTOL:g} of max|y|={scale:.3f})")
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
    totals = dict.fromkeys(("whole", "window", "whole_call", "window_call",
                            "plain", "library", "bound"), 0.0)
    bound_by = {}
    rng = np.random.RandomState(SEED)
    layers = [lp.mapping for lp in plan.layers if lp.executor == "sdk"]
    extra = [m for m in cases if m.layer.name in ("DN40-b2l3", "Incep-3b",
                                                  "s2")]
    for m in layers + extra:
        t = sdk_times(m, rng, dev)
        t["bound"], bound_by[m.layer.name] = conv_bound_ms(m)
        if m in layers:
            for key in totals:
                totals[key] += t[key]
        print(f"[time] {m.layer.name} batch {BATCH} ({len(m.tiles) * m.group}"
              f" launches; whole (b_chunk, run, oc_b, blocks) "
              f"{sdk_layout('whole', sk.tile_geom(m, m.tiles[0]))}): device "
              f"whole {t['whole']:.5f} ms, window {t['window']:.5f} ms, "
              f"F.conv2d {t['library']:.5f} ms (medians of {ROUNDS} "
              f"interleaved rounds); per call whole {t['whole_call']:.5f} ms,"
              f" window {t['window_call']:.5f} ms, plain {t['plain']:.5f} ms;"
              f" bound {t['bound']:.6f} ms ({bound_by[m.layer.name]}) on "
              f"{card}")
    print(f"[time] cnn8 sdk layers CNN8-3..7 batch {BATCH}, summed: device "
          f"whole {totals['whole']:.5f} ms, window {totals['window']:.5f} ms,"
          f" F.conv2d {totals['library']:.5f} ms; whole "
          f"{totals['whole'] / totals['library']:.3f}x F.conv2d on {card}")
    by = ("operations" if [bound_by[m.layer.name] for m in layers].count(
        "operations") * 2 > len(layers) else "bytes")
    for name, mode, site, launches in (
            ("sdk_whole", "whole", WHOLE_SITE, main_launches["whole"]),
            ("sdk_window", "window", WINDOW_SITE, win_launches["window"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sdk_conv.cu",
            "replaces": site, "launches": launches,
            "path": ("serve cnn8 --policy auto" if mode == "whole" else
                     "cnn8 forward with block=window (the densenet40 auto "
                     "forward launches none)"),
            "max_abs_err": errors[mode], "ms": totals[mode],
            "call_ms": totals[mode + "_call"], "plain_ms": totals["plain"],
            "bound_ms": totals["bound"], "bound_by": by,
            "library_ms": totals["library"],
            "shapes": "cnn8 sdk layers CNN8-3..7 at batch 8, summed",
            "timing": "ms, library_ms: device time, stream held, median of "
                      "interleaved rounds; call_ms, plain_ms: per call incl."
                      " host"})
    rows[0]["blocks"] = main_blocks          # on the served path
    # -- 7-9. the transformer path ---------------------------------------
    rows += transformer_phases(dev, card)
    # -- 10-13. ssd_chunk, im2win_conv, the mamba2-130m path, ops -------
    rows += ssd_conv_phases(dev, card)
    # -- 14. training on plans: gradients, the plan trainer, Table II --
    grad_phase(dev, card)
    train_phase(dev, card)
    table2_phase(dev, card)
    # -- 15. arrival-driven serving: dynamic, fleet, replicas ------------
    served = serving_phase(cnn8, dev, card)
    # -- 16. the autotuner ------------------------------------------------
    tuned = tune_phase(cnn8, incep, dev, card)
    # -- 17. the decoder attention family ----------------------------------
    decoder_phase(dev, card)
    # -- 18. MoE, MLA, RG-LRU, the prefix and the encoder-decoder --------
    zoo_phase(dev, card)
    # -- 19. the LM training loop -------------------------------------------
    lm_train_phase(dev, card)
    print(f"[main] phases 1-19 in {time.perf_counter() - t_main:.3f} s")
    for row in rows:
        if row["name"] in served:
            row["serving_launches"] = served[row["name"]]
        if row["name"] in tuned:
            row["tune_launches"] = tuned[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
