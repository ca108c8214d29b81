"""LM serving: a batched prefill + greedy decode loop (port of
``repro/launch/serve.py``).  For batched serving through the compiled
plan see :mod:`repro_torch.launch.serve_cnn`.

    python -m repro_torch.launch.serve --arch mamba2_130m --smoke \
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]
    python -m repro_torch.launch.serve --arch deepseek_v2_lite_16b \
        --smoke --device cpu
    python -m repro_torch.launch.serve --arch whisper_base --smoke \
        --device cpu

Runs on the card unless ``--device`` says otherwise.  Weights, prompts
and an encoder-decoder's frame embeddings (batch, prompt length,
d_model; bf16) are drawn from a ``torch.Generator`` seeded with
``--seed`` on the device (the distributions of the JAX package's init,
not its draws).  Every config of the registry serves: the attention
family, MLA and MoE, RG-LRU, the vision-prefix backbone and the
encoder-decoder (``generate`` takes no prefix, as the JAX one takes
none).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..device import resolve_device, synchronize
from ..models import transformer as T
from .steps import make_prefill_step, make_serve_step


def generate(cfg, params, prompts: torch.Tensor, gen: int,
             enc_embeds=None) -> torch.Tensor:
    """prompts (B, S) -> (B, S+gen) greedy continuation: one batched
    prefill (of an encoder-decoder with its ``enc_embeds``), then
    ``gen - 1`` decode steps."""
    b, s = prompts.shape
    prefill = make_prefill_step(cfg, cache_len=s + gen)
    serve = make_serve_step(cfg)
    batch = {"tokens": prompts}
    if enc_embeds is not None:
        batch["enc_embeds"] = enc_embeds
    nxt, cache = prefill(params, batch)
    tok = nxt[:, None].to(prompts.dtype)
    out = [prompts, tok]
    for i in range(gen - 1):
        tok, cache = serve(params, cache, tok, s + i)
        tok = tok.to(prompts.dtype)
        out.append(tok)
    return torch.cat(out, 1)


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    enc = None
    if cfg.kind == "encdec":
        enc = torch.randn((args.batch, args.prompt_len, cfg.d_model),
                          generator=gen, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, args.gen, enc_embeds=enc)
    synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: generated {args.gen} tokens x {args.batch} seqs "
          f"in {dt:.1f}s ({args.gen * args.batch / dt:.1f} tok/s) on {dev}")
    print("sample:", out[0, -args.gen:].tolist())
    return out


if __name__ == "__main__":
    main()
