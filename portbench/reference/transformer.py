"""A stack of lowered transformer blocks, in plain PyTorch.

Each block, on tokens t (B, S, D):

    t = t + o(attention(qkv(layernorm(t))))
    t = t + w2(silu(w1(layernorm(t))))

with parameter-free layernorms (biased variance), grouped projections
(G diagonal blocks, channels group-major on both sides, each group's
pruned input channels zeroed) and softmax attention over heads of
``head_dim`` (query head h reads kv head h // (H / H_kv), causal by
position where the configuration says so), computed a few heads at a
time.  A request is the frame (B, D, S, 1) of token embeddings the
mapped net takes."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .pins import kept_mask
from .precision import exact_f32, operand

#: query heads per block of the attention
HEADS = 8


def layernorm(t: torch.Tensor, eps: float) -> torch.Tensor:
    mu = t.mean(dim=-1, keepdim=True)
    var = ((t - mu) ** 2).mean(dim=-1, keepdim=True)
    return (t - mu) * torch.rsqrt(var + eps)


def _projection(kernel: torch.Tensor, pin: dict, ic: int, oc: int,
                precision: str) -> torch.Tensor:
    """(G, ic / G, oc / G) diagonal blocks of a grouped projection."""
    g = pin["group"]
    d_g, f_g = ic // g, oc // g
    if tuple(kernel.shape) != (1, 1, d_g, oc):
        raise ValueError(f"kernel {tuple(kernel.shape)} != (1, 1, {d_g}, "
                         f"{oc}) for {g} groups")
    w = kernel[0, 0].float() * kept_mask(pin, d_g, kernel.device)[:, None]
    return operand(w.reshape(d_g, g, f_g).permute(1, 0, 2).contiguous(),
                   precision)


def project(t: torch.Tensor, w: torch.Tensor,
            precision: str) -> torch.Tensor:
    g, d_g, f_g = w.shape
    b, s, _ = t.shape
    y = torch.einsum("bsgd,gdf->bsgf",
                     operand(t.reshape(b, s, g, d_g), precision), w)
    return y.reshape(b, s, g * f_g)


def attention(qkv: torch.Tensor, hq: int, hkv: int, hd: int, causal: bool,
              precision: str) -> torch.Tensor:
    """qkv (B, S, (H + 2 H_kv) hd) -> context (B, S, H hd)."""
    b, s, _ = qkv.shape
    q = qkv[..., :hq * hd].reshape(b, s, hq, hd)
    k = qkv[..., hq * hd:(hq + hkv) * hd].reshape(b, s, hkv, hd)
    v = qkv[..., (hq + hkv) * hd:].reshape(b, s, hkv, hd)
    per_kv = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(b, s, hq, hd, dtype=torch.float32, device=qkv.device)
    pos = torch.arange(s, device=qkv.device)
    masked = pos[None, :] > pos[:, None]
    for h0 in range(0, hq, HEADS):
        heads = torch.arange(h0, min(hq, h0 + HEADS), device=qkv.device)
        qh = operand(q[:, :, heads].transpose(1, 2).contiguous(), precision)
        kh = operand(k[:, :, heads // per_kv].transpose(1, 2).contiguous(),
                     precision)
        vh = operand(v[:, :, heads // per_kv].transpose(1, 2).contiguous(),
                     precision)
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        if causal:
            scores = scores.masked_fill(masked, float("-inf"))
        p = operand(torch.softmax(scores, dim=-1), precision)
        del scores
        out[:, :, h0:h0 + len(heads)] = torch.einsum(
            "bhqk,bhkd->bhqd", p, vh).transpose(1, 2)
    return out.reshape(b, s, hq * hd)


def _dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    hq = cfg["num_attention_heads"]
    return {"d": d, "hq": hq, "hkv": cfg.get("num_key_value_heads") or hq,
            "hd": cfg.get("head_dim") or d // hq,
            "ff": cfg["intermediate_size"],
            "layers": cfg["num_hidden_layers"]}


def _blocks(cfg: dict, kernels, precision: str):
    t = _dims(cfg)
    shapes = (("qkv", t["d"], (t["hq"] + 2 * t["hkv"]) * t["hd"]),
              ("o", t["hq"] * t["hd"], t["d"]),
              ("w1", t["d"], t["ff"]),
              ("w2", t["ff"], t["d"]))
    if len(kernels) != 4 * t["layers"]:
        raise ValueError(f"{len(kernels)} kernels for {t['layers']} blocks "
                         f"of four projections")
    for i in range(t["layers"]):
        yield {kind: _projection(kernels[4 * i + j], cfg["pins"][kind], ic,
                                 oc, precision)
               for j, (kind, ic, oc) in enumerate(shapes)}


def _stack(cfg: dict, kernels, t: torch.Tensor, precision: str):
    d = _dims(cfg)
    eps = cfg.get("layer_norm_eps", 1e-5)
    causal = cfg.get("causal", True)
    for w in _blocks(cfg, kernels, precision):
        qkv = project(layernorm(t, eps), w["qkv"], precision)
        ctx = attention(qkv, d["hq"], d["hkv"], d["hd"], causal, precision)
        t = t + project(ctx, w["o"], precision)
        a = F.silu(project(layernorm(t, eps), w["w1"], precision))
        t = t + project(a, w["w2"], precision)
    return t


def forward(cfg: dict, traffic: dict, kernels, x: torch.Tensor, *,
            precision: str = "f32") -> torch.Tensor:
    """x (B, D, S, 1) -> (B, D, S, 1), f32, one request at a time."""
    with torch.no_grad(), exact_f32():
        outs = []
        for i in range(x.shape[0]):
            t = x[i:i + 1, :, :, 0].float().transpose(1, 2)
            outs.append(_stack(cfg, kernels, t, precision)
                        .transpose(1, 2)[..., None])
        return torch.cat(outs)
