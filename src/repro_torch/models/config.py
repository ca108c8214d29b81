"""Architecture configuration (port of ``repro/models/config.py``).

A model is a sequence of *stages*; each stage is a repeating unit of
block specs repeated ``n_units`` times.  A block spec is (mixer, ffn):

mixer: 'gqa' (incl. MQA/MHA/SWA/local via window), 'mla', 'rec' (RG-LRU),
       'ssd' (Mamba-2), 'none'
ffn:   'dense' (gated silu), 'gelu' (whisper), 'moe', 'none'

The dataclasses are copied field for field so a config reads the same
in both packages.  :class:`MoEConfig`, :class:`SSMConfig` and
:func:`pad_vocab` are plain copies of the definitions the JAX package
keeps beside its model code (``models/moe.py``, ``models/ssm.py``,
``models/common.py``); that code is not ported yet, and neither is
``param_count``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab so the embedding shards cleanly over the model axis."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    n_shared: int = 0            # shared (always-on) experts, dsv2-style
    capacity_factor: float = 1.25
    chunk: int = 512


@dataclass(frozen=True)
class SSMConfig:
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int = 128
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class BlockSpec:
    mixer: str = "gqa"
    ffn: str = "dense"
    window: Optional[int] = None        # SWA / local attention width
    causal: bool = True                 # False = bidirectional (encoder)
    cross: bool = False                 # cross-attention (encdec decoder)


@dataclass(frozen=True)
class Stage:
    unit: Tuple[BlockSpec, ...]
    n_units: int

    @property
    def n_layers(self) -> int:
        return len(self.unit) * self.n_units


@dataclass(frozen=True)
class ArchConfig:
    name: str
    d_model: int
    vocab: int
    stages: Tuple[Stage, ...]
    kind: str = "decoder"               # decoder | encdec
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    rope_frac: float = 1.0
    rope_base: float = 10000.0
    qkv_bias: bool = False
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    # MLA (deepseek-v2)
    kv_lora: int = 0
    rope_dim: int = 64
    # MoE
    moe: Optional[MoEConfig] = None
    # SSM / recurrent
    ssm: Optional[SSMConfig] = None
    rnn_width: int = 0
    conv_width: int = 4
    # encoder (encdec) — mirrors decoder dims unless overridden
    n_enc_layers: int = 0
    # frontends (stubs)
    frontend: Optional[str] = None      # 'vision' | 'audio'
    n_prefix: int = 0                   # vision prefix embedding positions
    tied_embeddings: bool = True
    # bookkeeping
    sub_quadratic: bool = False         # eligible for long_500k
    notes: str = ""

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)
