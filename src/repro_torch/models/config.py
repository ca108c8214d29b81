"""Architecture configuration (port of ``repro/models/config.py``).

A model is a sequence of *stages*; each stage is a repeating unit of
block specs repeated ``n_units`` times.  A block spec is (mixer, ffn):

mixer: 'gqa' (incl. MQA/MHA/SWA/local via window), 'mla', 'rec' (RG-LRU),
       'ssd' (Mamba-2), 'none'
ffn:   'dense' (gated silu), 'gelu' (whisper), 'moe', 'none'

The dataclasses are copied field for field so a config reads the same
in both packages.  :class:`MoEConfig`, :class:`SSMConfig` and
:func:`pad_vocab` live beside the model code that uses them (``moe.py``,
``ssm.py``, ``common.py``) and are re-exported here, as in the JAX
package.  ``param_count`` counts from the model code's init shapes
(``transformer.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .common import pad_vocab
from .moe import MoEConfig
from .ssm import SSMConfig


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

    def param_count(self) -> int:
        """Parameter count from the port's init shapes (``meta`` device)."""
        from . import transformer
        return transformer.count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token touches: the total less the experts it is
        not routed to (``n_experts - top_k`` per MoE block)."""
        from . import transformer
        return transformer.count_params(self, active_only=True)
