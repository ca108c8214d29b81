"""Lower transformer configs block-by-block into the mapped-serving IR
(port of ``repro/launch/transformer.py``).

``transformer_mapping`` turns a `models.config.ArchConfig` into a
`core.types.NetworkMapping` whose layers are all ``op="matmul"`` specs
(`core.types.matmul_spec`) — qkv / o / w1 / w2 projections — and whose
``glue`` tuple carries everything the mapped matmuls do *not* own:
pre-layernorm, the attention stage between qkv and o, activations, and
the two residual adds per block.  The result flows through the conv
path: ``compile_plan -> execute_plan`` (``serve_cnn.serve``), with
steps==cycles asserted per layer at compile time.  Layers, glue and
mappings equal the JAX package's field for field.

Serving layout: a request is a frame of precomputed token embeddings
``(B, d_model, seq, 1)`` — d_model on the conv channel axis, tokens on
``i_h`` (`tokens_per_row` recovers seq for tokens/s reporting).
Embedding/vocab lookups stay outside the mapped net.

Fidelity notes (geometry over weights — a *mapping* workload, not a
checkpoint): norms are parameter-free passthroughs (rmsnorm configs also
lower to the layernorm passthrough); the gated-silu "dense" ffn lowers
to single-branch ``w1 -> silu -> w2``; whisper lowers its encoder
self-attention stack; rotary embeddings are skipped.  Mixers other than
gqa (mla/rec/ssd) and MoE ffns raise.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

from ..core import ArrayConfig, MacroGrid, NetworkMapping, mapper
from ..core.types import GlueSpec, matmul_spec
from ..models.config import ArchConfig, BlockSpec


def _arch_blocks(cfg: ArchConfig) -> Tuple[Tuple[str, BlockSpec], ...]:
    """(name_prefix, spec) per lowered block, in execution order."""
    if cfg.kind == "encdec":
        # encoder self-attention stack; bidirectional by construction
        base = cfg.stages[0].unit[0] if cfg.stages else BlockSpec()
        enc = BlockSpec(mixer=base.mixer, ffn=base.ffn, causal=False)
        return tuple((f"enc{i}", enc) for i in range(cfg.n_enc_layers))
    out, i = [], 0
    for stage in cfg.stages:
        for _ in range(stage.n_units):
            for spec in stage.unit:
                out.append((f"blk{i}", spec))
                i += 1
    return tuple(out)


def _lower_block(prefix: str, spec: BlockSpec, cfg: ArchConfig, seq: int):
    """One transformer block -> 4 matmul specs + their glue."""
    if spec.mixer != "gqa":
        raise ValueError(f"{cfg.name}: mixer {spec.mixer!r} has no mapped "
                         "lowering (only gqa/mha)")
    if spec.ffn not in ("dense", "gelu"):
        raise ValueError(f"{cfg.name}: ffn {spec.ffn!r} has no mapped "
                         "lowering (only dense/gelu)")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads or cfg.n_heads, cfg.head_dim
    d, ff = cfg.d_model, cfg.d_ff
    act = "gelu" if spec.ffn == "gelu" else "silu"
    layers = (
        matmul_spec(f"{prefix}.qkv", seq, d, (hq + 2 * hkv) * hd),
        matmul_spec(f"{prefix}.o", seq, hq * hd, d),
        matmul_spec(f"{prefix}.w1", seq, d, ff),
        matmul_spec(f"{prefix}.w2", seq, ff, d),
    )
    glue = (
        GlueSpec(kind="chain", pre="layernorm", save=True,
                 post="attention", heads=(hq, hkv, hd),
                 causal=spec.causal),
        GlueSpec(kind="residual"),
        GlueSpec(kind="chain", pre="layernorm", save=True, act=act),
        GlueSpec(kind="residual"),
    )
    return layers, glue


def transformer_mapping(config: Union[str, ArchConfig], *,
                        seq: int = 16,
                        array: ArrayConfig = ArrayConfig(),
                        algorithm: str = "TetrisG-SDK",
                        grid: MacroGrid = MacroGrid(),
                        blocks: Optional[int] = None,
                        groups: Sequence[int] = (1, 2, 4),
                        **kw) -> NetworkMapping:
    """Lower ``config`` (an ArchConfig or a `TRANSFORMERS` name) into a
    glue-carrying NetworkMapping of mapped matmul layers, ready for
    ``compile_plan``.  ``blocks`` truncates to the first N blocks."""
    if isinstance(config, str):
        config = TRANSFORMERS[config]()
    arch_blocks = _arch_blocks(config)
    if not arch_blocks:
        raise ValueError(f"{config.name}: no lowerable blocks")
    if blocks is not None:
        arch_blocks = arch_blocks[:blocks]
    layers, glue = [], []
    for prefix, spec in arch_blocks:
        ls, gs = _lower_block(prefix, spec, config, seq)
        layers.extend(ls)
        glue.extend(gs)
    return mapper.map_net(config.name, layers, array, algorithm, grid,
                          glue=tuple(glue), groups=tuple(groups), **kw)


def tokens_per_row(net: NetworkMapping) -> Optional[int]:
    """Tokens carried per batch row (seq) when ``net`` is a lowered
    transformer; None for conv nets (serve paths report images/s)."""
    first = net.layers[0].layer
    return first.i_h if getattr(first, "op", "conv") == "matmul" else None


TRANSFORMERS = {
    "stablelm_smoke": lambda: _smoke("stablelm_1_6b"),
    "whisper_smoke": lambda: _smoke("whisper_base"),
}


def _smoke(module: str) -> ArchConfig:
    from ..configs import get_config
    return get_config(module, smoke=True)
