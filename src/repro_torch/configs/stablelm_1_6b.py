"""stablelm-1.6b [dense] — 24L d=2048 32H (MHA) ff=5632 vocab=100352,
LayerNorm + partial rotary 25 % [hf:stabilityai/stablelm-2-1_6b;
unverified]."""
from ..models import ArchConfig, BlockSpec, Stage


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b",
        d_model=2048, vocab=100352,
        n_heads=32, n_kv_heads=32, head_dim=64, d_ff=5632,
        rope_frac=0.25, norm="layernorm",
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 24),),
        tied_embeddings=False,
        notes="full attention -> long_500k SKIP",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b-smoke",
        d_model=128, vocab=512,
        n_heads=8, n_kv_heads=8, head_dim=16, d_ff=352,
        rope_frac=0.25, norm="layernorm",
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 3),),
        tied_embeddings=False,
    )
