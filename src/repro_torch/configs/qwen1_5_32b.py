"""qwen1.5-32b [dense] — 64L d=5120 40H (MHA) ff=27392 vocab=152064, QKV
bias [hf:Qwen/Qwen1.5-*; hf].  40 heads don't divide a 16-way model axis:
sharding falls back to head_dim partitioning (launch/sharding.py)."""
from ..models import ArchConfig, BlockSpec, Stage


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-32b",
        d_model=5120, vocab=152064,
        n_heads=40, n_kv_heads=40, head_dim=128, d_ff=27392,
        qkv_bias=True,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 64),),
        tied_embeddings=False,
        notes="full attention -> long_500k SKIP; heads=40 -> head_dim TP",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-32b-smoke",
        d_model=128, vocab=512,
        n_heads=8, n_kv_heads=8, head_dim=16, d_ff=352,
        qkv_bias=True,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 3),),
        tied_embeddings=False,
    )
