"""deepseek-67b [dense] — llama-arch 95L d=8192 64H (GQA kv=8) ff=22016
vocab=102400 [arXiv:2401.02954; hf]."""
from ..models import ArchConfig, BlockSpec, Stage


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-67b",
        d_model=8192, vocab=102400,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22016,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 95),),
        tied_embeddings=False,
        notes="full attention -> long_500k SKIP",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-67b-smoke",
        d_model=128, vocab=512,
        n_heads=8, n_kv_heads=2, head_dim=16, d_ff=352,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 3),),
        tied_embeddings=False,
    )
