"""mistral-large-123b [dense] — 88L d=12288 96H (GQA kv=8) ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""
from ..models import ArchConfig, BlockSpec, Stage


def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b",
        d_model=12288, vocab=32768,
        n_heads=96, n_kv_heads=8, head_dim=128, d_ff=28672,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 88),),
        tied_embeddings=False,
        notes="full attention -> long_500k SKIP",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b-smoke",
        d_model=128, vocab=512,
        n_heads=8, n_kv_heads=2, head_dim=16, d_ff=288,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 3),),
        tied_embeddings=False,
    )
