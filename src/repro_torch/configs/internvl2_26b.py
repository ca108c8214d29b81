"""internvl2-26b [vlm] — InternViT + InternLM2 backbone
[arXiv:2404.16821; hf].  Per the brief the modality frontend is a STUB:
input_specs provide precomputed patch embeddings for a 256-token visual
prefix; the transformer backbone below is the InternLM2-26B-shaped
decoder (48L, d=6144, 48H GQA kv=8, ff=16384, vocab=92553)."""
from ..models import ArchConfig, BlockSpec, Stage


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-26b",
        d_model=6144, vocab=92553,
        n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 48),),
        frontend="vision", n_prefix=256,
        tied_embeddings=False,
        notes="full attention -> long_500k SKIP (DESIGN.md)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-26b-smoke",
        d_model=128, vocab=512,
        n_heads=8, n_kv_heads=2, head_dim=16, d_ff=256,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="dense"),), 3),),
        frontend="vision", n_prefix=8,
        tied_embeddings=False,
    )
