"""whisper-base [audio] — enc-dec, 6+6L d=512 8H ff=2048 vocab=51865
[arXiv:2212.04356; unverified].  The conv frontend is a STUB per the
brief: input_specs provide precomputed frame embeddings (B, S, 512); the
mapping benchmarks expose the stubbed conv1d shapes to the paper's
technique separately (DESIGN.md SArch-applicability)."""
from ..models import ArchConfig, BlockSpec, Stage


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base",
        kind="encdec", n_enc_layers=6,
        d_model=512, vocab=51865,
        n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048,
        norm="layernorm", rope_frac=0.0,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="gelu", cross=True),),
                      6),),
        tied_embeddings=True,
        notes="enc-dec full attention -> long_500k SKIP; decode runs "
              "(self cache + cross attention)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base-smoke",
        kind="encdec", n_enc_layers=2,
        d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        norm="layernorm", rope_frac=0.0,
        stages=(Stage((BlockSpec(mixer="gqa", ffn="gelu", cross=True),),
                      2),),
        tied_embeddings=True,
    )
