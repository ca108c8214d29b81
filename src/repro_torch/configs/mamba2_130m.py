"""mamba2-130m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].  24L d=768 vocab=50280; d_inner=1536
(expand 2), 24 heads x head_dim 64, d_state=128, chunk 256, causal conv
width 4 — the conv is a depthwise temporal conv, the one sublayer where
the paper's mapping technique applies (DESIGN.md SArch-applicability)."""
from ..models import ArchConfig, BlockSpec, SSMConfig, Stage


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m",
        d_model=768, vocab=50280,
        ssm=SSMConfig(d_inner=1536, n_heads=24, head_dim=64, d_state=128,
                      n_groups=1, conv_width=4, chunk=256),
        stages=(Stage((BlockSpec(mixer="ssd", ffn="none"),), 24),),
        tied_embeddings=True,
        sub_quadratic=True,
        notes="long_500k RUNS (O(1) SSD state)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m-smoke",
        d_model=64, vocab=512,
        ssm=SSMConfig(d_inner=128, n_heads=4, head_dim=32, d_state=32,
                      n_groups=1, conv_width=4, chunk=32),
        stages=(Stage((BlockSpec(mixer="ssd", ffn="none"),), 3),),
        tied_embeddings=True,
        sub_quadratic=True,
    )
