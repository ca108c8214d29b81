"""mixtral-8x7b [moe] — 32L d=4096 32H (GQA kv=8) 8 experts top-2
(d_ff 14336), sliding-window attention 4096 [arXiv:2401.04088; hf]."""
from ..models import ArchConfig, BlockSpec, MoEConfig, Stage

_WINDOW = 4096


def config() -> ArchConfig:
    blk = BlockSpec(mixer="gqa", ffn="moe", window=_WINDOW)
    return ArchConfig(
        name="mixtral-8x7b",
        d_model=4096, vocab=32000,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336),
        stages=(Stage((blk,), 32),),
        tied_embeddings=False,
        sub_quadratic=True,
        notes="SWA -> long_500k RUNS with 4096-ring KV cache",
    )


def smoke_config() -> ArchConfig:
    blk = BlockSpec(mixer="gqa", ffn="moe", window=16)
    return ArchConfig(
        name="mixtral-8x7b-smoke",
        d_model=128, vocab=512,
        n_heads=8, n_kv_heads=2, head_dim=16, d_ff=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128, chunk=64,
                      capacity_factor=2.0),   # no-drop for exact decode parity
        stages=(Stage((blk,), 3),),
        tied_embeddings=False,
        sub_quadratic=True,
    )
