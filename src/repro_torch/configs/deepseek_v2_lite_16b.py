"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512, rope 64) + MoE
[arXiv:2405.04434; hf].  The brief's shape line is internally
inconsistent ("64e top-6" vs "160 routed"); we follow the actual V2-Lite:
27L, d=2048, 16H MLA, 64 routed experts (d_ff 1408) top-6 + 2 shared,
first layer dense (d_ff 10944) — noted in DESIGN.md."""
from ..models import ArchConfig, BlockSpec, MoEConfig, Stage


def config() -> ArchConfig:
    dense = BlockSpec(mixer="mla", ffn="dense")
    moe = BlockSpec(mixer="mla", ffn="moe")
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        d_model=2048, vocab=102400,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=10944,
        kv_lora=512, rope_dim=64,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2),
        stages=(Stage((dense,), 1), Stage((moe,), 26)),
        tied_embeddings=False,
        notes="MLA full softmax -> long_500k SKIP per the brief's rule "
              "(compressed cache would fit)",
    )


def smoke_config() -> ArchConfig:
    dense = BlockSpec(mixer="mla", ffn="dense")
    moe = BlockSpec(mixer="mla", ffn="moe")
    return ArchConfig(
        name="deepseek-v2-lite-16b-smoke",
        d_model=128, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
        kv_lora=64, rope_dim=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, n_shared=1, chunk=64,
                      capacity_factor=2.0),   # no-drop for exact decode parity
        stages=(Stage((dense,), 1), Stage((moe,), 2)),
        tied_embeddings=False,
    )
