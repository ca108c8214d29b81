"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, pattern
(rec, rec, attn) [arXiv:2402.19427; unverified].  38 blocks = 12 x
(rec, rec, attn) + (rec, rec); local window 2048; MQA (kv=1);
d=4096 16H ff=12288 vocab=256000; temporal conv width 4."""
from ..models import ArchConfig, BlockSpec, Stage

_WINDOW = 2048


def config() -> ArchConfig:
    rec = BlockSpec(mixer="rec", ffn="dense")
    attn = BlockSpec(mixer="gqa", ffn="dense", window=_WINDOW)
    return ArchConfig(
        name="recurrentgemma-9b",
        d_model=4096, vocab=256000,
        n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
        rnn_width=4096, conv_width=4,
        stages=(Stage((rec, rec, attn), 12), Stage((rec, rec), 1)),
        sub_quadratic=True,
        notes="long_500k RUNS (RG-LRU state + 2048-window ring cache)",
    )


def smoke_config() -> ArchConfig:
    rec = BlockSpec(mixer="rec", ffn="dense")
    attn = BlockSpec(mixer="gqa", ffn="dense", window=16)
    return ArchConfig(
        name="recurrentgemma-9b-smoke",
        d_model=64, vocab=512,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
        rnn_width=64, conv_width=4,
        stages=(Stage((rec, rec, attn), 2), Stage((rec, rec), 1)),
        sub_quadratic=True,
    )
