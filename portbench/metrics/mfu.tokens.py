"""mfu.tokens (%), layer "whole forward": the useful FLOPs of every forward
the window completed (``counts.forward_flops``: the pinned grouped
layers and, for a transformer, causal attention) over the window's
seconds times the H100's f32 peak, ``counts.PEAK_F32_FLOPS`` (67
TFLOP/s)."""
from portbench import counts


def read(run):
    if run.unit != "tokens" or run.window_s <= 0:
        return None
    flops = run.batches * counts.forward_flops(run.config, run.traffic)
    return 100.0 * flops / (run.window_s * counts.PEAK_F32_FLOPS)
