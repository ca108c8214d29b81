"""flash_attention_roofline (%), layer "kernels": the least time the
attention stages could take, over the device time of
``flash_attention_kernel`` in the traced window.  A stage's least time
is the larger of ``4 * B * H * hd * pairs`` FLOPs (pairs: S (S + 1) / 2
causal) at ``counts.PEAK_F32_FLOPS`` (67 TFLOP/s) and its q, k, v and
output bytes (f32, once each) at ``counts.PEAK_HBM_BYTES_S`` (3.35
TB/s); ``counts.attention_work``."""
from portbench import counts


def read(run):
    t = run.trace
    if t is None:
        return None
    works = [w for w in run.work() if w.kind == "attention"]
    return counts.roofline_pct(works, t.forwards,
                               t.by_kernel.get("flash_attention", 0.0))
