"""grouped_matmul_roofline (%), layer "kernels": the least time the
grouped (G > 1) matmul layers could take, over the device time of
``gemm_f32_kernel`` in the traced window.  Each layer's least time is
the larger of ``2 * M * kept * oc`` FLOPs at ``counts.PEAK_F32_FLOPS``
(67 TFLOP/s) and its x, w and output bytes (f32, once each) at
``counts.PEAK_HBM_BYTES_S`` (3.35 TB/s); ``counts.matmul_work``.  The
GEMM body is shared with ``tetris_matmul`` (G = 1), so a forward with
any G = 1 matmul layer reads nothing."""
from portbench import counts


def read(run):
    t = run.trace
    if t is None:
        return None
    matmuls = [w for w in run.work()
               if run.executors.get(w.name) == "matmul"]
    if not matmuls or any(w.group == 1 for w in matmuls):
        return None
    return counts.roofline_pct(matmuls, t.forwards,
                               t.by_kernel.get("gemm", 0.0))
