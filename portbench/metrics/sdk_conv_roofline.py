"""sdk_conv_roofline (%), layer "kernels": the least time the layers the
plan runs on the sdk executor could take, over the device time of
``sdk_whole_kernel`` and ``sdk_window_kernel`` in the traced window.
Each layer's least time is the larger of its useful FLOPs at
``counts.PEAK_F32_FLOPS`` (67 TFLOP/s) and its bytes (kept input, kernel,
output, f32, once each) at ``counts.PEAK_HBM_BYTES_S`` (3.35 TB/s);
``counts.conv_work``."""
from portbench import counts


def read(run):
    t = run.trace
    if t is None:
        return None
    works = [w for w in run.work() if run.executors.get(w.name) == "sdk"]
    device_s = t.by_kernel.get("sdk_whole", 0.0) + t.by_kernel.get(
        "sdk_window", 0.0)
    return counts.roofline_pct(works, t.forwards, device_s)
