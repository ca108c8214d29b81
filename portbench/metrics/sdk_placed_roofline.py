"""sdk_placed_roofline (%), layer "kernels": the least time the layers the
plan runs on the ``reference`` executor could take, over the device time
of ``sdk_placed_kernel`` (the executor's kernel on the card) in the
traced window.  Each layer's least time is the larger of its useful
FLOPs at ``counts.PEAK_F32_FLOPS`` (67 TFLOP/s) and its bytes (kept
input, kernel, output, f32, once each) at ``counts.PEAK_HBM_BYTES_S``
(3.35 TB/s); ``counts.conv_work``.  Reads nothing without a trace or
where no event of the kernel ran in it."""
from portbench import counts

KERNEL = "sdk_placed_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    works = [w for w in run.work()
             if run.executors.get(w.name) == "reference"]
    device_s = sum(s for name, s in t.by_name.items() if KERNEL in name)
    return counts.roofline_pct(works, t.forwards, device_s)
