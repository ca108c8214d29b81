"""torch_ops_ms.images (ms), layer "executors and glue": device time a
forward of everything that is not one of the port's hand-written kernels
(PyTorch's own kernels, copies and fills of the executors, the glue and
the layout changes), from the traced window."""


def read(run):
    t = run.trace
    if run.unit != "images" or t is None or t.forwards == 0 or t.busy_s <= 0:
        return None
    return 1e3 * t.by_kernel.get("other", 0.0) / t.forwards
