"""dispatch_ms.images (ms), layer "executor loop": the mean over the
window's batches of the host time from the call of the compiled forward
(``exec.execute_plan``) to its return, before synchronising: the
host's share of a batch that does not overlap the device's."""
from portbench.stats import mean


def read(run):
    if run.unit != "images":
        return None
    return 1e3 * mean(run.dispatch_s)
