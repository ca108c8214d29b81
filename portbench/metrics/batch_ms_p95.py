"""batch_ms_p95 (ms): the nearest-rank 95th percentile, over every batch
of the window, of the time from its submit to its synchronise (host
clock); the batches counted are the result's ``attempted``."""
from portbench.stats import percentile


def read(run):
    return 1e3 * percentile(run.latencies_s, 95)
