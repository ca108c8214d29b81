"""setup_s (s): from the start of the process to the first timed batch:
imports, the CUDA context, mapping and plan compile (from the mapping
cache after a checkout's first run), the weights and inputs made on the
device, the kernels built (first run) and loaded, and the warm-up
forwards (host clock)."""


def read(run):
    return run.setup_s
