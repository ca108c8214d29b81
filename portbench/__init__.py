"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Each configuration (``configs/<config>.json``), cell
(``workloads/<cell>.json``) and metric (``metrics/<metric>.py``) lives in
a file of its own that the harness finds by the name ``BENCHMARK.json``
gives it.  The yardstick (counts, peaks, percentile, trace reduction and
the plain reference) lives here too; from the program (``repro_torch``)
the benchmark takes only the system under test, its counters and its
kernel names.  Nothing here imports ``jax`` or ``repro``, and nothing
under ``reference/`` imports ``repro_torch``.
"""
