"""Measured-feedback autotuner (port of ``repro.tune``, DESIGN.md §9).

Joint mapping–executor co-tuning against wall-clock on the card: the
analytical cycle model seeds a shortlist over {per-layer executor
policy, mesh (data, row, col) split, lookahead (inert here), sdk
block/budget — ``sdk_whole_kernel`` or ``sdk_window_kernel`` per tile —,
batch tiers}; interleaved-round medians under successive halving settle
it; winners persist in the schema-versioned disk cache so a cold process
serves tuned with zero re-measurement.

    from repro_torch import tune
    res = tune.autotune(mapping, batch=8)       # measures (or loads)
    cfg = tune.tuned_config(mapping, batch=8)   # peek only, no search

``device="cpu"`` tunes the plain versions on the CPU, under a fleet key
of its own.  `compile_plan(executor_policy="tuned")` and ``serve_cnn
--autotune`` consume the same persisted winners.
"""
from .measure import interleaved_medians, interleaved_rounds, median
from .report import (append_trajectory, trajectory_entry, write_csv,
                     write_json)
from .search import (SMOKE_BUDGET, Trial, TuneBudget, TuneResult,
                     autotune, default_runner, fleet_signature,
                     resolve_tiers, tuned_config, tuning_key)
from .space import (Candidate, TunedConfig, analytic_cost, auto_policy,
                    baseline_candidate, enumerate_space,
                    policy_candidates, shortlist)

__all__ = [
    "median", "interleaved_rounds", "interleaved_medians",
    "Candidate", "TunedConfig", "auto_policy", "policy_candidates",
    "analytic_cost", "enumerate_space", "baseline_candidate", "shortlist",
    "TuneBudget", "SMOKE_BUDGET", "Trial", "TuneResult", "autotune",
    "default_runner", "fleet_signature", "resolve_tiers", "tuned_config",
    "tuning_key",
    "append_trajectory", "trajectory_entry", "write_csv", "write_json",
]
