"""Reporting for autotune runs: CSV rows, JSON dumps, BENCH trajectory
(a copy of ``repro/tune/report.py``: same rows, same JSON layout).

Three audiences:

* **CI artifacts** — :func:`write_csv` emits the harness's CSV contract
  (``name,usec,extras``) with one row per (net, stage, candidate) trial
  plus a summary row per net.
* **Programmatic** — :func:`write_json` dumps the full
  :class:`~repro_torch.tune.search.TuneResult` (winner, baseline, every
  trial) as plain JSON for downstream tooling.
* **Trajectory** — :func:`trajectory_entry` shapes one BENCH_*.json
  entry (the repo's perf-over-PRs ledger) from a set of finished
  results.

Serialization is hand-rolled (dataclasses → dicts) rather than pickle:
these files are for humans and dashboards, and must stay readable when
the dataclasses grow fields.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from .search import TuneResult
from .space import Candidate, TunedConfig


def candidate_dict(c: Candidate) -> dict:
    return {"policy": list(c.policy), "lookahead": c.lookahead,
            "block": c.block, "vmem_budget": c.vmem_budget,
            "tiers": list(c.tiers) if c.tiers is not None else None,
            "mesh_split": (list(c.mesh_split)
                           if c.mesh_split is not None else None)}


def config_dict(cfg: TunedConfig) -> dict:
    return {"candidate": candidate_dict(cfg.candidate),
            "median_s": cfg.median_s, "baseline_s": cfg.baseline_s,
            "speedup": cfg.speedup, "rounds": cfg.rounds,
            "measurements": cfg.measurements,
            "fleet": {"platform": cfg.fleet[0], "devices": cfg.fleet[1]},
            "batch": cfg.batch}


def result_dict(res: TuneResult) -> dict:
    return {"config": config_dict(res.config), "cached": res.cached,
            "measurements": res.measurements,
            "trials": [{"candidate": candidate_dict(t.candidate),
                        "rounds": t.rounds, "median_s": t.median_s}
                       for t in res.trials]}


def csv_rows(results: Dict[str, TuneResult]) -> list:
    """Harness CSV rows (``name,usec,key=val;...``): per net one
    ``tune/{net}`` summary row — tuned median vs the auto baseline from
    the SAME final interleaved rounds — and one ``tune/{net}/trial{i}``
    row per measured trial for the full search trajectory."""
    rows = []
    for net, res in sorted(results.items()):
        cfg = res.config
        rows.append((f"tune/{net}", cfg.median_s * 1e6,
                     f"baseline_us={cfg.baseline_s * 1e6:.1f};"
                     f"speedup={cfg.speedup:.3f};"
                     f"policy={'+'.join(sorted(set(cfg.candidate.policy)))};"
                     f"lookahead={cfg.candidate.lookahead};"
                     f"mesh={cfg.candidate.mesh_split or 'vmap'};"
                     f"batch={cfg.batch};rounds={cfg.rounds};"
                     f"measurements={res.measurements};"
                     f"cached={int(res.cached)};"
                     f"fleet={cfg.fleet[0]}x{cfg.fleet[1]}"))
        for i, t in enumerate(res.trials):
            rows.append((f"tune/{net}/trial{i}", t.median_s * 1e6,
                         f"rounds={t.rounds};"
                         f"cand={t.candidate.describe().replace(' ', '_')}"))
    return rows


def write_csv(results: Dict[str, TuneResult],
              path: Optional[str] = None) -> str:
    """Render (and optionally write) the CSV artifact; also the string a
    caller prints to stdout."""
    lines = ["name,usec,extras"]
    lines += [f"{n},{us:.1f},{extras}" for n, us, extras in
              csv_rows(results)]
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def write_json(results: Dict[str, TuneResult],
               path: Optional[str] = None) -> str:
    payload = {net: result_dict(res) for net, res in sorted(results.items())}
    text = json.dumps(payload, indent=2, sort_keys=True)
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def trajectory_entry(results: Dict[str, TuneResult], *, pr: str,
                     note: str = "") -> dict:
    """One BENCH_autotune.json ledger entry: per net the tuned/baseline
    medians and the search cost, so the trajectory of 'how much does
    measurement buy over the auto heuristic' is tracked across PRs."""
    return {"pr": pr, "note": note,
            "nets": {net: {"tuned_us": res.config.median_s * 1e6,
                           "baseline_us": res.config.baseline_s * 1e6,
                           "speedup": res.config.speedup,
                           "measurements": res.measurements,
                           "fleet": list(res.config.fleet),
                           "batch": res.config.batch}
                     for net, res in sorted(results.items())}}


def append_trajectory(path: str, entry: dict) -> None:
    """Append ``entry`` to the JSON-list ledger at ``path`` (created if
    missing) — the shape every BENCH_*.json in this repo uses."""
    try:
        with open(path) as f:
            ledger = json.load(f)
    except FileNotFoundError:
        ledger = []
    if not isinstance(ledger, list):
        raise ValueError(f"{path}: trajectory ledger must be a JSON list")
    ledger.append(entry)
    with open(path, "w") as f:
        json.dump(ledger, f, indent=2, sort_keys=True)
        f.write("\n")


__all__ = ["candidate_dict", "config_dict", "result_dict", "csv_rows",
           "write_csv", "write_json", "trajectory_entry",
           "append_trajectory"]
