"""BENCHMARK.json and the files it names hold to the benchmark's
contract: the keys, the names, a file for every configuration, cell and
metric, the bounds."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
HOME = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(("config", c["name"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
        names.append(("cell", w["name"]))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for _, n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)


def test_every_config_is_used_and_has_its_file():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/configs/")


def test_every_cell_has_its_traffic_file_and_limit():
    for w in SPEC["workloads"]:
        t = json.loads((HOME / "workloads" / f"{w['name']}.json").read_text())
        assert (t["config"], t["traffic"]) == (w["config"], w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert t["limits"]["rel_err"] is not None


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
        assert (HOME / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        mine = [m for m in e2e.values() if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2


def test_per_layer_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (HOME / "metrics" / f"{m['name']}.py").is_file()
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", reporting)) <= reporting
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert {"planner", "executor loop", "executors and glue", "kernels",
            "whole forward", "device"} == set(layers)
    for cell in cells:
        mine = [m for m in SPEC["per_layer"]
                if cell in m.get("workloads", cells)]
        assert mine


@pytest.mark.parametrize("cfg", sorted((HOME / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_configs_pin_every_layer(cfg):
    c = json.loads(cfg.read_text())
    keys = ([ly["name"] for ly in c["layers"]] if c["kind"] == "cnn"
            else ["qkv", "o", "w1", "w2"])
    for k in keys:
        pin = c["pins"][k]
        assert pin["group"] in c["search_groups"]
        assert all(kept > 0 and pruned >= 0 for kept, pruned in pin["tiles"])
