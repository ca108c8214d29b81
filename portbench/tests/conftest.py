"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, with tiny cells of both kinds of configuration
added as data files only."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a stablelm-shaped transformer small enough for the CPU
TINY_LM = {"num_hidden_layers": 2, "hidden_size": 64,
           "num_attention_heads": 4, "num_key_value_heads": 4,
           "intermediate_size": 176}


def pins_of(mapping, cfg: dict) -> dict:
    """The pins of a mapping as a configuration file states them."""
    pins = {"why": "test"}
    for m in mapping.layers:
        name = m.layer.name
        if cfg["kind"] == "transformer":
            name = name.split(".", 1)[1]
        pins[name] = {"group": m.group,
                      "tiles": [[t.depth, t.pruned_channels]
                                for t in m.tiles]}
    return pins


def add_cell(root: Path, config: dict, traffic: dict, *, like: str,
             limit=None):
    """Add a configuration (where new) and a cell to the checkout at
    ``root`` by writing data files and BENCHMARK.json entries only; the
    cell joins every metric's ``workloads`` that cell ``like`` is in and
    takes its limit (where ``limit`` is None)."""
    from portbench import program
    bench_path = root / "BENCHMARK.json"
    spec = json.loads(bench_path.read_text())
    if limit is None:
        limit = json.loads((root / "portbench" / "workloads" /
                            f"{like}.json").read_text())["limits"]["rel_err"]
    traffic = dict(traffic, limits={"rel_err": limit})
    if config.get("pins") is None:
        mapping = program.build_mapping(config, traffic)
        config = dict(config, pins=pins_of(mapping, config))
    cfg_file = f"portbench/configs/{config['name']}.json"
    (root / cfg_file).write_text(json.dumps(config))
    if all(c["name"] != config["name"] for c in spec["configs"]):
        spec["configs"].append({"name": config["name"],
                                "source": "test", "file": cfg_file,
                                "reduced": [], "why": "test"})
    name = f"{config['name']}.{traffic['traffic']}"
    (root / "portbench" / "workloads" / f"{name}.json").write_text(
        json.dumps(dict(traffic, config=config["name"])))
    spec["workloads"].append({"name": name, "config": config["name"],
                              "traffic": traffic["traffic"], "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    bench_path.write_text(json.dumps(spec, indent=1))
    return name


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    (root / "portbench").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "workloads", "metrics", "reference"):
        shutil.copytree(ROOT / "portbench" / sub, root / "portbench" / sub)
    return root


def tiny_lm_config() -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "stablelm-1.6b.json").read_text())
    return dict(cfg, name="tinylm", pins=None, **TINY_LM)


def cnn8_config() -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "cnn8.json").read_text())
    return dict(cfg, name="cnn8-cpu")


@pytest.fixture
def tiny(tmp_path):
    """A checkout copy with two CPU cells: cnn8 at batch 2 and a tiny
    transformer at batch 2 x 16 tokens."""
    root = _copy(tmp_path)
    cells = {
        "cnn": add_cell(root, cnn8_config(),
                        {"traffic": "eval_b2", "unit": "images",
                         "batch": 2, "ring": 2, "samples": 2},
                        like="cnn8.eval_b8192"),
        "lm": add_cell(root, tiny_lm_config(),
                       {"traffic": "prefill_s16_b2", "unit": "tokens",
                        "batch": 2, "seq": 16, "ring": 2, "samples": 2},
                       like="stablelm-1.6b.prefill_s512_b4"),
    }
    return root, cells
