"""The benchmark's DenseNet-40 configuration (``portbench/configs/
densenet40.json``) held to the program: its layers are
``repro_torch.core.networks.densenet40()`` written out as data, set-up's
``check_pins`` accepts the program's mapping of every layer (so a change
to the search fails here, not as a refused run on the card), the card's
``auto`` executors and launches are the ones the densenet40.eval_b4096
cell's ``why`` names (and cnn8's at a small batch all ``sdk_whole``), and
the program's forward on those executors (their plain versions, batch 2)
matches the benchmark's plain reference on the benchmark's own seeded
weights and inputs within the cell's limit."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, program, reference  # noqa: E402
from repro_torch.core import networks  # noqa: E402
from repro_torch.exec import compile_plan, execute_plan  # noqa: E402
from repro_torch.exec.plan import _auto_executor  # noqa: E402

CONFIGS = ROOT / "portbench" / "configs"
WORKLOADS = ROOT / "portbench" / "workloads"


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _card_plan(mapping, batch):
    """The plan the card's ``auto`` policy makes, on the CPU's plain
    versions of the same executors."""
    return compile_plan(
        mapping, executor_policy=lambda m: _auto_executor(m, backend="cuda"),
        batch=batch, device="cpu")


def test_layers_are_the_programs_densenet40():
    cfg = _config("densenet40")
    want = [{"name": s.name, "i_h": s.i_h, "i_w": s.i_w, "k_h": s.k_h,
             "k_w": s.k_w, "ic": s.ic, "oc": s.oc, "stride": s.stride}
            for s in networks.densenet40()]
    assert all(s.groups == 1 and s.op == "conv"
               for s in networks.densenet40())
    assert cfg["layers"] == want and len(want) == 38
    assert cfg["reduced"] == [] and cfg["kind"] == "cnn"
    assert (cfg["input"]["channels"], cfg["input"]["height"]) == (16, 32)


@pytest.mark.parametrize("name", ["cnn8", "densenet40"])
def test_check_pins_accepts_the_programs_mapping(name):
    cfg = _config(name)
    mapping = program.build_mapping(cfg, {})
    program.check_pins(cfg, {}, mapping)
    pins = {m.layer.name: {"group": m.group,
                           "tiles": [[t.depth, t.pruned_channels]
                                     for t in m.tiles]}
            for m in mapping.layers}
    assert pins == {k: v for k, v in cfg["pins"].items() if k != "why"}


def test_check_pins_refuses_a_changed_pin():
    cfg = _config("densenet40")
    mapping = program.build_mapping(cfg, {})
    pins = dict(cfg["pins"], **{"DN40-b1l2": {"group": 4,
                                              "tiles": [[4, 0], [3, 0]]}})
    with pytest.raises(program.PinMismatch, match="DN40-b1l2"):
        program.check_pins(dict(cfg, pins=pins), {}, mapping)


@pytest.mark.parametrize("name,batch,executors,launches", [
    # the densenet40.eval_b4096 cell: 18 reference layers (b1l1-12, t1,
    # b2l4, b2l5, b2l9, b2l10, t2) on the placed kernel; every tile of the
    # 20 sdk layers on the window kernel
    ("densenet40", 4096, {"reference": 18, "sdk": 20},
     {"sdk_placed": 69, "sdk_window": 62, "sdk_whole": 0}),
    # cnn8 at a small batch: every sdk tile on the whole kernel
    ("cnn8", 96, {"reference": 1, "sdk": 5},
     {"sdk_placed": 3, "sdk_window": 0, "sdk_whole": 15}),
])
def test_card_executors_and_launches(name, batch, executors, launches):
    cfg = _config(name)
    plan = _card_plan(program.build_mapping(cfg, {}), batch)
    got = {e: plan.executors.count(e) for e in set(plan.executors)}
    assert got == executors
    per_forward = plan.launches_per_forward()
    assert {k: per_forward[k] for k in launches} == launches


def test_forward_matches_the_plain_reference():
    """Batch 2 through the card's executors (plain versions): the
    two-tile and pruned pins, the concat carry and the transitions' crop
    against ``portbench.reference`` on ``harness.make_kernels`` /
    ``make_ring``'s draws, within the cell's rel_err limit."""
    cfg = _config("densenet40")
    limit = json.loads((WORKLOADS / "densenet40.eval_b4096.json")
                       .read_text())["limits"]["rel_err"]
    traffic = {"batch": 2, "ring": 1}
    cpu = torch.device("cpu")
    plan = _card_plan(program.build_mapping(cfg, traffic), 2)
    gen = torch.Generator().manual_seed(2 ** 31 + 7)
    kernels = harness.make_kernels(cfg, traffic, gen, cpu)
    x = harness.make_ring(cfg, traffic, gen, cpu)[0]
    with torch.no_grad():
        y = execute_plan(plan, kernels, x, activation=torch.relu)
    ref = reference.forward(cfg, traffic, kernels, x)
    assert y.shape == ref.shape == (2, 12, 8, 8)
    assert harness.rel_err(y, ref) <= limit
