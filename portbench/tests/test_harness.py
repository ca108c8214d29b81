"""The harness driven on the CPU, past its look for a chip: sound runs
come out correct, and the timed path broken underneath (the faults a
forward can have, and the TF32 control in the program's place) comes out
not correct."""
import json
import time

import pytest
import torch

from portbench import calibrate, harness

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345          # past 32 signed bits, as the driver's are


def _run(root, cell, trace=False, wrap=None, seconds=0.3):
    bench = harness.Bench.load(root)
    return harness.run_cell(bench, cell, SEED, seconds, trace, CPU,
                            time.perf_counter(), forward_wrap=wrap)


@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_sound_run(tiny, kind):
    root, cells = tiny
    r = _run(root, cells[kind])
    line = r.line()
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    unit = "images_per_s" if kind == "cnn" else "tokens_per_s"
    assert set(line["metrics"]) == {unit, "batch_ms_p95", "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["checks"]["rel_err"]["value"] <= \
        line["checks"]["rel_err"]["limit"]
    json.dumps(line)


@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_traced_run_reads_the_host_metrics(tiny, kind):
    root, cells = tiny
    r = _run(root, cells[kind], trace=True)
    line = r.line()
    assert line["correct"] is True
    unit = "images" if kind == "cnn" else "tokens"
    # no device on the CPU: the device readers read nothing
    assert set(line["metrics"]) == {"plan_s", f"dispatch_ms.{unit}",
                                    f"mfu.{unit}"}
    assert line["device"]["busy_s"] == 0.0
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_fault_under_the_timed_path_is_not_correct(tiny, kind, fault):
    root, cells = tiny
    r = _run(root, cells[kind], wrap=calibrate.FAULTS[fault])
    assert r.correct is False
    assert r.check.value > r.limit


@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_tf32_control_in_the_programs_place_is_not_correct(tiny, kind):
    root, cells = tiny
    control = calibrate.control(harness.Bench.load(root), cells[kind], SEED,
                                CPU)
    r = _run(root, cells[kind], wrap=control)
    assert r.correct is False
    assert r.check.value > r.limit


def test_a_mapping_off_its_pins_is_refused(tiny):
    root, cells = tiny
    path = root / "portbench" / "configs" / "tinylm.json"
    cfg = json.loads(path.read_text())
    cfg["pins"]["w2"]["group"] = 3 - cfg["pins"]["w2"]["group"] % 2
    path.write_text(json.dumps(cfg))
    with pytest.raises(harness.Refused, match="pins"):
        _run(root, cells["lm"])


def test_a_cell_without_a_limit_is_not_correct(tiny):
    root, cells = tiny
    path = root / "portbench" / "workloads" / f"{cells['cnn']}.json"
    traffic = json.loads(path.read_text())
    traffic["limits"]["rel_err"] = None
    path.write_text(json.dumps(traffic))
    assert _run(root, cells["cnn"]).correct is False


def test_same_seed_same_inputs():
    cfg = json.loads((harness.Path(__file__).resolve().parents[1] / "configs"
                      / "cnn8.json").read_text())
    traffic = {"batch": 2, "ring": 2}
    a, b = (torch.Generator().manual_seed(SEED) for _ in range(2))
    ka, kb = (harness.make_kernels(cfg, traffic, g, CPU) for g in (a, b))
    ra, rb = (harness.make_ring(cfg, traffic, g, CPU) for g in (a, b))
    for x, y in zip(ka + [ra], kb + [rb]):
        assert torch.equal(x, y)
    # each layer's std is 1 / sqrt(its fan-in of one group)
    assert float(ka[0].std()) == pytest.approx((3 * 3 * 6) ** -0.5, rel=0.1)
