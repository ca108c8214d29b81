"""The torch counterparts of the examples run end to end on the CPU at
their smoke sizes (each takes ``--device``, the card by default)."""
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: F401 (autouse)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _main(name):
    return runpy.run_path(str(EXAMPLES / f"{name}.py"))["main"]


def test_torch_quickstart(capsys):
    err = _main("torch_quickstart")(["--device", "cpu"])
    out = capsys.readouterr().out
    assert err < 1e-4
    assert "executed steps 32 == cycles 32" in out
    assert "plan[cnn8]" in out


def test_torch_train_lm(tmp_path, capsys):
    run = _main("torch_train_lm")(["--device", "cpu", "--steps", "4",
                                   "--batch", "4", "--seq", "32",
                                   "--ckpt-dir", str(tmp_path)])
    assert run.last == 4
    assert np.isfinite([m["loss"] for m in run.metrics]).all()
    assert "done: 4 steps" in capsys.readouterr().out
    assert [p.name for p in (tmp_path / "mamba2-130m-smoke").iterdir()] == \
        ["step_00000004"]


def test_torch_fault_tolerance(capsys):
    _, last = _main("torch_fault_tolerance")(["--device", "cpu", "--steps",
                                              "20", "--fail-at", "15"])
    out = capsys.readouterr().out
    assert last == 20
    assert "worker lost at step 15" in out
    assert "re-mesh: (16, 16) (240 idle devices)" in out
    assert "resumed from step 10" in out


def test_torch_serve_moe(capsys):
    out_tokens = _main("torch_serve_moe")(["--device", "cpu"])
    assert out_tokens.shape == (2, 24 + 8)
    assert "mixtral-8x7b-smoke: generated 8 tokens x 2 seqs" in \
        capsys.readouterr().out
