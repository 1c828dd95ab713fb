"""A configuration of another field is taken by adding files only: a
one-cell benchmark over the test-only field ``stub`` (``stub_field.py``,
no key of the NeRF MLP), read from a copy of the benchmark's files with
its configuration, its limits and its entries added, runs through the
unchanged ``train`` kind and ``run.run_cell`` on the CPU, prints the
result line with ``train_rays_per_s`` and ``setup_s``, and is correct;
the same cell with the stub's program leaving its state unchanged is not.
"""

import json
import shutil
import sys

import pytest

from nerfbench import run, spec
from nerfbench.tests import stub_field
from nerfbench.tests.conftest import TRAIN

CELL = "train.stub"
CONFIG = {
    "field": "stub",
    "source": "a test-only field of nerfbench's tests",
    "reduced": [],
    "stub": {"width": 8, "coarse_samples": 4, "fine_samples": 8, "near": 2.0, "far": 6.0},
    "train": {"num_rays": 64, "steps_per_call": 1, "cropping_epochs": 10,
              "steps_per_epoch": None, "start_lr": 5e-3, "end_lr": 5e-4,
              "lr_decay_epochs": 1200, "lr_floor": 0.0},
}
LIMITS = {"loss_gap": 1e-6, "moment_gap": 1e-6, "change_gap": 1e-6,
          "forced_moment_angle_median_call": 1e-6}


@pytest.fixture
def stub_benchmark(tmp_path, monkeypatch):
    """The benchmark's files copied, the stub's files and entries added:
    its configuration, its cell's limits, its cell, and the cell's name
    appended to ``train_rays_per_s``'s workloads."""
    shutil.copytree(spec.HERE, tmp_path / "nerfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "nerfbench" / "configs" / "stub_tiny.json").write_text(json.dumps(CONFIG))
    (tmp_path / "nerfbench" / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = spec.benchmark()
    bench["configs"] = [{"name": "stub_tiny", "source": CONFIG["source"],
                         "file": "nerfbench/configs/stub_tiny.json", "reduced": [],
                         "why": "a field that is not the NeRF MLP"}]
    bench["workloads"] = [{"name": CELL, "config": "stub_tiny", "traffic": "train_steps",
                           "chips": 1, "why": "train steps of the stub field"}]
    for m in bench["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", tmp_path / "nerfbench")
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setitem(sys.modules, "nerfbench.fields.stub", stub_field)
    return tmp_path


def test_another_field_runs_through_the_train_kind(stub_benchmark):
    cell = spec.load_cell(CELL)
    assert "nerf" not in cell["config"] and spec.field(cell["config"]) is stub_field
    result = run.run_cell(CELL, 2 ** 31 + 21, 0.3, False, "cpu", {"traffic": TRAIN})
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["checks"]) == set(LIMITS)


def test_another_field_left_unchanged_is_not_correct(stub_benchmark):
    over = {"config": {"stub": {"fault": "unchanged"}}, "traffic": TRAIN}
    result = run.run_cell(CELL, 2 ** 31 + 22, 0.3, False, "cpu", over)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["moment_gap"]["value"] > 0.5
