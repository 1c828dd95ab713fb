"""One tiny run of each cell on the CPU through the package's plain paths
prints the contract's last line; without a card the command prints no
result; no module a run loads is JAX's or the JAX package's, and the
reference loads nothing of the package under test."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from nerfbench import run, spec
from nerfbench.tests.conftest import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
ROOT = spec.ROOT
SEED = 2 ** 31 + 1234


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_the_result_line(cell):
    result = run.run_cell(cell, SEED, 0.3, False, "cpu", tiny(cell))
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in spec.load_cell(cell)["end_to_end"]}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(spec.load_cell(cell)["limits"])


def _command(cwd, *extra):
    return subprocess.run([sys.executable, "-m", "nerfbench.run", "--workload", "train.full",
                           "--seed", "1", "--seconds", "1", *extra], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_bare_benchmark_folder_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "nerfbench", tmp_path / "nerfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


NO_JAX = r"""
import sys
for name in ("jax", "jaxlib", "flax", "minimal_nerf_tpu"):
    sys.modules[name] = None  # an import of these raises
sys.path.insert(0, %r)
from nerfbench import run
from nerfbench.tests.conftest import tiny
for cell in %r:
    run.run_cell(cell, 5, 0.1, False, "cpu", tiny(cell, 32, 8))
print(" ".join(sorted({m.split(".")[0] for m in sys.modules if sys.modules[m] is not None})))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", NO_JAX % (str(ROOT), CELLS)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(out.stdout.split())
    assert "minimal_nerf_torch" in loaded and "nerfbench" in loaded
    assert not loaded & set(run.FORBIDDEN)


REFERENCE_ALONE = r"""
import sys
for name in ("minimal_nerf_torch", "jax", "jaxlib", "minimal_nerf_tpu"):
    sys.modules[name] = None
sys.path.insert(0, %r)
import torch
from nerfbench import counts, spec
from nerfbench.reference import nerf as R
from nerfbench.traffic import generate as gen
cfg = spec.load_json(spec.HERE / "configs" / "nerf_fast_16_48.json")
tr = spec.load_json(spec.HERE / "traffic" / "view_requests.json")
params = gen.weights(1, cfg["nerf"], tr["weights"], "cpu")
grid = gen.grid(1, cfg["occupancy"], tr["grid"], "cpu")
pose = gen.orbit_poses(1, 1, tr, "cpu")[0]
frame = R.render_frame(params, cfg, pose, 4, 4, 5.0, 9, 8, R.reference_numerics(cfg), grid)
print(tuple(frame.shape), sorted({m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}))
"""


def test_reference_loads_nothing_of_the_package():
    out = subprocess.run([sys.executable, "-c", REFERENCE_ALONE % str(ROOT)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("(4, 4, 3)")
    for path in (ROOT / "nerfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("minimal_nerf_torch", "jax", "jaxlib",
                                               "minimal_nerf_tpu") for n in names), path
