"""Every cell, configuration, field, traffic, limit and metric of
BENCHMARK.json loads by name, and the file keeps to the benchmark's
contract; the NeRF MLP's counts are tied to its configurations' widths;
the CPU tests' tiny overrides are pinned."""

import json
import re
from pathlib import Path

import pytest

from nerfbench import counts, fields, spec
from nerfbench.reference import nerf as R
from nerfbench.tests.conftest import TRAIN, VIEW, tiny

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CONFIGS = {c["name"]: spec.load_json(spec.ROOT / c["file"]) for c in BENCH["configs"]}
MLP_CONFIGS = [name for name, cfg in CONFIGS.items()
               if spec.field(cfg).__name__ == "nerfbench.fields.nerf_mlp"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nerfbench"]
    assert BENCH["command"] == ["python3", "-m", "nerfbench.run"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c["chips"] == 1
    assert spec.kind(c["traffic"]["kind"]).Cell
    assert c["limits"] and all(v > 0 for v in c["limits"].values())
    assert any(m["name"] == "setup_s" for m in c["end_to_end"])
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads_by_name(metric):
    assert callable(spec.metric_reader(metric))


def test_names_units_and_references():
    configs = {c["name"] for c in BENCH["configs"]}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {w["config"] for w in BENCH["workloads"]} == configs
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for c in BENCH["configs"]:
        assert c["file"] == f"nerfbench/configs/{c['name']}.json"
        assert spec.load_json(spec.ROOT / c["file"])["source"] == c["source"]


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_every_configuration_names_a_field_with_the_whole_interface(cfg):
    """The configuration's field is a module of ``fields/`` that defines
    every name of ``fields.INTERFACE``; its group holds the render's
    samples, and its reference is a ``reference.nerf.Field``."""
    config = CONFIGS[cfg]
    module = spec.field(config)
    name = config.get("field", "nerf_mlp")
    assert module.__name__ == f"nerfbench.fields.{name}"
    assert spec.HERE / "fields" / f"{name}.py" == Path(module.__file__)
    missing = [n for n in fields.INTERFACE if not hasattr(module, n)]
    assert not missing, missing
    assert all(callable(getattr(module, n)) for n in fields.INTERFACE if n != "GROUP")
    assert {"coarse_samples", "fine_samples", "near", "far"} <= set(config[module.GROUP])
    ref = module.reference(config)
    assert isinstance(ref, R.Field) and ref.samples == config[module.GROUP]
    assert module.reference_numerics(config) != module.control_numerics(config)


@pytest.mark.parametrize("cfg", MLP_CONFIGS)
def test_counts_follow_the_widths(cfg):
    """The forward is 460,416 multiply-adds per point at the published
    widths and the package's depth (PERF.md); the model's backward, weight
    gradients plus the activation gradients of the layers that read no
    encoding rows, 887,040; the fused backward kernels execute one
    recomputed forward more, 1,347,456 (PERF.md's kernel count)."""
    config = CONFIGS[cfg]
    nerf = config["nerf"]
    pe, de, h, r = 6 * nerf["position_dim"], 6 * nerf["direction_dim"], nerf["width"], \
        nerf["rgb_width"]
    assert (nerf["trunk_layers"], nerf["feature_layers"]) == (4, 3)
    fwd = pe * h + 3 * h * h + (h + pe) * h + 2 * h * h + h + (h + de) * r + r * 3
    assert counts.fwd_macs(nerf) == fwd == 460_416
    assert counts.bwd_macs(nerf) == 2 * fwd - pe * h - pe * h - de * r == 887_040
    assert counts.kernel_bwd_macs(nerf) - counts.bwd_macs(nerf) == fwd
    assert counts.kernel_bwd_macs(nerf) == 1_347_456
    assert counts.points_per_ray(nerf) == 2 * nerf["coarse_samples"] + nerf["fine_samples"]
    field = spec.field(config)
    assert field.points_per_ray(config) == counts.points_per_ray(nerf)
    assert field.train_flops_per_ray(config) == counts.train_flops_per_ray(nerf)
    assert field.render_flops_per_ray(config) == counts.render_flops_per_ray(nerf)


TINY = {  # (cell) -> the overrides the CPU tests ran each cell at before fields were named
    "train.full": {"config": {"train": {"num_rays": 512},
                              "nerf": {"coarse_samples": 16, "fine_samples": 16}},
                   "traffic": TRAIN},
    "render.full": {"config": {"train": {"num_rays": 512},
                               "nerf": {"coarse_samples": 16, "fine_samples": 16}},
                    "traffic": VIEW},
    "train.fast": {"config": {"train": {"num_rays": 128},
                              "nerf": {"coarse_samples": 16, "fine_samples": 16},
                              "occupancy": {"resolution": 8, "warmup_steps": 4}},
                   "traffic": TRAIN},
    "render.fast": {"config": {"train": {"num_rays": 128},
                               "nerf": {"coarse_samples": 16, "fine_samples": 16},
                               "occupancy": {"resolution": 8, "warmup_steps": 4}},
                    "traffic": VIEW},
}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_overrides_are_pinned(cell):
    assert tiny(cell) == TINY[cell]
    small = tiny(cell, 32, 8)
    assert small["config"]["train"] == {"num_rays": 32}
    assert small["config"]["nerf"] == {"coarse_samples": 8, "fine_samples": 8}
