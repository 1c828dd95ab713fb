"""Every cell, configuration, traffic, limit and metric of BENCHMARK.json
loads by name, and the file keeps to the benchmark's contract; the counts
are tied to the configurations' widths."""

import json
import re

import pytest

from nerfbench import counts, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


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


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_counts_follow_the_widths(cfg):
    """The forward is 460,416 multiply-adds per point at the published
    widths and the package's depth (PERF.md); the model's backward, weight
    gradients plus the activation gradients of the layers that read no
    encoding rows, 887,040; the fused backward kernels execute one
    recomputed forward more, 1,347,456 (PERF.md's kernel count)."""
    nerf = spec.load_json(spec.HERE / "configs" / f"{cfg}.json")["nerf"]
    pe, de, h, r = 6 * nerf["position_dim"], 6 * nerf["direction_dim"], nerf["width"], \
        nerf["rgb_width"]
    assert (nerf["trunk_layers"], nerf["feature_layers"]) == (4, 3)
    fwd = pe * h + 3 * h * h + (h + pe) * h + 2 * h * h + h + (h + de) * r + r * 3
    assert counts.fwd_macs(nerf) == fwd == 460_416
    assert counts.bwd_macs(nerf) == 2 * fwd - pe * h - pe * h - de * r == 887_040
    assert counts.kernel_bwd_macs(nerf) - counts.bwd_macs(nerf) == fwd
    assert counts.kernel_bwd_macs(nerf) == 1_347_456
    assert counts.points_per_ray(nerf) == 2 * nerf["coarse_samples"] + nerf["fine_samples"]
