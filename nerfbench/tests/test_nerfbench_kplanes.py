"""The K-Planes cell ``train.kplanes``: its configuration loads through
``spec.load_cell`` with every name of the field interface and the counts of
its widths; the reference loads nothing of the package; on the CPU at tiny
size a step that leaves the finest scale's first plane unchanged (the
field's planted ``fault``) comes out not correct (the control, an unchanged
state and half the batch are ``test_nerfbench_check.py``'s, for every
cell); its readers compute their formulas and read nothing without a
trace.

The planted fault runs at a base resolution of 16 (planes of 16^2 to 128^2)
in place of 64: the fault leaves a third of the finest scale's leaf
unchanged at any resolution, and the published 33.4 M plane entries would
spend most of the run in Adam on the CPU."""

import ast
from types import SimpleNamespace

import pytest

from nerfbench import fields, run, spec
from nerfbench.reference import nerf as R
from nerfbench.tests.conftest import tiny

CELL = "train.kplanes"
READERS = ("train.mfu.kplanes", "kplane_sample_fwd_roofline.train",
           "kplane_sample_bwd_roofline.train", "kplane_sample_share.train")


def test_the_configuration_loads_with_the_whole_interface():
    cell = spec.load_cell(CELL)
    cfg = cell["config"]
    module = spec.field(cfg)
    assert module.__name__ == "nerfbench.fields.kplanes" and module.GROUP == "kplanes"
    assert all(hasattr(module, name) for name in fields.INTERFACE)
    assert cell["chips"] == 1 and cell["traffic_name"] == "train_steps"
    assert {m["name"] for m in cell["per_layer"]} == set(READERS) | {
        "device.idle_pct.train", "train.draw_ms_per_step", "train.host_ms_per_step"}
    assert [m["name"] for m in cell["end_to_end"]] == ["train_rays_per_s", "setup_s"]
    k = cfg["kplanes"]
    assert (k["base_resolution"], k["multiscale"], k["features"], k["density_width"],
            k["geo_features"], k["color_width"], k["color_layers"], k["sh_degree"]) == (
        64, [1, 2, 4, 8], 32, 64, 15, 64, 2, 4)
    assert (k["bound"], k["tv_weight"]) == (1.3, 1e-4)
    assert module.mlp_macs(cfg) == (15_488, 29_952) and module.points_per_ray(cfg) == 80
    assert module.mlp_macs(cfg)[0] == 128 * 64 + 64 * 16 + (16 + 15) * 64 + 64 * 64 + 64 * 3
    assert module.train_flops_per_ray(cfg) == 2 * (15_488 + 29_952) * 80
    assert module.render_flops_per_ray(cfg) == 2 * 15_488 * 80
    assert module.plane_bytes_per_point(cfg) == 12 + 4 * 128 == 524
    shapes = module.shapes(k)
    assert sum(3 * r * r * 32 for _, r, _, _ in shapes["planes"]) == 33_423_360
    ref = module.reference(cfg)
    assert isinstance(ref, R.Field) and ref.samples is cfg["kplanes"]
    assert (ref.adam.b1, ref.adam.b2, ref.adam.eps) == (0.9, 0.999, 1e-15)
    assert ref.adam.planes == (False,) * 5 + (True,) * 4 and ref.adam.tv_weight == 1e-4
    assert module.reference_numerics(cfg) != module.control_numerics(cfg)
    assert cfg["train"]["start_lr"] == 0.01 and cfg["reduced"] == []


def test_the_reference_imports_nothing_of_the_package():
    path = spec.HERE / "reference" / "kplanes.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            assert not any(n.split(".")[0] in ("minimal_nerf_torch", "minimal_nerf_tpu", "jax")
                           for n in names), names


def test_a_plane_left_unchanged_is_not_correct():
    over = tiny(CELL)
    over["config"]["kplanes"].update(base_resolution=16, fault="plane")
    result = run.run_cell(CELL, 2 ** 31 + 98, 0.3, False, "cpu", over)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["change_gap"]["value"] > result["checks"]["change_gap"]["limit"]


def _ctx(trace):
    cell = spec.load_cell(CELL)
    return SimpleNamespace(cell=cell, kind="train", device_kind="NVIDIA H100 80GB HBM3",
                           trace=trace, traced={"rays": 4096 * 20, "points": 4096 * 20 * 80,
                                                "steps": 20},
                           window={"rays": 4096 * 2000, "seconds": 10.0})


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_trace_or_the_kernels(name):
    reader = spec.metric_reader(name)
    if name != "train.mfu.kplanes":
        assert reader(_ctx(None)) is None
        assert reader(_ctx({"kernel_s": {"vm_sample_bwd_kernel": 1.0}, "busy_s": 1.0})) is None
    assert reader(SimpleNamespace(**dict(vars(_ctx(None)), kind="view"))) is None


def test_readers_formulas():
    trace = {"kernel_s": {"kplane_sample_fwd_kernel(float const*, long long)": 0.02,
                          "kplane_sample_bwd_kernel(float const*, long long)": 0.03,
                          "vm_sample_bwd_kernel(float const*, long long)": 0.04,
                          "other": 0.05}, "busy_s": 0.2}
    ctx = _ctx(trace)
    byte_floor = 4096 * 20 * 80 * 524
    fwd = spec.metric_reader("kplane_sample_fwd_roofline.train")(ctx)
    bwd = spec.metric_reader("kplane_sample_bwd_roofline.train")(ctx)
    assert fwd == pytest.approx(100 * byte_floor / 3.35e12 / 0.02)
    assert bwd == pytest.approx(100 * byte_floor / 3.35e12 / 0.03)
    assert spec.metric_reader("kplane_sample_share.train")(ctx) == pytest.approx(25.0)
    mfu = spec.metric_reader("train.mfu.kplanes")(ctx)
    assert mfu == pytest.approx(100 * 2 * (15_488 + 29_952) * 80 * 4096 * 2000 / 10.0 / 989e12)
