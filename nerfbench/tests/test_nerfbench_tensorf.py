"""The TensoRF cell ``train.tensorf``: its configuration loads through
``spec.load_cell`` with every name of the field interface and the counts of
its widths; on the CPU at tiny size it runs through ``run.run_cell`` and
comes out correct, and a step that leaves its state unchanged, or leaves
one appearance plane unchanged (the field's planted ``fault``), comes out
not correct; the reference loads nothing of the package; its readers
compute their formulas and read nothing without a trace."""

import ast
from types import SimpleNamespace

import pytest

from nerfbench import fields, readings, run, spec
from nerfbench.reference import nerf as R
from nerfbench.tests.conftest import tiny

CELL = "train.tensorf"
READERS = ("train.mfu.tensorf", "vm_sample_fwd_roofline.train", "vm_sample_bwd_roofline.train",
           "vm_sample_share.train")


def test_the_configuration_loads_with_the_whole_interface():
    cell = spec.load_cell(CELL)
    cfg = cell["config"]
    module = spec.field(cfg)
    assert module.__name__ == "nerfbench.fields.tensorf" and module.GROUP == "tensorf"
    assert all(hasattr(module, name) for name in fields.INTERFACE)
    assert cell["chips"] == 1 and cell["traffic_name"] == "train_steps"
    assert {m["name"] for m in cell["per_layer"]} == set(READERS) | {
        "device.idle_pct.train", "train.draw_ms_per_step", "train.host_ms_per_step"}
    assert [m["name"] for m in cell["end_to_end"]] == ["train_rays_per_s", "setup_s"]
    t = cfg["tensorf"]
    assert (t["resolution"], t["density_components"], t["app_components"], t["app_dim"],
            t["feature_width"], t["feature_pe"], t["view_pe"]) == (300, 16, 48, 27, 128, 2, 2)
    assert module.mlp_macs(cfg) == (39_856, 77_792) and module.points_per_ray(cfg) == 80
    assert module.mlp_macs(cfg)[0] == 144 * 27 + 150 * 128 + 128 * 128 + 128 * 3
    assert module.train_flops_per_ray(cfg) == 2 * (39_856 + 77_792) * 80
    assert module.render_flops_per_ray(cfg) == 2 * 39_856 * 80
    assert module.vm_bytes_per_point(cfg) == 12 + 4 * (1 + 144)
    ref = module.reference(cfg)
    assert isinstance(ref, R.Field) and ref.samples is cfg["tensorf"]
    assert (ref.adam.b1, ref.adam.b2, ref.adam.eps) == (0.9, 0.99, 1e-8)
    assert ref.adam.scales == (1.0, 1.0, 0.05, 1.0, 1.0) + (0.05,) * 6
    assert ref.adam.l1[3:5] == (1.0 / (300 * 16), 1.0 / (300 * 300 * 16))
    assert module.reference_numerics(cfg) != module.control_numerics(cfg)
    assert cfg["train"]["start_lr"] == 0.02 and cfg["reduced"] == []


def test_the_reference_imports_nothing_of_the_package():
    path = spec.HERE / "reference" / "tensorf.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            assert not any(n.split(".")[0] in ("minimal_nerf_torch", "minimal_nerf_tpu", "jax")
                           for n in names), names


def test_a_tiny_run_is_correct():
    result = run.run_cell(CELL, 2 ** 31 + 4321, 0.3, False, "cpu", tiny(CELL))
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert set(result["checks"]) == set(spec.load_cell(CELL)["limits"])


def test_a_state_left_unchanged_is_not_correct():
    with readings.planted("unchanged"):
        result = run.run_cell(CELL, 2 ** 31 + 99, 0.3, False, "cpu", tiny(CELL))
    assert result["correct"] is False, result["checks"]


def test_an_appearance_plane_left_unchanged_is_not_correct():
    over = tiny(CELL)
    over["config"]["tensorf"]["fault"] = "plane"
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
    if name != "train.mfu.tensorf":
        assert reader(_ctx(None)) is None
        assert reader(_ctx({"kernel_s": {"hash_encode_bwd_kernel": 1.0}, "busy_s": 1.0})) is None
    assert reader(SimpleNamespace(**dict(vars(_ctx(None)), kind="view"))) is None


def test_readers_formulas():
    trace = {"kernel_s": {"void vm_sample_fwd_kernel<true>(float const*)": 0.02,
                          "void vm_sample_fwd_kernel<false>(float const*)": 0.001,
                          "vm_sample_bwd_kernel(float const*, long long)": 0.03,
                          "other": 0.05}, "busy_s": 0.2}
    ctx = _ctx(trace)
    byte_floor = 4096 * 20 * 80 * 592
    fwd = spec.metric_reader("vm_sample_fwd_roofline.train")(ctx)
    bwd = spec.metric_reader("vm_sample_bwd_roofline.train")(ctx)
    assert fwd == pytest.approx(100 * byte_floor / 3.35e12 / 0.021)
    assert bwd == pytest.approx(100 * byte_floor / 3.35e12 / 0.03)
    assert spec.metric_reader("vm_sample_share.train")(ctx) == pytest.approx(25.5)
    mfu = spec.metric_reader("train.mfu.tensorf")(ctx)
    assert mfu == pytest.approx(100 * 2 * (39_856 + 77_792) * 80 * 4096 * 2000 / 10.0 / 989e12)
