"""The Instant-NGP cell ``train.ngp``: its configuration loads through
``spec.load_cell`` with every name of the field interface and the counts of
its widths; on the CPU at tiny size it runs through ``run.run_cell`` and
comes out correct, and a step that leaves its state unchanged, or leaves the
finest level of the table unchanged (the field's planted ``fault``), comes
out not correct; its readers compute their formulas and read nothing
without a trace."""

from types import SimpleNamespace

import pytest

from nerfbench import fields, readings, run, spec
from nerfbench.reference import nerf as R
from nerfbench.reference import ngp as RN
from nerfbench.tests.conftest import tiny

CELL = "train.ngp"
READERS = ("train.mfu.ngp", "hash_encode_fwd_roofline.train", "hash_encode_bwd_roofline.train",
           "hash_encode_share.train")


def test_the_configuration_loads_with_the_whole_interface():
    cell = spec.load_cell(CELL)
    cfg = cell["config"]
    module = spec.field(cfg)
    assert module.__name__ == "nerfbench.fields.ngp" and module.GROUP == "ngp"
    assert all(hasattr(module, name) for name in fields.INTERFACE)
    assert cell["chips"] == 1 and cell["traffic_name"] == "train_steps"
    assert {m["name"] for m in cell["per_layer"]} == set(READERS) | {
        "device.idle_pct.train", "train.draw_ms_per_step", "train.host_ms_per_step"}
    assert [m["name"] for m in cell["end_to_end"]] == ["train_rays_per_s", "setup_s"]
    ngp = cfg["ngp"]
    assert (ngp["levels"], ngp["features"], ngp["log2_table"], ngp["min_resolution"],
            ngp["max_resolution"]) == (16, 2, 19, 16, 2048)
    assert RN.entries(ngp) * ngp["features"] == 12_197_850
    assert module.mlp_macs(cfg) == (9_408, 17_792) and module.points_per_ray(cfg) == 80
    assert module.train_flops_per_ray(cfg) == 2 * (9_408 + 17_792) * 80
    assert module.render_flops_per_ray(cfg) == 2 * 9_408 * 80
    assert module.encode_bytes_per_point(cfg) == 12 + 4 * 32
    ref = module.reference(cfg)
    assert isinstance(ref, R.Field) and ref.samples is cfg["ngp"]
    assert (ref.adam.b1, ref.adam.b2, ref.adam.eps, ref.adam.l2) == (0.9, 0.99, 1e-15, 1e-6)
    assert ref.adam.sparse_leaves == (5,) and ref.adam.l2_leaves == (0, 1, 2, 3, 4)
    assert module.reference_numerics(cfg) != module.control_numerics(cfg)
    assert cfg["train"]["start_lr"] == 1e-2 and cfg["reduced"] == []


def test_a_tiny_run_is_correct():
    result = run.run_cell(CELL, 2 ** 31 + 4321, 0.3, False, "cpu", tiny(CELL))
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert set(result["checks"]) == set(spec.load_cell(CELL)["limits"])


def test_a_state_left_unchanged_is_not_correct():
    with readings.planted("unchanged"):
        result = run.run_cell(CELL, 2 ** 31 + 99, 0.3, False, "cpu", tiny(CELL))
    assert result["correct"] is False, result["checks"]


def test_the_finest_level_left_unchanged_is_not_correct():
    over = tiny(CELL)
    over["config"]["ngp"]["fault"] = "finest"
    result = run.run_cell(CELL, 2 ** 31 + 98, 0.3, False, "cpu", over)
    assert result["correct"] is False, result["checks"]


def _ctx(trace):
    cell = spec.load_cell(CELL)
    return SimpleNamespace(cell=cell, kind="train", device_kind="NVIDIA H100 80GB HBM3",
                           trace=trace, traced={"rays": 4096 * 20, "points": 4096 * 20 * 80,
                                                "steps": 20},
                           window={"rays": 4096 * 2000, "seconds": 10.0})


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_trace_or_the_kernels(name):
    reader = spec.metric_reader(name)
    if name != "train.mfu.ngp":
        assert reader(_ctx(None)) is None
        assert reader(_ctx({"kernel_s": {"fused_bwd_kernel": 1.0}, "busy_s": 1.0})) is None
    assert reader(SimpleNamespace(**dict(vars(_ctx(None)), kind="view"))) is None


def test_readers_formulas():
    trace = {"kernel_s": {"void hash_encode_fwd_kernel<2>(float const*)": 0.02,
                          "void hash_encode_bwd_kernel<2>(float const*)": 0.03,
                          "other": 0.05}, "busy_s": 0.2}
    ctx = _ctx(trace)
    byte_floor = 4096 * 20 * 80 * 140
    fwd = spec.metric_reader("hash_encode_fwd_roofline.train")(ctx)
    bwd = spec.metric_reader("hash_encode_bwd_roofline.train")(ctx)
    assert fwd == pytest.approx(100 * byte_floor / 3.35e12 / 0.02)
    assert bwd == pytest.approx(100 * byte_floor / 3.35e12 / 0.03)
    assert spec.metric_reader("hash_encode_share.train")(ctx) == pytest.approx(25.0)
    mfu = spec.metric_reader("train.mfu.ngp")(ctx)
    assert mfu == pytest.approx(100 * 2 * 27_200 * 80 * 4096 * 2000 / 10.0 / 989e12)
