"""Checkpoints in both directions, the inference entry points and the render
CLI of the port, plus its import boundary."""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from minimal_nerf_torch import inference as t_inf
from minimal_nerf_torch import render as t_render
from minimal_nerf_torch import views as t_views
from minimal_nerf_torch.kernels import fused_raymarch as t_fused
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops import cameras as t_cam
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import trainer as t_trainer
from minimal_nerf_torch.training.config import TrainConfig as TTrainConfig
from minimal_nerf_tpu.models.nerf import NeRFConfig, init_nerf_network
from minimal_nerf_tpu.training import checkpoint as j_ckpt
from minimal_nerf_tpu.training.config import TrainConfig
from minimal_nerf_tpu.training.loop import make_optimizer
from minimal_nerf_tpu.training.trainer import load_state_for_inference as j_load

ROOT = Path(__file__).resolve().parents[1]
SMALL = NeRFConfig(coarse_samples=8, fine_samples=8)


def _jax_ckpt(path, train_cfg=TrainConfig(kernel="fused"), occupancy_grid=None,
              mode="full"):
    params = init_nerf_network(jax.random.PRNGKey(0), SMALL)
    opt_state = make_optimizer(train_cfg, 100).init(params)
    if occupancy_grid is not None:
        opt_state = {"opt": opt_state, "occ_ema": occupancy_grid}
    j_ckpt.save_checkpoint(path, params, opt_state, 7, SMALL.to_dict(), train_cfg.to_dict(),
                           extra={"mode": mode})
    return params


@pytest.fixture(autouse=True)
def _reset_launches():
    t_fused.launches = 0
    yield


def test_jax_checkpoint_loads_in_port(tmp_path):
    path = tmp_path / "model=a-epoch=0-step=7.ckpt"
    params = _jax_ckpt(path)
    tp, ncfg, tcfg, grid, step = t_trainer.load_state_for_inference(path, device="cpu")
    assert (step, grid, tcfg.kernel) == (7, None, "fused")
    assert ncfg.to_dict() == SMALL.to_dict()
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(params)),
                    jax.tree_util.tree_leaves(tp)):
        np.testing.assert_array_equal(a, b.numpy())
    assert tcfg.compute_dtype == torch.bfloat16


def test_port_checkpoint_loads_in_jax(tmp_path):
    g = torch.Generator().manual_seed(3)
    cfg = t_nerf.NeRFConfig()
    tp = t_nerf.init_nerf_network(g, cfg, device="cpu")
    path = t_ckpt.save_checkpoint(tmp_path / t_ckpt.checkpoint_name("b", 2, 9), tp, 9,
                                  cfg.to_dict(), TTrainConfig(kernel="fused").to_dict())
    header, leaves = t_ckpt.load_checkpoint(path)
    assert header["num_leaves"] == len(leaves) == 122
    assert leaves[0].dtype == np.int32 and leaves[0].shape == ()
    assert leaves[81].dtype == np.int32 and leaves[81].shape == ()
    np.testing.assert_array_equal(leaves[82], tp["coarse"]["density"]["b"].numpy())
    np.testing.assert_array_equal(leaves[83], tp["coarse"]["density"]["w"].numpy())
    np.testing.assert_array_equal(leaves[121], tp["fine"]["trunk"][3]["w"].numpy())
    assert sum(leaves[i].size for i in range(82, 122)) == 924680
    jp, ncfg, tcfg, _, step = j_load(path)
    assert step == 9 and tcfg.kernel == "fused" and ncfg == NeRFConfig()
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jp)),
                    jax.tree_util.tree_leaves(tp)):
        np.testing.assert_array_equal(a, b.numpy())
    # and back: the round trip through the port's reader is exact too
    back, *_ = t_trainer.load_state_for_inference(path, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tp)):
        assert torch.equal(a, b)
    assert t_ckpt.parse_epoch_step(path.name) == (2, 9)
    assert t_ckpt.latest_checkpoint(tmp_path) == path
    assert t_ckpt.read_header(path)["step"] == 9


def test_unreadable_checkpoints_raise(tmp_path):
    occ = tmp_path / "occ.ckpt"
    _jax_ckpt(occ, TrainConfig(occupancy=True, occ_resolution=8),
              occupancy_grid=np.zeros((8, 8, 8), np.float32))
    with pytest.raises(NotImplementedError, match="occupancy"):
        t_trainer.load_state_for_inference(occ, device="cpu")
    single = tmp_path / "single.ckpt"
    _jax_ckpt(single, mode="single")
    with pytest.raises(NotImplementedError, match="single"):
        t_trainer.load_state_for_inference(single, device="cpu")
    # a layout the port cannot name (extra optimizer leaves) is not guessed at
    header, leaves = t_ckpt.load_checkpoint(occ)
    header["train_config"]["occupancy"] = False
    odd = tmp_path / "odd.ckpt"
    with open(odd, "wb") as f:  # a file object keeps the .ckpt name
        np.savez(f, __header__=np.frombuffer(json.dumps(header).encode(), np.uint8),
                 **{f"leaf_{i}": v for i, v in leaves.items()})
    with pytest.raises(ValueError, match="leaves"):
        t_trainer.load_state_for_inference(odd, device="cpu")
    with pytest.raises(FileNotFoundError):
        t_trainer.load_state_for_inference(tmp_path / "missing.ckpt", device="cpu")


def test_render_chunk_and_view_on_jax_checkpoint(tmp_path):
    path = tmp_path / "model=a-epoch=0-step=7.ckpt"
    _jax_ckpt(path)
    from minimal_nerf_torch.ops import cameras

    focal = cameras.focal_from_angle(16, t_views.DEFAULT_CAM_ANGLE_X)
    o, d = cameras.get_rays(16, 16, focal, cameras.pose_spherical(30.0, -30.0, 4.0),
                            device="cpu")
    ims = {}
    for kernel in ("fused", "xla"):
        chunk, ncfg, _ = t_inf.build_render_chunk(str(path), 64, kernel=kernel, device="cpu")
        ims[kernel] = t_views.view_reconstruction(chunk, o, d, chunk=64, seed=1)
        again = t_views.view_reconstruction(chunk, o, d, chunk=64, seed=1)
        np.testing.assert_array_equal(ims[kernel], again)
        assert ims[kernel].shape == (16, 16, 3) and ims[kernel].dtype == np.uint8
        assert ims[kernel].std() > 0
    # the orbit sweep renders the same pixels chunk for chunk
    frames = list(t_views.render_poses_batched(
        chunk, cameras.pose_spherical(30.0, -30.0, 4.0)[None], 16, 16, focal, chunk=64,
        frame_seeds=[1], device="cpu"))
    np.testing.assert_array_equal(frames[0], ims["xla"])
    assert t_fused.launches == 0


def test_inference_options_not_ported_raise(tmp_path):
    path = tmp_path / "c.ckpt"
    _jax_ckpt(path)
    with pytest.raises(NotImplementedError, match="data parallel"):
        t_inf.build_render_chunk(str(path), 64, data_parallel=2, device="cpu")
    with pytest.raises(NotImplementedError, match="occupancy"):
        t_inf.build_render_chunk(str(path), 64, bake_occupancy=True, device="cpu")
    with pytest.raises(NotImplementedError, match="point-level"):
        t_inf.build_render_chunk(str(path), 64, kernel="pallas", device="cpu")


def test_resolve_inference_kernel():
    fused, xla = TTrainConfig(kernel="fused"), TTrainConfig(kernel="xla")
    assert t_views.resolve_inference_kernel("auto", fused, "cuda") == "fused"
    assert t_views.resolve_inference_kernel("auto", TTrainConfig(), "cuda") == "fused"
    assert t_views.resolve_inference_kernel("auto", xla, "cuda") == "xla"
    assert t_views.resolve_inference_kernel("auto", fused, "cpu") == "xla"
    assert t_views.resolve_inference_kernel("fused", xla, "cpu") == "fused"


def test_default_device_is_cuda_and_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    path = tmp_path / "c.ckpt"
    _jax_ckpt(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_inf.build_render_chunk(str(path), 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(t_render.render_views(str(path)))
    # the helpers build on the card by default too, never silently on the CPU
    with pytest.raises((AssertionError, RuntimeError)):
        t_nerf.init_nerf_network(torch.Generator(), t_nerf.NeRFConfig())
    with pytest.raises((AssertionError, RuntimeError)):
        t_cam.get_rays(4, 4, 5.0, t_cam.pose_spherical(30.0, -30.0, 4.0))


def test_render_cli_writes_gif(tmp_path):
    path = tmp_path / "model=a-epoch=3-step=7.ckpt"
    _jax_ckpt(path)
    out = t_render.main(["-c", str(path), "-r", "100", "-p", "2", "-s", str(tmp_path / "o"),
                         "--height", "12", "--width", "10", "--device", "cpu"])
    assert out == tmp_path / "o" / "epoch=3-360.gif" and out.stat().st_size > 0
    frames = list(t_render.render_views(str(path), rays=100, num_poses=2, height=12,
                                        width=10, device="cpu"))
    assert len(frames) == 2 and frames[0].shape == (12, 10, 3)
    assert t_fused.launches == 0


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "minimal_nerf_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "minimal_nerf_tpu", "optax"), f"{f}: {mod}"
