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
from minimal_nerf_torch.kernels import raymarch as t_rm
from minimal_nerf_torch.kernels import occupancy_probe as t_probe
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops import cameras as t_cam
from minimal_nerf_torch.ops import occupancy as t_occ
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import loop as t_loop
from minimal_nerf_torch.training import trainer as t_trainer
from minimal_nerf_torch.training.config import TrainConfig as TTrainConfig
from minimal_nerf_torch.utils import profiling
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
    profiling.reset()
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
    # an occupancy run whose file lacks the grid, or holds one of another
    # resolution, is not guessed at
    no_grid = tmp_path / "no_grid.ckpt"
    _jax_ckpt(no_grid, TrainConfig(occupancy=True, occ_resolution=8))
    with pytest.raises(ValueError, match="occupancy grid"):
        t_trainer.load_state_for_inference(no_grid, device="cpu")
    header, leaves = t_ckpt.load_checkpoint(occ)
    header["train_config"]["occ_resolution"] = 16
    wrong_g = tmp_path / "wrong_g.ckpt"
    with open(wrong_g, "wb") as f:
        np.savez(f, __header__=np.frombuffer(json.dumps(header).encode(), np.uint8),
                 **{f"leaf_{i}": v for i, v in leaves.items()})
    with pytest.raises(ValueError, match="leaf 0"):
        t_trainer.load_state_for_inference(wrong_g, device="cpu")
    # a single-mode header over a full network's leaves is not guessed at,
    # and render and score refuse single checkpoints by their mode
    single = tmp_path / "single.ckpt"
    _jax_ckpt(single, mode="single")
    with pytest.raises(ValueError, match="needs 62"):
        t_trainer.load_state_for_inference(single, device="cpu")
    with pytest.raises(ValueError, match="single"):
        t_inf.build_render_chunk(str(single), 64, device="cpu")
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


def _port_state(seed, cfg, steps=2):
    """Port params and the Adam state after ``steps`` updates on random
    gradients (moments and counts not zero)."""
    g = torch.Generator().manual_seed(seed)
    tp = t_nerf.init_nerf_network(g, cfg, device="cpu")
    state = t_loop.adam_init(tp)
    for _ in range(steps):
        grads = {k: jax.tree_util.tree_map(lambda t: torch.randn(t.shape, generator=g), v)
                 for k, v in tp.items()}
        state = t_loop.adam_update(tp, grads, state, torch.tensor(1e-3))
    return tp, state


@pytest.mark.parametrize("occupancy", [False, True])
def test_port_checkpoint_resumes_in_jax(tmp_path, occupancy):
    """A port-written checkpoint with the train step's Adam state (122
    leaves; 123 with an occupancy grid at leaf 0) loads in JAX's
    ``load_state_for_inference`` with the same params and grid, and JAX's
    ``restore_state`` resumes from it with the same moments and counts; the
    port's ``restore_state`` reads back the same."""
    tp, state = _port_state(4, SMALL)
    tcfg = TTrainConfig(kernel="fused", occupancy=occupancy, occ_resolution=8)
    grid = torch.rand((8, 8, 8), generator=torch.Generator().manual_seed(5)) if occupancy else None
    path = t_ckpt.save_checkpoint(tmp_path / t_ckpt.checkpoint_name("o", 1, 30), tp, 30,
                                  SMALL.to_dict(), tcfg.to_dict(), opt_state=state, grid=grid)
    header, leaves = t_ckpt.load_checkpoint(path)
    head = 1 if occupancy else 0
    assert header["num_leaves"] == len(leaves) == 122 + head
    assert leaves[head].dtype == np.int32 and int(leaves[head]) == 2 == int(leaves[head + 81])
    jp, _, jcfg, j_grid, step = j_load(path)
    assert step == 30 and jcfg.occupancy == occupancy
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jp)), jax.tree_util.tree_leaves(tp)):
        np.testing.assert_array_equal(a, b.numpy())
    if occupancy:
        np.testing.assert_array_equal(np.asarray(j_grid), grid.numpy())
    else:
        assert j_grid is None
    # JAX resumes: its trainer's restore against its own templates
    j_params = init_nerf_network(jax.random.PRNGKey(0), SMALL)
    opt = make_optimizer(TrainConfig(**jcfg.to_dict()), 100).init(j_params)
    template = {"opt": opt, "occ_ema": np.zeros((8, 8, 8), np.float32)} if occupancy else opt
    _, j_opt = j_ckpt.restore_state(header, leaves, j_params, template)
    adam = (j_opt["opt"] if occupancy else j_opt)[0]
    assert int(adam.count) == 2
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(getattr(adam, name))),
                        jax.tree_util.tree_leaves(state[name])):
            np.testing.assert_array_equal(a, b.numpy())
    # and the port reads its own file back
    shapes = {k: jax.tree_util.tree_map(lambda t: tuple(t.shape), v) for k, v in tp.items()}
    params, opt_state, back_grid = t_ckpt.restore_state(header, leaves, shapes,
                                                        (8, 8, 8) if occupancy else None)
    assert opt_state["count"] == 2
    for a, b in zip(t_ckpt.flatten_tree(opt_state["nu"]) + t_ckpt.flatten_tree(params),
                    t_ckpt.flatten_tree(state["nu"]) + t_ckpt.flatten_tree(tp)):
        np.testing.assert_array_equal(a, b.numpy())
    assert (back_grid is None) == (not occupancy)


def test_jax_occupancy_checkpoint_loads_in_port(tmp_path):
    """A JAX occupancy checkpoint (grid in the optimizer slot, Adam moments
    after two updates): the port loads its params, grid and save step, and
    its ``restore_state`` gives JAX's moments and count."""
    jcfg = TrainConfig(kernel="fused", occupancy=True, occ_resolution=8)
    params = init_nerf_network(jax.random.PRNGKey(0), SMALL)
    tx = make_optimizer(jcfg, 100)
    opt = tx.init(params)
    for i in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: jax.random.normal(jax.random.PRNGKey(i), a.shape), params)
        _, opt = tx.update(grads, opt, params)
    grid = np.random.default_rng(6).uniform(0, 1, (8, 8, 8)).astype(np.float32)
    path = tmp_path / "model=j-epoch=0-step=7.ckpt"
    j_ckpt.save_checkpoint(path, params, {"opt": opt, "occ_ema": grid}, 7, SMALL.to_dict(),
                           jcfg.to_dict(), extra={"mode": "full"})
    tp, ncfg, tcfg, t_grid, step = t_trainer.load_state_for_inference(path, device="cpu")
    assert step == 7 and tcfg.occupancy_config.resolution == 8 and ncfg.to_dict() == SMALL.to_dict()
    assert t_grid.dtype == torch.float32 and t_grid.shape == (8, 8, 8)
    np.testing.assert_array_equal(t_grid.numpy(), grid)
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(params)),
                    jax.tree_util.tree_leaves(tp)):
        np.testing.assert_array_equal(a, b.numpy())
    header, leaves = t_ckpt.load_checkpoint(path)
    shapes = {k: jax.tree_util.tree_map(lambda t: tuple(t.shape), v) for k, v in tp.items()}
    _, opt_state, _ = t_ckpt.restore_state(header, leaves, shapes, (8, 8, 8))
    assert opt_state["count"] == 2 == int(opt[0].count)
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(opt[0].mu)),
                    t_ckpt.flatten_tree(opt_state["mu"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("saved_at", [300, 100])  # after, inside the 256-step warmup
def test_render_chunk_with_occupancy_grid(tmp_path, saved_at):
    """An occupancy checkpoint renders through its grid (packed with every
    cell forced occupied when saved inside the warmup): the pixels of the
    plain render with the occupancy sampler built by hand. With
    ``ignore_occupancy`` the pixels of the uniform render. No probe kernel
    runs on the CPU."""
    tp, state = _port_state(7, SMALL, steps=0)
    for mlp in tp.values():
        mlp["density"]["b"] += 0.5
    tcfg = TTrainConfig(kernel="fused", occupancy=True, occ_resolution=16, occ_num_bins=16)
    occ_cfg = tcfg.occupancy_config
    grid = torch.rand((16, 16, 16), generator=torch.Generator().manual_seed(8)) * 0.02
    path = t_ckpt.save_checkpoint(tmp_path / t_ckpt.checkpoint_name("o", 2, saved_at), tp,
                                  saved_at, SMALL.to_dict(), tcfg.to_dict(), opt_state=state,
                                  grid=grid)
    focal = t_cam.focal_from_angle(12, t_views.DEFAULT_CAM_ANGLE_X)
    o, d = t_cam.get_rays(12, 12, focal, t_cam.pose_spherical(30.0, -30.0, 4.0), device="cpu")
    view = lambda chunk: t_views.view_reconstruction(chunk, o, d, chunk=64, seed=1)  # noqa: E731
    profiling.reset()
    chunk, _, _ = t_inf.build_render_chunk(str(path), 64, kernel="xla", device="cpu")
    words = t_occ.pack_occupancy(grid, occ_cfg, force_all=saved_at < occ_cfg.warmup_steps)
    by_hand = t_views.make_fine_render_chunk(tp, SMALL, compute_dtype=torch.bfloat16,
                                             coarse_sampler=t_occ.make_occupancy_sampler(
                                                 words, occ_cfg))
    im = view(chunk)
    np.testing.assert_array_equal(im, view(by_hand))
    uniform = view(t_views.make_fine_render_chunk(tp, SMALL, compute_dtype=torch.bfloat16))
    assert not np.array_equal(im, uniform)
    ignored, _, _ = t_inf.build_render_chunk(str(path), 64, kernel="xla", ignore_occupancy=True,
                                             device="cpu")
    np.testing.assert_array_equal(view(ignored), uniform)
    # and through the fused render's plain version
    fused, _, _ = t_inf.build_render_chunk(str(path), 64, kernel="fused", device="cpu")
    assert view(fused).shape == (12, 12, 3)
    assert profiling.counter(t_probe.LAUNCHES) == profiling.counter(t_fused.FWD_LAUNCHES) == 0


def test_bake_occupancy_on_a_uniform_checkpoint(tmp_path):
    """``bake_occupancy`` on a checkpoint without a grid: a 4-pass bake drawn
    from a generator seeded with 0, never warmup-forced, attached as the
    coarse sampler. The render CLI takes ``--ignore-occupancy``."""
    # He-uniform weights: the densities vary, and a bake marks some cells
    tp = t_nerf.init_nerf_network(torch.Generator().manual_seed(9), SMALL, device="cpu",
                                  gain=np.sqrt(6.0))
    path = t_ckpt.save_checkpoint(tmp_path / "model=u-epoch=4-step=7.ckpt", tp, 7,
                                  SMALL.to_dict(), TTrainConfig(kernel="fused").to_dict())
    baked, _, tcfg = t_inf.build_render_chunk(str(path), 64, kernel="xla", coarse=8, fine=8,
                                              bake_occupancy=True, device="cpu")
    params, ncfg, *_ = t_trainer.load_state_for_inference(path, device="cpu")
    occ_cfg = t_occ.OccupancyConfig()
    grid = t_occ.bake_grid(params, ncfg.position_dim, ncfg.direction_dim, occ_cfg,
                           torch.Generator().manual_seed(0), compute_dtype=tcfg.compute_dtype)
    by_hand = t_views.make_fine_render_chunk(
        params, ncfg, compute_dtype=tcfg.compute_dtype,
        coarse_sampler=t_occ.make_occupancy_sampler(t_occ.pack_occupancy(grid, occ_cfg),
                                                    occ_cfg))
    focal = t_cam.focal_from_angle(8, t_views.DEFAULT_CAM_ANGLE_X)
    o, d = t_cam.get_rays(8, 8, focal, t_cam.pose_spherical(30.0, -30.0, 4.0), device="cpu")
    im = t_views.view_reconstruction(baked, o, d, chunk=64, seed=1)
    np.testing.assert_array_equal(im, t_views.view_reconstruction(by_hand, o, d, chunk=64,
                                                                  seed=1))
    assert 0.0 < float(t_occ.occupancy_mask(grid, occ_cfg).float().mean()) < 1.0
    out = t_render.main(["-c", str(path), "-r", "64", "-p", "1", "-s", str(tmp_path / "o"),
                         "--height", "8", "--width", "8", "--device", "cpu",
                         "--ignore-occupancy"])
    assert out.stat().st_size > 0


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
    assert profiling.counter(t_fused.FWD_LAUNCHES) == 0


def test_inference_options_not_ported_raise(tmp_path):
    path = tmp_path / "c.ckpt"
    _jax_ckpt(path)
    with pytest.raises(ValueError, match="negative"):
        t_inf.build_render_chunk(str(path), 64, data_parallel=-1, device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        t_inf.build_render_chunk(str(path), 64, kernel="triton", device="cpu")


def test_resolve_inference_kernel():
    fused, xla = TTrainConfig(kernel="fused"), TTrainConfig(kernel="xla")
    assert t_views.resolve_inference_kernel("auto", fused, "cuda") == "fused"
    assert t_views.resolve_inference_kernel("auto", TTrainConfig(), "cuda") == "fused"
    assert t_views.resolve_inference_kernel("auto", xla, "cuda") == "xla"
    assert t_views.resolve_inference_kernel("auto", fused, "cpu") == "xla"
    assert t_views.resolve_inference_kernel("fused", xla, "cpu") == "fused"
    # the point-level kernel path: chosen by a pallas-trained checkpoint on
    # a card, kept when asked for explicitly (on the CPU: its plain version)
    pallas = TTrainConfig(kernel="pallas")
    assert t_views.resolve_inference_kernel("auto", pallas, "cuda") == "pallas"
    assert t_views.resolve_inference_kernel("auto", pallas, "cpu") == "xla"
    assert t_views.resolve_inference_kernel("pallas", fused, "cpu") == "pallas"


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
    assert profiling.counter(t_fused.FWD_LAUNCHES) == 0


def test_render_cli_gif_does_not_depend_on_frames_per_dispatch(tmp_path):
    """``--frames-per-dispatch 1`` and ``8`` (3 poses: one batch, or three)
    write the same gif bytes."""
    path = tmp_path / "model=a-epoch=3-step=7.ckpt"
    _jax_ckpt(path)
    gifs = [t_render.main(["-c", str(path), "-r", "64", "-p", "3", "-s", str(tmp_path / str(n)),
                           "--height", "8", "--width", "9", "--frames-per-dispatch", str(n),
                           "--device", "cpu"]).read_bytes() for n in (1, 8)]
    assert gifs[0] == gifs[1] and len(gifs[0]) > 0


def test_pallas_checkpoint_renders_through_the_point_kernel(tmp_path, monkeypatch):
    """A checkpoint trained under ``--kernel pallas``: an explicit
    ``--kernel pallas`` on the CPU renders through the point kernels' plain
    version (the render CLI writes a gif), and its pixels are those of the
    plain render around ``nerf_mlp_kernel_apply``."""
    path = tmp_path / "model=p-epoch=1-step=7.ckpt"
    _jax_ckpt(path, TrainConfig(kernel="pallas"))
    applied = []
    orig = t_rm.nerf_mlp_kernel_apply
    monkeypatch.setattr(t_rm, "nerf_mlp_kernel_apply",
                        lambda *a, **k: applied.append(1) or orig(*a, **k))
    focal = t_cam.focal_from_angle(12, t_views.DEFAULT_CAM_ANGLE_X)
    o, d = t_cam.get_rays(12, 12, focal, t_cam.pose_spherical(30.0, -30.0, 4.0), device="cpu")
    chunk, _, tcfg = t_inf.build_render_chunk(str(path), 64, kernel="pallas", device="cpu")
    assert tcfg.kernel == "pallas" and tcfg.compute_dtype == torch.bfloat16
    im = t_views.view_reconstruction(chunk, o, d, chunk=64, seed=1)
    assert len(applied) == 2 * 3  # coarse and fine pass of each of 3 chunks
    params, ncfg, *_ = t_trainer.load_state_for_inference(path, device="cpu")
    plain = t_views.make_fine_render_chunk(params, ncfg, compute_dtype=torch.bfloat16,
                                           mlp_apply=orig)
    np.testing.assert_array_equal(im, t_views.view_reconstruction(plain, o, d, chunk=64, seed=1))
    assert im.shape == (12, 12, 3) and im.std() > 0
    out = t_render.main(["-c", str(path), "-r", "100", "-p", "1", "-s", str(tmp_path / "o"),
                         "--height", "8", "--width", "8", "--kernel", "pallas",
                         "--device", "cpu"])
    assert out == tmp_path / "o" / "epoch=1-360.gif" and out.stat().st_size > 0
    assert profiling.counter(t_rm.FWD_LAUNCHES) == 0


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
