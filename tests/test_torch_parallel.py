"""The port's data-parallel layer in one process (mirrors
``tests/test_parallel.py``): the mesh and batch-sharding helpers, a world
of one that is the step without a mesh bit for bit (the train step and the
train CLI's rows and checkpoint), and a render chunk split over one, two
or three devices (the CPU N times) that renders what the unsharded chunk
does bit for bit, through ``views.make_sharded_render_chunk`` and the
render and score CLIs' ``--data-parallel``. The two-rank runs are in
``tests/test_torch_distributed.py``."""

import csv

import numpy as np
import pytest
import torch
import torch.distributed as dist

from minimal_nerf_torch import render as t_render
from minimal_nerf_torch import score as t_score
from minimal_nerf_torch import train as t_train
from minimal_nerf_torch import views as t_views
from minimal_nerf_torch.data import procedural as t_proc
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.parallel import distributed, local_devices, make_mesh, shard_batch
from minimal_nerf_torch.parallel.mesh import Mesh
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import loop as t_loop

NERF = dict(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU work on one thread (see tests/test_torch_trainer.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def world_of_one():
    """A one-rank gloo world on a local coordinator, left afterwards."""
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device="cpu")
    try:
        yield make_mesh(1, device="cpu")
    finally:
        distributed.shutdown()


def test_mesh_without_a_world_is_one_rank():
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    assert make_mesh(1, device="cpu") == mesh
    with pytest.raises(ValueError, match="only 1 ranks"):
        make_mesh(2, device="cpu")
    assert distributed.is_primary()


def test_mesh_of_a_world(world_of_one):
    assert world_of_one.size == 1 and world_of_one.rank == 0
    assert distributed.backend() == "gloo"
    assert distributed.is_primary()
    with pytest.raises(ValueError, match="requested a 3-device mesh"):
        make_mesh(3, device="cpu")


def test_local_devices():
    assert local_devices(2, "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="mesh of 0"):
        local_devices(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            local_devices(1, "cuda")


def test_shard_batch_takes_contiguous_rows():
    x = torch.arange(24).reshape(12, 2)
    shards = [shard_batch(x, Mesh(size=3, rank=r, device=torch.device("cpu")))
              for r in range(3)]
    assert [s.shape for s in shards] == [(4, 2)] * 3
    assert torch.equal(torch.cat(shards), x)
    with pytest.raises(ValueError, match="not divisible by mesh size 5"):
        shard_batch(x, Mesh(size=5, rank=0, device=torch.device("cpu")))


def test_put_replicated_and_step_check_in_a_world_of_one(world_of_one):
    tree = {"a": torch.ones(3), "b": [torch.zeros(2, 2)]}
    assert distributed.put_replicated(tree, world_of_one) is tree
    assert torch.equal(tree["a"], torch.ones(3))
    distributed.check_same_step(7, world_of_one)
    (mean,) = distributed.all_reduce_mean([torch.full((2, 3), 1.5)], world_of_one)
    assert torch.equal(mean, torch.full((2, 3), 1.5))


def test_steps_per_call_refuses_gloo_on_cuda(world_of_one):
    """Several steps per call on CUDA devices replay a CUDA graph, which a
    gloo collective cannot enter: a mesh of two gloo ranks raises at once,
    naming the way out, instead of falling back to eager steps."""
    two = Mesh(size=2, rank=0, device=torch.device("cpu"))
    cfg, tcfg = t_nerf.NeRFConfig(**NERF), t_config.TrainConfig(num_rays=32)
    static = t_loop.SceneStatic(height=8, width=8, focal=10.0, num_frames=1)
    with pytest.raises(ValueError, match="gloo collective.*--steps-per-call 1"):
        t_loop.make_multi_step(cfg, tcfg, static, 4, device="cuda", mesh=two)
    assert callable(t_loop.make_multi_step(cfg, tcfg, static, 4, device="cpu", mesh=two))


def _scene():
    scenes, _ = t_proc.make_procedural_scene((("train", 3),), height=12, width=12,
                                             gt_samples=16, device="cpu")
    return scenes["train"]


@pytest.mark.parametrize("kernel,occupancy", [("fused", False), ("xla", True)])
def test_world_of_one_step_is_the_step_without_a_mesh(world_of_one, kernel, occupancy):
    """Three steps of ``make_train_step`` with a one-rank mesh (its
    all-reduce included) against three without: every leaf, moment and
    metric bit for bit."""
    scene = _scene()
    cfg = t_nerf.NeRFConfig(**NERF)
    tcfg = t_config.TrainConfig(num_rays=32, precision="fp32", occupancy=occupancy,
                                occ_resolution=8, occ_update_every=2, occ_warmup_steps=1)
    occ_cfg = tcfg.occupancy_config
    out = []
    for mesh in (None, world_of_one):
        mlp_apply, render_fn = t_loop.kernel_hooks(kernel, "cpu")
        step = t_loop.make_train_step(cfg, tcfg, t_loop.scene_static(scene), render_fn, "cpu",
                                      mlp_apply, occ_cfg, mesh=mesh)
        params = t_nerf.init_nerf_network(torch.Generator().manual_seed(0), cfg, device="cpu")
        state = t_loop.adam_init(params)
        grid = None
        if occupancy:
            from minimal_nerf_torch.ops import occupancy as occ

            grid = occ.init_grid(occ_cfg, "cpu")
        for s in range(3):
            if occupancy:
                params, state, grid, metrics = step(params, state, grid, scene.images,
                                                    scene.poses, s, 0)
            else:
                params, state, metrics = step(params, state, scene.images, scene.poses, s, 0)
        out.append((t_ckpt.flatten_tree([params, state["mu"], state["nu"]]) +
                    ([grid] if occupancy else []), metrics))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    assert out[0][1].keys() == out[1][1].keys()
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_world_of_one_cli_run_is_the_run_without_a_mesh(fixture_scene, tmp_path):
    """``train --data-parallel 1 --device cpu`` (a one-rank gloo world in
    this process) against the same run without the flag: every logged
    value but the timings, and the final checkpoint, bit for bit; the world
    is left afterwards."""
    timing = {"iterations_per_sec", "rays_per_sec", "train iteration speed", "wall_seconds",
              "val_seconds", "ckpt_seconds"}
    rows, leaves = {}, {}
    for name, extra in (("plain", []), ("dp1", ["--data-parallel", "1"])):
        t_train.main(["--device", "cpu", "-n", name, "-s", "6", "-r", "32", "--precision",
                      "fp32", "--log-every", "2", "-rd", str(tmp_path), *extra, "full", "-b",
                      str(fixture_scene), "-c", "8", "-f", "8"])
        with open(tmp_path / name / "metrics.csv", newline="") as f:
            rows[name] = [{k: v for k, v in r.items() if k not in timing}
                          for r in csv.DictReader(f)]
        _, lv = t_ckpt.load_checkpoint(t_ckpt.latest_checkpoint(tmp_path / name / "checkpoints"))
        leaves[name] = lv
    assert not dist.is_initialized()
    assert len(rows["plain"]) == 3 and rows["plain"] == rows["dp1"]
    assert sorted(leaves["plain"]) == sorted(leaves["dp1"])
    for i in leaves["plain"]:
        np.testing.assert_array_equal(leaves["plain"][i], leaves["dp1"][i])


def test_sharded_render_chunk_equals_one_device():
    """``make_sharded_render_chunk`` over ``["cpu"]`` and ``["cpu", "cpu"]``
    (and three shards of a ragged chunk) against the unsharded chunk on the same
    generator state: the colors bit for bit, under uniform and occupancy
    sampling."""
    from minimal_nerf_torch.ops import occupancy as occ

    cfg = t_nerf.NeRFConfig(**NERF)
    params = t_nerf.init_nerf_network(torch.Generator().manual_seed(3), cfg, device="cpu")
    occ_cfg = occ.OccupancyConfig(resolution=8)
    grid = torch.rand((8, 8, 8), generator=torch.Generator().manual_seed(4)) * 0.05
    words = occ.pack_occupancy(grid, occ_cfg)
    g = torch.Generator().manual_seed(5)
    o = torch.tensor([0.0, 0.0, 4.0]).expand(70, 3).contiguous()
    d = torch.nn.functional.normalize(torch.randn(70, 3, generator=g) * 0.1
                                      + torch.tensor([0.0, 0.0, -1.0]), dim=-1)
    for sampler_cfg in (None, occ_cfg):
        sampler = None if sampler_cfg is None else occ.make_occupancy_sampler(words, occ_cfg)
        chunk = t_views.make_fine_render_chunk(params, cfg, coarse_sampler=sampler)
        want = chunk(o, d, torch.Generator().manual_seed(9))
        for n in (1, 2, 3):
            sharded = t_views.make_sharded_render_chunk(
                [chunk] * n, ["cpu"] * n,
                lambda k, gen: t_nerf.draw_render_uniforms(cfg, k, gen, "cpu", sampler_cfg))
            got = sharded(o, d, torch.Generator().manual_seed(9))
            assert got.shape == (70, 3) and torch.equal(got, want), (sampler_cfg, n)


def _ckpt(tmp_path):
    cfg = t_nerf.NeRFConfig(**NERF)
    params = t_nerf.init_nerf_network(torch.Generator().manual_seed(0), cfg, device="cpu",
                                      gain=2.0)
    return str(t_ckpt.save_checkpoint(tmp_path / "m-epoch=1-step=5.ckpt", params, 5,
                                      cfg.to_dict(),
                                      t_config.TrainConfig(precision="fp32").to_dict()))


@pytest.mark.parametrize("kernel", ["xla", "fused", "pallas"])
def test_render_data_parallel_equals_one_device(tmp_path, kernel):
    """``render_views`` at the default (``data_parallel=1``) and at
    ``data_parallel=2`` on the CPU twice: the frames of the unsharded
    chunk (``views.make_fine_render_chunk`` with the kernel's hooks) byte
    for byte."""
    from minimal_nerf_torch.kernels.fused_raymarch import make_fused_render_fn
    from minimal_nerf_torch.kernels.raymarch import make_mlp_kernel_apply
    from minimal_nerf_torch.training.trainer import load_state_for_inference

    ckpt = _ckpt(tmp_path)
    params, cfg, tcfg, _, _ = load_state_for_inference(ckpt, device="cpu")
    hooks = {"fused": dict(render_fn=make_fused_render_fn()),
             "pallas": dict(mlp_apply=make_mlp_kernel_apply())}.get(kernel, {})
    unsharded = t_views.make_fine_render_chunk(params, cfg, compute_dtype=tcfg.compute_dtype,
                                               **hooks)
    want = list(t_views.orbit_views(unsharded, height=16, width=16, chunk=64, num_poses=2,
                                    device="cpu"))
    assert len(want) == 2 and want[0].std() > 0
    for dp in ({}, {"data_parallel": 2}):
        got = list(t_render.render_views(ckpt, 64, 2, 16, 16, kernel=kernel, device="cpu",
                                         **dp))
        assert len(got) == 2, dp
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_render_and_score_clis_data_parallel(tmp_path, fixture_scene):
    """The render CLI's gif and the score CLI's scores at ``--data-parallel
    2 --device cpu`` equal those at the default (one device)."""
    ckpt = _ckpt(tmp_path)
    gifs = []
    for dp in ([], ["--data-parallel", "2"]):
        out = t_render.main(["-c", ckpt, "-r", "64", "-p", "2", "--height", "16", "--width",
                             "16", "-s", str(tmp_path), "--device", "cpu", *dp])
        gifs.append(out.read_bytes())
    assert gifs[0] == gifs[1]
    scores = [t_score.main(["-c", ckpt, "-r", "1024", "-b", str(fixture_scene), "--device",
                            "cpu", *dp]) for dp in ([], ["--data-parallel", "2"])]
    assert scores[0] == scores[1] and all(np.isfinite(scores[0]))
