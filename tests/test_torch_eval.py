"""The port's eval steps against the JAX package's: the batched val
losses on replayed pixels and draws, uniform and through an occupancy grid,
the fused render on both sides (JAX's in interpret mode, the port's plain
version on the CPU). Small: position_dim 4, 8 + 8 samples, 32 rays, fp32,
the fixture tree's two val frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimal_nerf_torch.data.synthetic import SyntheticScene as TScene
from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops import occupancy as t_occ
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import loop as t_loop
from minimal_nerf_tpu.data import synthetic as j_synth
from minimal_nerf_tpu.kernels import fused_raymarch as j_fused
from minimal_nerf_tpu.models import mlp as j_mlp
from minimal_nerf_tpu.models import nerf as j_nerf
from minimal_nerf_tpu.ops import occupancy as j_occ
from minimal_nerf_tpu.training import config as j_config
from minimal_nerf_tpu.training import loop as j_loop

NERF = dict(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
TRAIN = dict(num_rays=32, precision="fp32", kernel="fused")
CASES = {"uniform": {}, "occupancy": dict(occupancy=True, occ_resolution=8, occ_num_bins=16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny CPU runs take one thread: with a thread per core in every
    parallel test worker, PyTorch's threads mostly wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _train_cfg(case):
    return dict(TRAIN, **CASES[case])


def _he(jp):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, np.float32) * (np.sqrt(6.0) if path[-1].key == "w" else 1.0),
        jax.device_get(jp))


def _draws(key, n, occupancy):
    """The uniforms JAX's fused render draws from ``key`` (with the
    occupancy sampler: its eps and in-bin jitter from the coarse key)."""
    k_coarse, k_cdf = jax.random.split(key)
    k_eps, k_jit = jax.random.split(k_cdf)
    u = lambda k, shape: torch.from_numpy(np.array(  # noqa: E731
        jax.random.uniform(k, shape, dtype=jnp.float32)))
    if occupancy:
        k_occ_eps, k_frac = jax.random.split(k_coarse)
        coarse = (u(k_occ_eps, (n, 1)), u(k_frac, (n, NERF["coarse_samples"])))
    else:
        coarse = u(k_coarse, (n, NERF["coarse_samples"]))
    return {"coarse": coarse, "eps": u(k_eps, (n, 1)),
            "jitter": u(k_jit, (n, NERF["fine_samples"], 1))}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_eval_matches_jax(fixture_scene, case):
    """``make_batched_eval_step`` against JAX's on the val split: each
    frame's pixels and draws replayed from JAX's key stream
    (``fold_in(base_key, 10_000_000 + step + idx)``), shared He weights, the
    fused render (JAX in interpret mode); with occupancy through the same
    packed grid. The three mean losses within rtol 3e-5 / atol 1e-6."""
    occupancy = case == "occupancy"
    jcfg = j_nerf.NeRFConfig(**NERF)
    j_tcfg = j_config.TrainConfig(**_train_cfg(case))
    t_tcfg = t_config.TrainConfig(**_train_cfg(case))
    keys = jax.random.split(jax.random.PRNGKey(41))
    jp = {k: _he(j_mlp.init_nerf_mlp(key, 4, 2, width=64, rgb_width=32))
          for k, key in zip(("coarse", "fine"), keys)}
    j_val = j_synth.SyntheticScene.load(fixture_scene, "val")
    t_val = TScene.load(fixture_scene, "val", device="cpu")
    static = j_loop.scene_static(j_val)
    j_ctx, words = (), None
    if occupancy:
        grid = np.random.default_rng(42).uniform(0, 0.02, (8, 8, 8)).astype(np.float32)
        j_words = j_occ.pack_occupancy(jnp.asarray(grid), j_tcfg.occupancy_config)
        words = t_occ.pack_occupancy(torch.from_numpy(grid), t_tcfg.occupancy_config)
        np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(j_words))
        frac = float(t_occ.occupancy_mask(torch.from_numpy(grid), t_tcfg.occupancy_config)
                     .float().mean())
        assert 0.1 < frac < 0.9
        j_ctx = (j_words,)
    j_eval = j_loop.make_batched_eval_step(
        jcfg, j_tcfg, static, render_fn=j_fused.make_fused_render_fn(ray_tile=8, interpret=True),
        occupancy_cfg=j_tcfg.occupancy_config)
    arrays = j_val.device_arrays()
    base_key, step = jax.random.PRNGKey(43), 6
    want = jax.device_get(j_eval(jax.tree_util.tree_map(jnp.asarray, jp), arrays["images"],
                                 arrays["poses"], step, base_key, *j_ctx))

    coords, uniforms = [], []
    for idx in range(j_val.num_frames):
        key = jax.random.fold_in(base_key, 10_000_000 + step + idx)
        xs, ys = j_synth.sample_random_coordinates(key, 32, static.height, static.width)
        coords.append((np.asarray(xs), np.asarray(ys)))
        uniforms.append(_draws(jax.random.fold_in(key, 1), 32, occupancy))
    _, render_fn = t_loop.kernel_hooks("fused", "cpu")
    t_eval = t_loop.make_batched_eval_step(t_nerf.NeRFConfig(**NERF), t_tcfg,
                                           t_loop.scene_static(t_val), render_fn=render_fn,
                                           occupancy_cfg=t_tcfg.occupancy_config)
    got = t_eval(t_mlp.params_from_jax(jp, "cpu"), t_val.images, t_val.poses, step, 0, words,
                 coords=coords, uniforms=uniforms)
    assert sorted(got) == sorted(want) == ["val_coarse_loss", "val_fine_loss", "val_loss"]
    for k in want:
        assert got[k].shape == () and not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=3e-5, atol=1e-6)
    assert float(want["val_loss"]) > 1e-3


def test_batched_eval_draws_differ_by_frame_and_step(fixture_scene):
    """Without replayed draws each frame and step draws its own pixels
    (the val stream of ``(seed, step + idx)``), and a step repeats."""
    t_val = TScene.load(fixture_scene, "val", device="cpu")
    cfg = t_config.TrainConfig(**_train_cfg("uniform"))
    params = t_nerf.init_nerf_network(torch.Generator().manual_seed(0),
                                      t_nerf.NeRFConfig(**NERF), device="cpu")
    t_eval = t_loop.make_batched_eval_step(t_nerf.NeRFConfig(**NERF), cfg,
                                           t_loop.scene_static(t_val))
    a, b, c = (t_eval(params, t_val.images, t_val.poses, s, 0)["val_loss"] for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
