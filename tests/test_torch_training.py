"""The port's train step and data modules against the JAX package.

Same weights (``params_from_jax``), same ray batch and the same draws on
both sides; the JAX render runs its Pallas kernels in interpret mode. On
the CPU the port runs its kernels' plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minimal_nerf_torch.data import procedural as t_proc
from minimal_nerf_torch.kernels import fused_raymarch as t_fused
from minimal_nerf_torch.kernels import occupancy_probe as t_probe
from minimal_nerf_torch.kernels import raymarch as t_rm
from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops import cameras as t_cam
from minimal_nerf_torch.ops import occupancy as t_occ
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import loop as t_loop
from minimal_nerf_torch.training.checkpoint import flatten_tree
from minimal_nerf_torch.utils import profiling
from minimal_nerf_tpu.data import procedural as j_proc
from minimal_nerf_tpu.kernels import fused_raymarch as j_fused
from minimal_nerf_tpu.kernels import raymarch as j_rm
from minimal_nerf_tpu.models import mlp as j_mlp
from minimal_nerf_tpu.models import nerf as j_nerf
from minimal_nerf_tpu.ops import cameras as j_cam
from minimal_nerf_tpu.ops import occupancy as j_occ
from minimal_nerf_tpu.training import config as j_config
from minimal_nerf_tpu.training import loop as j_loop

HE_GAIN = np.sqrt(6.0)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _he(jp):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, np.float32) * (HE_GAIN if path[-1].key == "w" else 1.0),
        jax.device_get(jp))


@pytest.mark.parametrize("floor", [0.0, 2e-4])
def test_lr_schedule_matches_jax(floor):
    kw = dict(start_lr=5e-4, end_lr=5e-5, lr_decay_epochs=30, lr_floor=floor)
    j_sched = j_loop.make_lr_schedule(j_config.TrainConfig(**kw), 20)
    t_sched = t_loop.make_lr_schedule(t_config.TrainConfig(**kw), 20)
    for step in (0, 1, 19, 20, 21, 399, 400, 1000, 100_000):
        want = np.float32(jax.jit(j_sched)(jnp.int32(step)))
        got = t_sched(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=2e-7, atol=0)


def test_adam_matches_optax():
    """Three updates from the same gradients under a decaying LR: optax's
    Adam and the port's agree to within 1e-5 of a step (XLA may contract the
    moment updates into FMAs, which moves a few updates by an ulp)."""
    jp = jax.device_get(j_mlp.init_nerf_mlp(jax.random.PRNGKey(0), width=16, rgb_width=8))
    cfg = dict(start_lr=5e-4, end_lr=5e-5, lr_decay_epochs=4)
    tx = optax.adam(learning_rate=j_loop.make_lr_schedule(j_config.TrainConfig(**cfg), 1))
    t_sched = t_loop.make_lr_schedule(t_config.TrainConfig(**cfg), 1)
    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    j_state = tx.init(j_params)
    tp = t_mlp.params_from_jax(jp, "cpu")
    t_state = t_loop.adam_init(tp)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) * 1e-3, jp)
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_state = t_loop.adam_update(tp, t_mlp.params_from_jax(g, "cpu"), t_state,
                                     t_sched(t_state["count"]))
        for a, b in zip(flatten_tree(jax.device_get(j_params)), flatten_tree(tp)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=5e-9)
    assert t_state["count"] == 3 and int(j_state[0].count) == 3
    for a, b in zip(flatten_tree(jax.device_get(j_state[0].nu)), flatten_tree(t_state["nu"])):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=0)


def _jax_draws(key, n, cfg):
    """The uniforms JAX ``render_rays_fused`` draws from ``key``."""
    k_coarse, k_cdf = jax.random.split(key)
    k_eps, k_jit = jax.random.split(k_cdf)
    u = lambda k, shape: T(jax.random.uniform(k, shape, dtype=jnp.float32))  # noqa: E731
    return {"coarse": u(k_coarse, (n, cfg.coarse_samples)), "eps": u(k_eps, (n, 1)),
            "jitter": u(k_jit, (n, cfg.fine_samples, 1))}


def _assert_step_matches(metrics, grads, tp, j_loss, j_grads, j_after, lr=5e-4):
    """Loss, gradients, their global norm and the parameters after the first
    Adam step of the port (``metrics``, ``grads``, ``tp``) against JAX."""
    np.testing.assert_allclose(float(metrics["train_loss"]), float(j_loss), rtol=1e-5)
    # gradients per leaf relative to the leaf's max (fp32 sum orders differ)
    for a, b in zip(flatten_tree(jax.device_get(j_grads)), flatten_tree(grads)):
        assert np.abs(b.numpy() - a).max() <= 5e-5 * np.abs(a).max()
    np.testing.assert_allclose(float(metrics["grad_2.0_norm_total"]),
                               float(optax.global_norm(j_grads)), rtol=1e-5)
    # the first Adam step moves each weight by lr * g / (|g| + eps): ~lr *
    # sign(g), where a 5e-5 gradient difference moves it by < 1e-3 * lr. Only
    # where |g| is within a few eps of 0 can the two steps differ by up to
    # 2 * lr (one element of the 4096 of trunk[1] here; the many exact zeros
    # of dead ReLU units move neither side).
    for a, b, g in zip(flatten_tree(jax.device_get(j_after)), flatten_tree(tp),
                       flatten_tree(jax.device_get(j_grads))):
        diff = np.abs(b.detach().numpy() - a)
        near_zero = np.abs(g) < 1e-6
        assert diff[~near_zero].max(initial=0) <= 1e-3 * lr
        assert diff[near_zero].max(initial=0) <= 2 * lr


def test_train_step_matches_jax():
    """Loss, gradients, the parameters after Adam and the LR of one step on
    a shared batch and shared draws, fp32 (position_dim 4: see
    tests/test_torch_fused_raymarch.py for why the fp32 comparison keeps the
    encoding's angles small)."""
    jcfg = j_nerf.NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
    tcfg = t_nerf.NeRFConfig(**jcfg.to_dict())
    keys = jax.random.split(jax.random.PRNGKey(3))
    jp = {k: _he(j_mlp.init_nerf_mlp(key, 4, 2, width=64, rgb_width=32))
          for k, key in zip(("coarse", "fine"), keys)}
    n = 8
    rng = np.random.default_rng(4)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = (rng.normal(size=(n, 3)) - [0.0, 0.0, 2.0]).astype(np.float32)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    train = dict(start_lr=5e-4, end_lr=5e-5, lr_decay_epochs=10)

    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    render_fn = j_fused.make_fused_render_fn(ray_tile=8, interpret=True)
    (j_loss, _), j_grads = jax.value_and_grad(j_loop.nerf_loss, has_aux=True)(
        j_params, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(rgb), key,
        render_fn=render_fn)
    tx = j_loop.make_optimizer(j_config.TrainConfig(**train), 1)
    updates, _ = tx.update(j_grads, tx.init(j_params), j_params)
    j_after = optax.apply_updates(j_params, updates)

    tp = t_mlp.params_from_jax(jp, "cpu")
    batch = {"origin": T(o), "direc": T(d), "rgb": T(rgb)}
    metrics, grads = t_loop.loss_and_grads(tp, tcfg, batch,
                                           render_fn=t_fused.make_fused_render_fn(),
                                           uniforms=_jax_draws(key, n, jcfg))
    t_sched = t_loop.make_lr_schedule(t_config.TrainConfig(**train), 1)
    t_loop.adam_update(tp, grads, t_loop.adam_init(tp), t_sched(0))
    metrics = t_loop.finalize_metrics(metrics, grads)

    _assert_step_matches(metrics, grads, tp, j_loss, j_grads, j_after)


def test_pallas_train_step_matches_jax():
    """One step of the ``--kernel pallas`` path (the point kernels' MLP hook
    under the plain render, ``kernel_hooks("pallas", "cpu")``) against JAX
    ``nerf_loss`` + ``jax.value_and_grad`` + optax with
    ``make_pallas_mlp_apply(interpret=True, differentiable=True)``: loss,
    gradients, density metrics and the parameters after Adam on a shared
    batch and shared draws, fp32 at position_dim 4 (as above)."""
    jcfg = j_nerf.NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
    tcfg = t_nerf.NeRFConfig(**jcfg.to_dict())
    keys = jax.random.split(jax.random.PRNGKey(13))
    jp = {k: _he(j_mlp.init_nerf_mlp(key, 4, 2, width=64, rgb_width=32))
          for k, key in zip(("coarse", "fine"), keys)}
    n = 8
    rng = np.random.default_rng(14)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = (rng.normal(size=(n, 3)) - [0.0, 0.0, 2.0]).astype(np.float32)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(15)
    train = dict(start_lr=5e-4, end_lr=5e-5, lr_decay_epochs=10)

    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    mlp_apply = j_rm.make_pallas_mlp_apply(tile=64, interpret=True, differentiable=True)
    (j_loss, j_metrics), j_grads = jax.value_and_grad(j_loop.nerf_loss, has_aux=True)(
        j_params, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(rgb), key,
        mlp_apply=mlp_apply)
    j_metrics = j_loop.finalize_metrics(j_metrics, j_grads, 1)
    tx = j_loop.make_optimizer(j_config.TrainConfig(**train), 1)
    updates, _ = tx.update(j_grads, tx.init(j_params), j_params)
    j_after = optax.apply_updates(j_params, updates)

    tp = t_mlp.params_from_jax(jp, "cpu")
    mlp_hook, render_fn = t_loop.kernel_hooks("pallas", "cpu")
    assert render_fn is t_nerf.render_rays
    batch = {"origin": T(o), "direc": T(d), "rgb": T(rgb)}
    metrics, grads = t_loop.loss_and_grads(tp, tcfg, batch, render_fn=render_fn,
                                           uniforms=_jax_draws(key, n, jcfg), mlp_apply=mlp_hook)
    t_loop.adam_update(tp, grads, t_loop.adam_init(tp),
                       t_loop.make_lr_schedule(t_config.TrainConfig(**train), 1)(0))
    metrics = t_loop.finalize_metrics(metrics, grads)

    assert set(metrics) == set(j_metrics)
    _assert_step_matches(metrics, grads, tp, j_loss, j_grads, j_after)
    for name in ("coarse", "fine"):
        # the norms of 64 / 128 fp32 densities, and the counts of non-zero ones
        np.testing.assert_allclose(float(metrics[f"{name}_density_norms"]),
                                   float(j_metrics[f"{name}_density_norms"]), rtol=1e-5)
        assert float(metrics[f"{name}_density_non_zeros"]) == float(
            j_metrics[f"{name}_density_non_zeros"]) > 0


def test_kernel_hooks():
    mlp_apply, render_fn = t_loop.kernel_hooks("fused", "cpu")
    assert mlp_apply is None and render_fn is not t_nerf.render_rays
    for kernel, device in (("xla", "cuda"), ("auto", "cpu")):
        assert t_loop.kernel_hooks(kernel, device) == (None, t_nerf.render_rays)
    mlp_apply, render_fn = t_loop.kernel_hooks("auto", "cuda")
    assert mlp_apply is None and render_fn is not t_nerf.render_rays
    with pytest.raises(ValueError):
        t_loop.kernel_hooks("triton", "cpu")


def _orbit_rays(seed, n):
    """Rays from a sphere of radius 4 toward the origin: their bins cross
    the occupancy grid's box ``[-3.2, 3.2]^3`` and leave it."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = (-o / 4.0 + 0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    return o, d, rng.uniform(size=(n, 3)).astype(np.float32)


def _jax_occ_draws(key, n, cfg):
    """The uniforms JAX's render draws from ``key`` under the occupancy
    sampler: its eps and in-bin jitter split from the coarse key."""
    k_coarse, k_cdf = jax.random.split(key)
    k_occ_eps, k_frac = jax.random.split(k_coarse)
    k_eps, k_jit = jax.random.split(k_cdf)
    u = lambda k, shape: T(jax.random.uniform(k, shape, dtype=jnp.float32))  # noqa: E731
    return {"coarse": (u(k_occ_eps, (n, 1)), u(k_frac, (n, cfg.coarse_samples))),
            "eps": u(k_eps, (n, 1)), "jitter": u(k_jit, (n, cfg.fine_samples, 1))}


@pytest.mark.parametrize("case", ["fused", "warmup", "pallas"])
def test_occupancy_train_step_matches_jax(case):
    """One occupancy step against JAX's pieces of
    ``make_train_step(..., occupancy_cfg=...)``: ``_occ_step_context`` (the
    EMA update on the jitter of the occupancy stream, the packed words, the
    occupied fraction) and the ``make_occupancy_loss`` loss over the fused
    render (``fused``; ``warmup``: every cell forced occupied) or the point
    kernels' hook (``pallas``), then optax's Adam; shared weights, batch and
    draws, fp32 at position_dim 4 (see test_train_step_matches_jax). The
    grid within 1e-5 of its largest value (fp32 sum orders), the words and
    the fraction exact."""
    jcfg = j_nerf.NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
    tcfg = t_nerf.NeRFConfig(**jcfg.to_dict())
    keys = jax.random.split(jax.random.PRNGKey(23))
    jp = {k: _he(j_mlp.init_nerf_mlp(key, 4, 2, width=64, rgb_width=32))
          for k, key in zip(("coarse", "fine"), keys)}
    n, g, step = 8, 8, 4
    o, d, rgb = _orbit_rays(24, n)
    occ_kw = dict(resolution=g, update_every=4, num_bins=16,
                  warmup_steps=8 if case == "warmup" else 0)
    j_occ_cfg, t_occ_cfg = j_occ.OccupancyConfig(**occ_kw), t_occ.OccupancyConfig(**occ_kw)
    grid0 = np.random.default_rng(25).uniform(0, 0.02, (g, g, g)).astype(np.float32)
    step_key, render_key = jax.random.PRNGKey(26), jax.random.PRNGKey(27)
    train = dict(start_lr=5e-4, end_lr=5e-5, lr_decay_epochs=10)

    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    j_grid, j_words, j_frac = j_loop._occ_step_context(
        j_occ_cfg, jcfg, None, j_params, jnp.asarray(grid0), jnp.int32(step), step_key)
    if case == "pallas":
        mlp_apply = j_rm.make_pallas_mlp_apply(tile=64, interpret=True, differentiable=True)
        base = j_loop.nerf_loss
    else:
        mlp_apply = None
        base = functools.partial(j_loop.nerf_loss, render_fn=j_fused.make_fused_render_fn(
            ray_tile=8, interpret=True))
    loss_fn = j_loop.make_occupancy_loss(j_occ_cfg, base_loss_fn=base)
    (j_loss, _), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        j_params, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(rgb), render_key, None,
        mlp_apply, j_words)
    tx = j_loop.make_optimizer(j_config.TrainConfig(**train), 1)
    updates, _ = tx.update(j_grads, tx.init(j_params), j_params)
    j_after = optax.apply_updates(j_params, updates)

    tp = t_mlp.params_from_jax(jp, "cpu")
    grid = T(grid0)
    jitter = T(jax.random.uniform(jax.random.fold_in(step_key, 0x0CC), (g ** 3, 3)))
    t_loop.update_step_grid(t_occ_cfg, tcfg, None, tp, grid, step, 0, jitter=jitter)
    words, frac = t_loop.pack_step_grid(t_occ_cfg, grid, step < t_occ_cfg.warmup_steps)
    j_grid = np.asarray(j_grid)
    assert np.abs(grid.numpy() - j_grid).max() <= 1e-5 * j_grid.max()
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(j_words))
    assert float(frac) == float(j_frac)
    if case == "warmup":
        assert float(frac) == 1.0
    else:
        assert 0.1 < float(frac) < 0.9
    mlp_hook, render_fn = t_loop.kernel_hooks("pallas" if case == "pallas" else "fused", "cpu")
    batch = {"origin": T(o), "direc": T(d), "rgb": T(rgb)}
    metrics, grads = t_loop.loss_and_grads(
        tp, tcfg, batch, render_fn=render_fn, uniforms=_jax_occ_draws(render_key, n, jcfg),
        mlp_apply=mlp_hook, coarse_sampler=t_occ.make_occupancy_sampler(words, t_occ_cfg))
    t_loop.adam_update(tp, grads, t_loop.adam_init(tp),
                       t_loop.make_lr_schedule(t_config.TrainConfig(**train), 1)(0))
    _assert_step_matches(t_loop.finalize_metrics(metrics, grads), grads, tp, j_loss, j_grads,
                         j_after)


@pytest.mark.parametrize("kernel", ["fused", "pallas", "xla"])
def test_make_train_step_with_occupancy_runs_and_learns(kernel):
    """Six occupancy steps on a tiny procedural scene under each of
    ``kernel_hooks``' choices: the grid updated in place at steps 0, 2 and 4
    only, every cell occupied during the 2 warmup steps, ``occ_fraction``
    among the metrics, the loss on a fixed batch lower after the steps, no
    kernel launched on the CPU."""
    cfg = t_nerf.NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
    scenes, _ = t_proc.make_procedural_scene((("train", 3),), height=10, width=10,
                                             gt_samples=16, scene="object", device="cpu")
    scene = scenes["train"]
    tcfg = t_config.TrainConfig(num_rays=32, precision="fp32", cropping_epochs=0,
                                start_lr=5e-3, occupancy=True, occ_resolution=8,
                                occ_update_every=2, occ_warmup_steps=2, occ_num_bins=16)
    occ_cfg = tcfg.occupancy_config
    params = t_nerf.init_nerf_network(torch.Generator().manual_seed(0), cfg, device="cpu")
    for mlp in params.values():
        mlp["density"]["b"] += 0.5
    mlp_apply, render_fn = t_loop.kernel_hooks(kernel, "cpu")
    step_fn = t_loop.make_train_step(cfg, tcfg, t_loop.scene_static(scene), render_fn=render_fn,
                                     device="cpu", mlp_apply=mlp_apply, occupancy_cfg=occ_cfg)
    batch = t_loop.sample_train_batch(0, scene.images, scene.poses, t_loop.scene_static(scene),
                                      32, 3, 0, seed=0, generator=torch.Generator().manual_seed(1))
    u = torch.Generator().manual_seed(2)
    draws = {"coarse": torch.rand((32, 8), generator=u), "eps": torch.rand((32, 1), generator=u),
             "jitter": torch.rand((32, 8, 1), generator=u)}

    def fixed_loss():
        with torch.no_grad():
            return float(t_loop.nerf_loss(params, cfg, batch["origin"], batch["direc"],
                                          batch["rgb"], render_fn=render_fn, uniforms=draws,
                                          mlp_apply=mlp_apply)[0])

    before = fixed_loss()
    grid = t_occ.init_grid(occ_cfg, "cpu")
    state = t_loop.adam_init(params)
    profiling.reset()
    fractions, changed = [], []
    for step in range(6):
        prev = grid.clone()
        out, state, out_grid, metrics = step_fn(params, state, grid, scene.images, scene.poses,
                                                step, 0)
        assert out is params and out_grid is grid
        changed.append(not torch.equal(prev, grid))
        fractions.append(float(metrics["occ_fraction"]))
    assert changed == [True, False, True, False, True, False]
    assert fractions[:2] == [1.0, 1.0] and all(0.0 <= f <= 1.0 for f in fractions)
    assert {"train_loss", "grad_2.0_norm_total", "lr", "occ_fraction"} <= set(metrics)
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert state["count"] == 6 and fixed_loss() < before
    assert not any(profiling.counter(n) for n in (t_fused.FWD_LAUNCHES, t_fused.BWD_LAUNCHES,
                                                  t_rm.FWD_LAUNCHES, t_probe.LAUNCHES))


def _tiny_scene(frames=5, hw=12):
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, size=(frames, hw, hw, 3), dtype=np.uint8)
    poses = np.stack([t_cam.pose_spherical(-180 + 72 * i, -30.0, 4.0)
                      for i in range(frames)]).astype(np.float32)
    focal = t_cam.focal_from_angle(hw, 0.6911112070083618)
    return images, poses, focal


def test_sample_train_batch_frames_crop_and_rays():
    images, poses, focal = _tiny_scene()
    static = t_loop.SceneStatic(height=12, width=12, focal=focal, num_frames=5)
    ti, tpz = torch.from_numpy(images), torch.from_numpy(poses)
    gen = torch.Generator().manual_seed(0)
    for epoch in range(3):
        frames = [t_loop.sample_train_batch(epoch * 5 + k, ti, tpz, static, 64, 5, 1, seed=7,
                                            generator=gen)["frame"] for k in range(5)]
        assert sorted(frames) == list(range(5))  # each frame once per epoch
    crop = t_loop.sample_train_batch(0, ti, tpz, static, 512, 5, 1, seed=7, generator=gen)
    full = t_loop.sample_train_batch(5, ti, tpz, static, 512, 5, 1, seed=7, generator=gen)
    for b, lo, hi in ((crop, 3, 9), (full, 0, 12)):
        for c in (b["xs"], b["ys"]):
            assert int(c.min()) == lo and int(c.max()) == hi - 1
    # the pixels and rays of given coordinates against JAX
    xs, ys = np.array([0, 11, 5, 3]), np.array([2, 0, 11, 7])
    b = t_loop.sample_train_batch(7, ti, tpz, static, 4, 5, 1, seed=7, coords=(xs, ys))
    jo, jd = j_cam.rays_for_pixels(jnp.asarray(xs), jnp.asarray(ys), 12, 12, focal,
                                   jnp.asarray(poses[b["frame"]]))
    np.testing.assert_allclose(b["origin"].numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b["direc"].numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(b["rgb"].numpy(),
                                  images[b["frame"], ys, xs].astype(np.float32) / 255.0)


@pytest.mark.parametrize("render", ["fused", "plain", "pallas"])
def test_make_train_step_runs_and_learns(render):
    """Five steps on a tiny procedural scene: finite metrics under the JAX
    names (the plain render, with or without the point kernels' hook,
    reports the density metrics; the fused render has none, as in JAX),
    parameters and moments updated in place, the loss on a fixed batch with
    fixed draws lower after the steps."""
    cfg = t_nerf.NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
    scenes, _ = t_proc.make_procedural_scene((("train", 3),), height=10, width=10,
                                             gt_samples=16, scene="object", device="cpu")
    scene = scenes["train"]
    static = t_loop.scene_static(scene)
    tcfg = t_config.TrainConfig(num_rays=32, precision="fp32", cropping_epochs=0,
                                start_lr=5e-3)
    params = t_nerf.init_nerf_network(torch.Generator().manual_seed(0), cfg, device="cpu")
    for mlp in params.values():
        mlp["density"]["b"] += 0.5
    render_fn = None if render == "fused" else t_nerf.render_rays
    mlp_apply = t_rm.make_mlp_kernel_apply() if render == "pallas" else None
    step_fn = t_loop.make_train_step(cfg, tcfg, static, render_fn=render_fn, device="cpu",
                                     mlp_apply=mlp_apply)
    batch = t_loop.sample_train_batch(0, scene.images, scene.poses, static, 32, 3, 0, seed=0,
                                      generator=torch.Generator().manual_seed(1))
    u = torch.Generator().manual_seed(2)
    draws = {"coarse": torch.rand((32, 8), generator=u), "eps": torch.rand((32, 1), generator=u),
             "jitter": torch.rand((32, 8, 1), generator=u)}

    def fixed_loss():
        with torch.no_grad():
            return float(t_loop.nerf_loss(params, cfg, batch["origin"], batch["direc"],
                                          batch["rgb"], render_fn=render_fn, uniforms=draws,
                                          mlp_apply=mlp_apply)[0])

    before = fixed_loss()
    state = t_loop.adam_init(params)
    first = flatten_tree(params)[0].detach().clone()
    for step in range(5):
        out, state, metrics = step_fn(params, state, scene.images, scene.poses, step, 0)
        assert out is params
    density = {f"{k}_density_{m}" for k in ("coarse", "fine") for m in ("norms", "non_zeros")}
    assert set(metrics) == {"train_loss", "train_coarse_loss", "train_fine_loss",
                            "grad_2.0_norm_total", "lr"} | (set() if render == "fused" else density)
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert state["count"] == 5 and not torch.equal(first, flatten_tree(params)[0])
    assert fixed_loss() < before
    assert profiling.counter(t_fused.FWD_LAUNCHES) == profiling.counter(t_fused.BWD_LAUNCHES) == 0
    assert profiling.counter(t_rm.FWD_LAUNCHES) == profiling.counter(t_rm.BWD_LAUNCHES) == 0


@pytest.mark.parametrize("maker", ["random", "random_object"])
def test_sphere_field_matches_jax(maker):
    jf, tf = getattr(j_proc.SphereField, maker)(3), getattr(t_proc.SphereField, maker)(3)
    for k in ("centers", "radii", "colors", "densities"):
        np.testing.assert_array_equal(getattr(tf, k), getattr(jf, k))
    pts = np.random.default_rng(0).uniform(-1.2, 1.2, size=(64, 5, 3)).astype(np.float32)
    js, jr = jf.field(jnp.asarray(pts))
    ts_, tr = tf.field(T(pts))
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)


def test_analytic_view_matches_jax():
    field = j_proc.SphereField.random_object(1)
    pose = t_cam.pose_spherical(30.0, -30.0, 4.0)
    h = w = 12
    focal = t_cam.focal_from_angle(w, 0.6911112070083618)
    ref = j_proc.render_analytic_view(field, pose, h, w, focal, num_samples=32, chunk=h * w)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)  # the JAX chunk's jitter key
    u = T(jax.random.uniform(key, (h * w, 32), dtype=jnp.float32))
    got = t_proc.render_analytic_view(t_proc.SphereField.random_object(1), pose, h, w, focal,
                                      num_samples=32, uniforms=u, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    assert ref.std() > 10  # the view shows the object
    # uint8 truncation: an ulp of difference can move a channel by one level
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
