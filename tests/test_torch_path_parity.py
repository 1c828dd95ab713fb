"""The ``--kernel pallas`` train path against the fused one, step by step.

Both paths run the port's own train step body (``loop.make_multi_step``,
one step per call, eagerly on the CPU: the same body ``make_train_step``
runs) with their render hooks built once and kept across the steps, as a
training run keeps them: the point kernels' hook with its per-version
packing cache (``kernel_hooks("pallas", "cpu")``) and the fused render
(``kernel_hooks("fused", "cpu")``), each through its kernels' plain
versions. Same init (JAX ``init_nerf_mlp`` with He gains, carried over by
``params_from_jax``), same batches and draws (JAX's, from one key per
step), fp32, 5 steps at a tiny size. After the last step the pallas side
is also held against JAX's ``make_pallas_mlp_apply(interpret=True,
differentiable=True)`` with optax's Adam on the same draws.

The tolerance is tests/test_fused_raymarch.py:49's (rtol 3e-5, atol 1e-6)
for every element except those whose gradient came within 1e-6 of 0 at a
step so far on either side: there Adam's normalised update ``g / (|g| +
eps)`` turns a last-bit difference of ``g`` into a step of up to ``2 lr``
(as in tests/test_torch_training.py::_assert_step_matches), so those may
differ by up to ``2 lr`` per step taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops import cameras as t_cam
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import loop as t_loop
from minimal_nerf_torch.training.checkpoint import flatten_tree
from minimal_nerf_tpu.kernels import raymarch as j_rm
from minimal_nerf_tpu.models import mlp as j_mlp
from minimal_nerf_tpu.models import nerf as j_nerf
from minimal_nerf_tpu.training import config as j_config
from minimal_nerf_tpu.training import loop as j_loop

HE_GAIN = np.sqrt(6.0)
STEPS, RAYS, HW = 5, 64, 16
NERF = dict(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
# one frame per epoch: the staircase LR decays at every step
TRAIN = dict(num_rays=RAYS, precision="fp32", cropping_epochs=0, start_lr=5e-4, end_lr=5e-5,
             lr_decay_epochs=10, steps_per_epoch=1)
# tests/test_fused_raymarch.py:49; Adam's near-zero gradients (module doc)
RTOL, ATOL, NEAR_ZERO = 3e-5, 1e-6, 1e-6
# the init's and the draws' keys (see test_pallas_path_matches_jax_after_five_steps)
INIT_KEY, DRAW_KEY = 51, 53


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU work on one thread (see tests/test_torch_trainer.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _init():
    """He-gain ``init_nerf_mlp`` coarse and fine MLPs as numpy trees."""
    def he(jp):
        return jax.tree_util.tree_map_with_path(
            lambda path, a: np.asarray(a, np.float32) * (HE_GAIN if path[-1].key == "w" else 1.0),
            jax.device_get(jp))

    keys = jax.random.split(jax.random.PRNGKey(INIT_KEY))
    return {k: he(j_mlp.init_nerf_mlp(key, 4, 2, width=64, rgb_width=32))
            for k, key in zip(("coarse", "fine"), keys)}


def _scene():
    """One 16x16 frame of random colours seen from radius 4: every ray
    crosses the sampled interval [2, 6] through the origin's neighbourhood."""
    rng = np.random.default_rng(32)
    images = torch.from_numpy(rng.integers(0, 256, (1, HW, HW, 3), dtype=np.uint8))
    poses = torch.from_numpy(t_cam.pose_spherical(30.0, -30.0, 4.0)[None].astype(np.float32))
    return images, poses, t_loop.SceneStatic(height=HW, width=HW, focal=20.0, num_frames=1)


def _jax_draws(key, cfg):
    """The uniforms JAX ``render_rays`` draws from ``key``."""
    k_coarse, k_cdf = jax.random.split(key)
    k_eps, k_jit = jax.random.split(k_cdf)
    u = lambda k, shape: torch.from_numpy(  # noqa: E731
        np.array(jax.random.uniform(k, shape, dtype=jnp.float32)))
    return {"coarse": u(k_coarse, (RAYS, cfg.coarse_samples)), "eps": u(k_eps, (RAYS, 1)),
            "jitter": u(k_jit, (RAYS, cfg.fine_samples, 1))}


@pytest.fixture(scope="module")
def trajectories():
    """Each path's parameters after every step, the shared inputs of each
    step (the port's step inputs with JAX's render draws) and the init."""
    cfg, tcfg = t_nerf.NeRFConfig(**NERF), t_config.TrainConfig(**TRAIN)
    images, poses, static = _scene()
    keys = [jax.random.fold_in(jax.random.PRNGKey(DRAW_KEY), s) for s in range(STEPS)]
    inputs = []
    for step, key in enumerate(keys):
        inp = t_loop.draw_step_inputs(cfg, tcfg, static, step, step, 0, "cpu")
        inputs.append(dict(inp, uniforms=_jax_draws(key, cfg)))
    init = _init()
    after, grads, non_zeros = {}, {}, []
    for kernel in ("pallas", "fused"):
        mlp_apply, render_fn = t_loop.kernel_hooks(kernel, "cpu")
        step_fn = t_loop.make_multi_step(cfg, tcfg, static, 1, render_fn, "cpu", mlp_apply)
        params = t_mlp.params_from_jax(init, "cpu")
        state = t_loop.adam_init(params)
        after[kernel], grads[kernel] = [], []
        adam_apply = t_loop.adam_apply

        def recorded(params, g, *args, _seen=grads[kernel], **kw):
            _seen.append([t.clone() for t in flatten_tree(g)])
            return adam_apply(params, g, *args, **kw)

        with pytest.MonkeyPatch.context() as mp:  # the body's gradients, as Adam takes them
            mp.setattr(t_loop, "adam_apply", recorded)
            for step in range(STEPS):
                params, state, metrics = step_fn(params, state, images, poses, step, 0,
                                                 inputs=[inputs[step]])
                assert np.isfinite(float(metrics["train_loss"]))
                if kernel == "pallas":
                    non_zeros.append([float(metrics[f"{k}_density_non_zeros"])
                                      for k in ("coarse", "fine")])
                after[kernel].append([t.detach().clone().numpy() for t in flatten_tree(params)])
        assert len(grads[kernel]) == STEPS
    lrs = [float(t_loop.make_lr_schedule(tcfg, 1)(s)) for s in range(STEPS)]
    return dict(after=after, grads=grads, lrs=lrs, non_zeros=non_zeros, inputs=inputs,
                keys=keys, init=init, images=images, poses=poses, static=static)


def _assert_params_agree(got, want, got_grads, want_grads, lrs, what):
    """Every leaf of ``got`` within rtol/atol of ``want`` after the steps
    whose gradients are given, save the near-zero-gradient elements (module
    doc), which may differ by up to ``2 lr`` per step."""
    for i, (a, b) in enumerate(zip(got, want)):
        near = np.zeros(b.shape, bool)
        for ga, gb in zip(got_grads, want_grads):
            near |= (np.abs(np.asarray(ga[i])) < NEAR_ZERO) | (np.abs(np.asarray(gb[i])) < NEAR_ZERO)
        diff = np.abs(a - b)
        bad = ~near & (diff > ATOL + RTOL * np.abs(b))
        assert not bad.any(), (f"{what}, leaf {i}: {int(bad.sum())} elements beyond rtol {RTOL} "
                               f"atol {ATOL}, worst {diff[bad].max():.3e}")
        assert diff[near].max(initial=0) <= 2 * sum(lrs[:len(got_grads)]), f"{what}, leaf {i}"


def test_pallas_and_fused_paths_agree_after_every_step(trajectories):
    """The eager pallas path (the point kernels' hook, its packing cache
    carried across the steps) and the fused path train the same parameters
    from one init on one set of draws: every leaf after every step within
    rtol 3e-5, atol 1e-6, and every leaf moved by the steps."""
    t = trajectories
    for step in range(STEPS):
        _assert_params_agree(t["after"]["pallas"][step], t["after"]["fused"][step],
                             t["grads"]["pallas"][:step + 1], t["grads"]["fused"][:step + 1],
                             t["lrs"], f"after step {step}")
    for i, (a, a0) in enumerate(zip(t["after"]["fused"][-1], flatten_tree(t["init"]))):
        assert np.abs(a - a0).max() > 0, f"leaf {i} never moved"


def test_pallas_path_matches_jax_after_five_steps(trajectories):
    """The pallas side's parameters after step 5 against JAX: ``nerf_loss``
    through ``make_pallas_mlp_apply(interpret=True, differentiable=True)``,
    ``jax.value_and_grad`` and optax's Adam on the staircase schedule, on
    the same rays and draws (the tolerance of the module doc); the density
    statistics of every step equal.

    The keys give no density at the ReLU's kink in these 5 steps. At keys
    31/33 one did: at step 2 one coarse density was 1.7e-7 in JAX's
    interpreted kernel and exactly 0 in JAX's XLA path and in the port (95
    against 94 non-zero densities), which moved that step's coarse
    gradients by up to 41% between JAX's own two paths; the port agreed
    with JAX's XLA path there to 1e-6.
    """
    jcfg = j_nerf.NeRFConfig(**NERF)
    tx = j_loop.make_optimizer(j_config.TrainConfig(**TRAIN), 1)
    mlp_apply = j_rm.make_pallas_mlp_apply(tile=64, interpret=True, differentiable=True)

    @jax.jit
    def step(params, opt_state, o, d, rgb, key):
        (_, metrics), grads = jax.value_and_grad(j_loop.nerf_loss, has_aux=True)(
            params, jcfg, o, d, rgb, key, mlp_apply=mlp_apply)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, metrics, grads

    t = trajectories
    static, images, poses = t["static"], t["images"], t["poses"]
    params = jax.tree_util.tree_map(jnp.asarray, t["init"])
    opt_state = tx.init(params)
    j_grads, non_zeros = [], []
    for inp, key in zip(t["inputs"], t["keys"]):
        batch = t_loop.ray_batch_from_arrays(inp["frame"], RAYS, static.height, static.width,
                                             static.focal, images, poses,
                                             coords=(inp["xs"], inp["ys"]))
        o, d, rgb = (jnp.asarray(batch[k].numpy()) for k in ("origin", "direc", "rgb"))
        params, opt_state, metrics, grads = step(params, opt_state, o, d, rgb, key)
        j_grads.append(flatten_tree(jax.device_get(grads)))
        non_zeros.append([float(metrics[f"{k}_density_non_zeros"]) for k in ("coarse", "fine")])
    assert non_zeros == t["non_zeros"]
    _assert_params_agree(t["after"]["pallas"][-1], flatten_tree(jax.device_get(params)),
                         t["grads"]["pallas"], j_grads, t["lrs"], "after 5 steps against JAX")
