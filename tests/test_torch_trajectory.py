"""The port's ``Trainer`` against JAX on the multiframe arm of
``experiments/r5-parity/trajectory_parity.py``, cut to ``STEPS`` steps.

The arm (``ensure_scene``, ``run_mf_jax``): JAX's procedural ``object``
scene, 100x100, 5 train + 1 val + 1 test frames (``gt_samples=192``, scene
seed 0), committed as ``tests/torch_data/r5_mf_scene``; 512 rays, 12+24
samples, 5 steps per epoch, the crop handoff after 4 epochs (step 20), the
LR ``5e-4 * 0.1^(epoch/1200)`` staircased per epoch, the init
``init_nerf_network(PRNGKey(seed))``. The JAX side is ``run_mf_jax``'s loop
(its step function, its keys: the epoch permutation from ``fold_in(base,
10_000_000 + epoch)``, the pixels and the render key from ``fold_in(base,
step)``), run eagerly: jitted, XLA's fused CPU code rounds differently
(at the init, on one batch and its draws, the jitted gradients differ from
the eager ones by up to 4.8e-3 of a leaf's L2 norm, median 1.1e-3; the
port's differ from the eager ones by up to 1.5e-5); the port side is
``Trainer`` (fp32, ``kernel="xla"``) with JAX's frame, pixels and render
uniforms put into its step inputs
(``loop.draw_step_inputs``), the way ``tests/test_torch_path_parity.py``
replays JAX's draws.

Tolerances: the loss of every step within ``tests/test_fused_raymarch.py:49``'s
fp32 tolerances (rtol 3e-5, atol 1e-6); the LR of every step within one
fp32 ulp. The leaves after the last step get a stated looser bound: at the
init the two sides' gradients agree to 1.7e-6 of a leaf's L2 norm, but
Adam's first step is ``lr * g / |g|`` for every ``|g|`` well above its eps,
so an element whose gradient is a near-cancelling sum moves by up to ``2
lr`` on one side against the other, and the trajectories part from there
(the largest leaf gradient gap grows to 2.4e-3 at step 1 and 7.0e-3 at
step 12). Measured after 24 steps: the worst element 3.49e-5 apart (0.07
lr), the worst leaf's L2 gap 1.13e-2 of its change since the init. So an
element is within rtol 3e-5 / atol 1e-6 or within ``LR_TOL = 5e-5``
(0.1 lr), and, where its gradient came within 1e-6 of 0 at some step on
either side, within ``2 lr`` per step (``tests/test_torch_path_parity.py``);
each leaf's L2 gap within ``L2_SHARE = 2e-2`` of its change.
"""

import csv
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import loop as t_loop
from minimal_nerf_torch.training import trainer as t_trainer
from minimal_nerf_torch.training.checkpoint import flatten_tree
from minimal_nerf_torch.utils import imageio as t_io
from minimal_nerf_torch.utils import threefry
from minimal_nerf_tpu.models import nerf as j_nerf
from minimal_nerf_tpu.ops import cameras as j_cam
from minimal_nerf_tpu.training.loop import nerf_loss as j_nerf_loss

TREE = Path(__file__).parent / "torch_data" / "r5_mf_scene"
RAYS, COARSE, FINE, FRAMES, CROP_EPOCHS = 512, 12, 24, 5, 4
# past the crop handoff at step 20 and four epoch boundaries
STEPS = 24
SEED = 0
RTOL, ATOL, NEAR_ZERO = 3e-5, 1e-6, 1e-6
# the looser bounds on the leaves after the last step (module doc), against
# the measured worst cases 3.49e-5 (fine/trunk[3]/b) and 1.13e-2 (the same)
LR_TOL, L2_SHARE = 5e-5, 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU work on one thread (see tests/test_torch_trainer.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _read_tree(root):
    """``{split: (meta, images uint8 [F, H, W, 3])}`` through the port's
    PNG decoder."""
    out = {}
    for split in ("train", "val", "test"):
        meta = json.loads((root / f"transforms_{split}.json").read_text())
        out[split] = (meta, np.stack([t_io.imread(root / (f["file_path"].lstrip("./") + ".png"))
                                      for f in meta["frames"]]))
    return out


def test_committed_tree_is_the_arms_jax_scene(tmp_path):
    """``ensure_scene``'s own call regenerates the committed tree: the
    port's decoder reads the same pixels from both trees, both equal the
    JAX scene's arrays, and the transforms are the same."""
    from minimal_nerf_tpu.data.procedural import make_procedural_scene, save_scene_tree

    scenes, _ = make_procedural_scene(
        split_frames=(("train", FRAMES), ("val", 1), ("test", 1)), height=100, width=100,
        seed=0, gt_samples=192, scene="object", chunk=16384)
    save_scene_tree(scenes, tmp_path)
    fresh, committed = _read_tree(tmp_path), _read_tree(TREE)
    for split, (meta, images) in committed.items():
        assert images.shape == (len(meta["frames"]), 100, 100, 3)
        assert meta == fresh[split][0], split
        np.testing.assert_array_equal(images, fresh[split][1], err_msg=split)
        np.testing.assert_array_equal(images, np.asarray(scenes[split].images), err_msg=split)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_init_equals_jax(seed):
    """``utils.threefry`` (the card's JAX-free copy of the arm's init, used
    by ``chip_smoke.py --trajectory``): the keys of ``split`` and
    ``fold_in`` and every leaf of ``init_nerf_network(PRNGKey(seed))`` equal
    JAX's, bit for bit."""
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(np.array(threefry.split(threefry.prng_key(seed), 3), np.uint32),
                          np.asarray(jax.random.key_data(jax.random.split(key, 3))))
    assert np.array_equal(np.array(threefry.fold_in(threefry.prng_key(seed), 10_000_007),
                                   np.uint32),
                          np.asarray(jax.random.key_data(jax.random.fold_in(key, 10_000_007))))
    want = flatten_tree(jax.device_get(j_nerf.init_nerf_network(
        key, j_nerf.NeRFConfig(coarse_samples=COARSE, fine_samples=FINE))))
    got = flatten_tree(threefry.init_nerf_network(seed))
    assert len(got) == len(want) == 40
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


def _jax_run(steps, seed):
    """``run_mf_jax``'s loop for ``steps`` steps from seed ``seed``, eagerly (its step
    function, keys, schedule and crop rule): per step the frame, the pixels, the render
    key and the loss; the final params; the init."""
    import imageio.v2 as imageio

    meta = json.loads((TREE / "transforms_train.json").read_text())
    images = np.stack([imageio.imread(TREE / (fr["file_path"].lstrip("./") + ".png"))[..., :3]
                       .astype(np.float32) / 255.0 for fr in meta["frames"]])
    poses = np.stack([np.array(fr["transform_matrix"], dtype=np.float32) for fr in meta["frames"]])
    H, W = images.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * meta["camera_angle_x"])
    im_j = jnp.asarray(images)
    cfg = j_nerf.NeRFConfig(coarse_samples=COARSE, fine_samples=FINE)
    params = j_nerf.init_nerf_network(jax.random.PRNGKey(seed), cfg)
    init = jax.device_get(params)
    gamma = 0.1 ** (1 / 1200)
    sched = lambda step: 5e-4 * gamma ** (step // FRAMES)  # noqa: E731
    tx = optax.adam(sched)
    opt_state = tx.init(params)
    rays = [j_cam.get_rays(H, W, float(focal), jnp.asarray(p)) for p in poses]
    o_all = jnp.stack([o for o, _ in rays])
    d_all = jnp.stack([d for _, d in rays])

    def step_fn(params, opt_state, key, frame_idx, crop):
        lo_x = jnp.where(crop, W // 4, 0)
        hi_x = jnp.where(crop, W - W // 4, W)
        lo_y = jnp.where(crop, H // 4, 0)
        hi_y = jnp.where(crop, H - H // 4, H)
        kx, ky, kr = jax.random.split(key, 3)
        xs = jax.random.randint(kx, (RAYS,), lo_x, hi_x)
        ys = jax.random.randint(ky, (RAYS,), lo_y, hi_y)
        o = o_all[frame_idx][ys, xs]
        d = d_all[frame_idx][ys, xs]
        rgb = im_j[frame_idx][ys, xs]
        (loss, _), grads = jax.value_and_grad(j_nerf_loss, has_aux=True)(
            params, cfg, o, d, rgb, kr)
        params, opt_state = adam(params, opt_state, grads)
        return params, opt_state, loss, xs, ys, kr, grads

    @jax.jit
    def adam(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    base = jax.random.PRNGKey(seed + 1)
    out, step = [], 0
    for epoch in range((steps + FRAMES - 1) // FRAMES):
        order = jax.random.permutation(jax.random.fold_in(base, 10_000_000 + epoch), FRAMES)
        for k in range(FRAMES):
            step += 1
            if step > steps:
                break
            crop = epoch < CROP_EPOCHS
            params, opt_state, loss, xs, ys, kr, grads = step_fn(
                params, opt_state, jax.random.fold_in(base, step), order[k], jnp.asarray(crop))
            out.append(dict(frame=int(order[k]), crop=crop, xs=np.asarray(xs),
                              ys=np.asarray(ys), key=kr, loss=float(loss),
                              grads=flatten_tree(jax.device_get(grads)),
                              lr=np.float32(sched(jnp.int32(step - 1)))))
    return out, flatten_tree(jax.device_get(params)), init, cfg


def _render_draws(key, cfg):
    """The uniforms JAX ``render_rays`` draws from ``key``
    (``tests/test_torch_path_parity.py::_jax_draws``)."""
    k_coarse, k_cdf = jax.random.split(key)
    k_eps, k_jit = jax.random.split(k_cdf)
    u = lambda k, shape: torch.from_numpy(  # noqa: E731
        np.array(jax.random.uniform(k, shape, dtype=jnp.float32)))
    return {"coarse": u(k_coarse, (RAYS, cfg.coarse_samples)), "eps": u(k_eps, (RAYS, 1)),
            "jitter": u(k_jit, (RAYS, cfg.fine_samples, 1))}


def _trajectories(root, steps=STEPS, seed=SEED):
    """JAX's run, then the port's ``Trainer`` from the same init on JAX's
    draws (its run directory under ``root``): its CSV rows, its own pixel
    draws, the LR and gradients of each of its steps, its final params."""
    j_steps, j_final, init, jcfg = _jax_run(steps, seed)
    cfg = t_nerf.NeRFConfig(coarse_samples=COARSE, fine_samples=FINE)
    tcfg = t_config.TrainConfig(num_rays=RAYS, max_steps=steps, cropping_epochs=CROP_EPOCHS,
                                steps_per_epoch=FRAMES, precision="fp32", kernel="xla",
                                log_every=1, seed=seed)
    params = t_mlp.params_from_jax(init, "cpu")
    own, lrs, grads = [], [], []
    draw, adam_apply = t_loop.draw_step_inputs, t_loop.adam_apply

    def jax_draws(nerf_cfg, train_cfg, static, step, count, *args, **kw):
        inp = draw(nerf_cfg, train_cfg, static, step, count, *args, **kw)
        own.append((inp["xs"].numpy(), inp["ys"].numpy()))
        lrs.append(-float(inp["adam"][0]))
        j = j_steps[step]
        return dict(inp, frame=j["frame"], xs=torch.tensor(j["xs"], dtype=torch.int64),
                    ys=torch.tensor(j["ys"], dtype=torch.int64),
                    uniforms=_render_draws(j["key"], jcfg))

    def recorded(params, g, *args, **kw):
        grads.append([t.clone().numpy() for t in flatten_tree(g)])
        return adam_apply(params, g, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_loop, "draw_step_inputs", jax_draws)
        mp.setattr(t_loop, "adam_apply", recorded)
        trainer = t_trainer.Trainer(cfg, tcfg, TREE, root, name="mf", device="cpu",
                                    initial_state=(params, t_loop.adam_init(params), None, 0))
        trainer.fit()
    with open(root / "mf" / "metrics.csv", newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["train_loss"]]
    final = [t.detach().numpy() for t in flatten_tree(trainer.final_state[0])]
    return dict(jax=j_steps, jax_final=j_final, init=flatten_tree(init), rows=rows, own=own,
                lrs=lrs, grads=grads, final=final, lr_metric=[float(r["lr"]) for r in rows])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _trajectories(tmp_path_factory.mktemp("traj"))


def test_trainer_loss_matches_jax_at_every_step(runs):
    """Every step's loss (metrics.csv, one row per step) against
    ``run_mf_jax``'s on the same draws, rtol 3e-5 / atol 1e-6."""
    assert [int(r["step"]) for r in runs["rows"]] == list(range(1, STEPS + 1))
    got = np.array([float(r["train_loss"]) for r in runs["rows"]])
    want = np.array([s["loss"] for s in runs["jax"]])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_trainer_params_match_jax_after_the_last_step(runs):
    """Every leaf after step ``STEPS`` against JAX's (module doc): each
    element within rtol 3e-5 / atol 1e-6, or within ``LR_TOL``, or, where
    its gradient came within 1e-6 of 0, within ``2 lr`` per step; each
    leaf's L2 gap within ``L2_SHARE`` of its change since the init; a leaf
    JAX leaves unchanged (the coarse MLP, whose densities are all 0 at this
    init, gets no gradient) unchanged in the port too."""
    j_grads = [s["grads"] for s in runs["jax"]]
    assert len(runs["grads"]) == STEPS
    for i, (a, b, b0) in enumerate(zip(runs["final"], runs["jax_final"], runs["init"])):
        b, b0 = np.asarray(b), np.asarray(b0)
        if np.array_equal(b, b0):
            np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
            continue
        near = np.zeros(b.shape, bool)
        for ga, gb in zip(runs["grads"], j_grads):
            near |= (np.abs(ga[i]) < NEAR_ZERO) | (np.abs(np.asarray(gb[i])) < NEAR_ZERO)
        diff = np.abs(a - b)
        bad = ~near & (diff > ATOL + RTOL * np.abs(b)) & (diff > LR_TOL)
        assert not bad.any(), (f"leaf {i}: {int(bad.sum())} elements beyond rtol {RTOL} atol "
                               f"{ATOL} and {LR_TOL}, worst {diff[bad].max():.3e}")
        assert diff[near].max(initial=0) <= 2 * sum(runs["lrs"]), f"leaf {i}"
        share = np.linalg.norm(a - b) / np.linalg.norm(b - b0)
        assert share <= L2_SHARE, f"leaf {i}: L2 gap {share:.3e} of its change"


def test_trainer_lr_matches_jax_schedule(runs):
    """The LR of every step (Adam's, and the logged ``lr`` metric) against
    optax's schedule at the same count within one fp32 ulp; it steps only at
    the epoch boundaries."""
    want = np.array([s["lr"] for s in runs["jax"]], np.float32)
    for got in (np.array(runs["lrs"], np.float32), np.array(runs["lr_metric"], np.float32)):
        assert (np.abs(got - want) <= np.spacing(want)).all(), (got, want)
    for s in range(1, STEPS):
        assert (want[s] == want[s - 1]) == (s % FRAMES != 0), s


def test_trainer_crop_box_matches_jax(runs):
    """The port's own pixel draws fall in JAX's box at every step (the
    center half while ``epoch < 4``, steps 0-19; the whole frame after),
    and each phase's draws of either side reach both ends of the box."""
    for phase in (True, False):
        lo, hi = (25, 74) if phase else (0, 99)
        idx = [i for i, s in enumerate(runs["jax"]) if s["crop"] == phase]
        assert idx == (list(range(20)) if phase else list(range(20, STEPS)))
        for coords in ([runs["own"][i] for i in idx],
                       [(runs["jax"][i]["xs"], runs["jax"][i]["ys"]) for i in idx]):
            for axis in (0, 1):
                v = np.concatenate([c[axis] for c in coords])
                assert (v.min(), v.max()) == (lo, hi), (phase, axis)


def main(argv=None):
    """``PYTHONPATH=. python tests/test_torch_trajectory.py --steps N --seed S``: the
    comparison at any length and seed (a diagnosis, one thread each side as
    in the test): the largest relative gap of a step's loss, and the PSNR of
    train frame 0 rendered from each side's final params (the plain fp32
    render, ``run_mf_jax``'s chunk) beside an all-black frame's."""
    import argparse
    import tempfile

    from minimal_nerf_torch import views
    from minimal_nerf_torch.data.synthetic import SyntheticScene
    from minimal_nerf_torch.training.checkpoint import unflatten_tree

    parser = argparse.ArgumentParser(description="the trajectory comparison at any length")
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--seed", type=int, default=SEED)
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        r = _trajectories(Path(tmp), args.steps, args.seed)
    gap = max(abs(float(row["train_loss"]) - s["loss"]) / abs(s["loss"])
              for row, s in zip(r["rows"], r["jax"]))
    scene = SyntheticScene.load(TREE, "train", "cpu")
    gt = scene.images[0].numpy().astype(np.float64)
    o, d = scene.frame_rays(0)
    chunk = views.make_param_render_chunk(t_nerf.NeRFConfig(coarse_samples=COARSE,
                                                            fine_samples=FINE))
    psnr = lambda im: 10 * np.log10(255.0 ** 2 / np.mean((im - gt) ** 2))  # noqa: E731
    template = threefry.init_nerf_network(args.seed)
    for name, leaves in (("port", r["final"]), ("jax", r["jax_final"])):
        params = unflatten_tree(template, [torch.tensor(np.asarray(x)) for x in leaves])
        im = views.view_reconstruction_with_params(chunk, params, o, d, chunk=RAYS, seed=1)
        print(f"{name}: train frame 0 psnr {psnr(im.astype(np.float64)):.4f} dB after "
              f"{args.steps} steps")
    print(f"all-black frame {psnr(np.zeros_like(gt)):.4f} dB; largest relative gap of a "
          f"step's loss over {args.steps} steps (seed {args.seed}): {gap:.3e}")


if __name__ == "__main__":
    main()
