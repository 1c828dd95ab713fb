"""Several train steps per call (``training.loop.make_multi_step``) against
the eager step and against the JAX package's ``make_multi_step``, and the
Trainer and train CLI at ``steps_per_call > 1``.

On the CPU ``make_multi_step`` runs the step's body once per step (on a card
it replays a captured CUDA graph of it, held bit for bit against the eager
step in ``tests/test_torch_kernels_cuda.py``). Small: widths 64/32,
position_dim 4, 8 + 8 samples, 16-32 rays, fp32.
"""

import csv
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimal_nerf_torch import train as t_train
from minimal_nerf_torch.data import procedural as t_proc
from minimal_nerf_torch.kernels import fused_raymarch as t_fused
from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops import cameras as t_cam
from minimal_nerf_torch.ops import occupancy as t_occ
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import loop as t_loop
from minimal_nerf_torch.training import trainer as t_trainer
from minimal_nerf_torch.training.checkpoint import flatten_tree
from minimal_nerf_tpu.data import synthetic as j_synth
from minimal_nerf_tpu.kernels import fused_raymarch as j_fused
from minimal_nerf_tpu.models import mlp as j_mlp
from minimal_nerf_tpu.models import nerf as j_nerf
from minimal_nerf_tpu.training import config as j_config
from minimal_nerf_tpu.training import loop as j_loop

NERF = dict(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
HE_GAIN = np.sqrt(6.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny CPU runs take one thread: with a thread per core in every
    parallel test worker, PyTorch's threads mostly wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _scene():
    """Three 12x12 procedural frames (an epoch of 3 steps)."""
    scenes, _ = t_proc.make_procedural_scene((("train", 3),), height=12, width=12,
                                             gt_samples=16, scene="object", device="cpu")
    return scenes["train"]


def _params(seed=0):
    """Coarse and fine MLPs at widths 64/32, He-uniform weights."""
    g = torch.Generator().manual_seed(seed)
    return {k: t_mlp.init_nerf_mlp(g, 4, 2, width=64, rgb_width=32, device="cpu",
                                   gain=HE_GAIN) for k in ("coarse", "fine")}


# the crop ends at step 3 (one cropping epoch of 3 frames), inside the first
# call of 4; with occupancy the grid is updated at steps 0, 3 and 6 (two of
# them inside a call) and the warmup ends at step 6, inside the second call;
# the absolute threshold sits among the init's densities, so the packed grid
# is partly occupied once the warmup ends
TRAIN = dict(num_rays=16, precision="fp32", cropping_epochs=1, start_lr=5e-3,
             lr_decay_epochs=2)
OCC = dict(occupancy=True, occ_resolution=16, occ_num_bins=16, occ_update_every=3,
           occ_warmup_steps=6, occ_threshold=2.0, occ_rel_threshold=0.0)
CASES = {"fused": ("fused", {}), "pallas": ("pallas", {}), "xla": ("xla", {}),
         "occupancy": ("fused", OCC), "occupancy pallas": ("pallas", OCC)}


def _state(params, occ_cfg):
    return (params, t_loop.adam_init(params),
            t_occ.init_grid(occ_cfg, "cpu") if occ_cfg is not None else None)


def _run(fn, state, scene, step):
    params, opt_state, grid = state
    if grid is None:
        params, opt_state, metrics = fn(params, opt_state, scene.images, scene.poses, step, 0)
    else:
        params, opt_state, grid, metrics = fn(params, opt_state, grid, scene.images,
                                              scene.poses, step, 0)
    return (params, opt_state, grid), metrics


def _assert_state_equal(a, b):
    """Parameters, moments, count and grid bit for bit."""
    (pa, oa, ga), (pb, ob, gb) = a, b
    assert oa["count"] == ob["count"]
    for x, y in zip(flatten_tree([pa, oa["mu"], oa["nu"]]), flatten_tree([pb, ob["mu"],
                                                                          ob["nu"]])):
        assert torch.equal(x, y)
    assert (ga is None) == (gb is None)
    if ga is not None:
        assert torch.equal(ga, gb)


@pytest.mark.parametrize("case", list(CASES))
def test_multi_step_equals_eager_steps(case):
    """Two calls of ``make_multi_step(num_inner=4)`` against eight eager
    ``make_train_step`` steps from the same state: parameters, Adam moments,
    count, grid and the last step's metrics bit for bit. The first call
    crosses the crop -> full switch; with occupancy both calls hold a grid
    update and the second the warmup's end."""
    kernel, occ_kw = CASES[case]
    cfg = t_nerf.NeRFConfig(**NERF)
    scene = _scene()
    tcfg = t_config.TrainConfig(**TRAIN, **occ_kw)
    occ_cfg = tcfg.occupancy_config
    static = t_loop.scene_static(scene)
    hooks = t_loop.kernel_hooks(kernel, "cpu")

    step_fn = t_loop.make_train_step(cfg, tcfg, static, hooks[1], "cpu", hooks[0], occ_cfg)
    eager = _state(_params(), occ_cfg)
    fractions = []
    for step in range(8):
        eager, eager_metrics = _run(step_fn, eager, scene, step)
        fractions.append(float(eager_metrics.get("occ_fraction", 1.0)))

    multi_fn = t_loop.make_multi_step(cfg, tcfg, static, 4, hooks[1], "cpu", hooks[0], occ_cfg)
    multi = _state(_params(), occ_cfg)
    for start in (0, 4):
        multi, multi_metrics = _run(multi_fn, multi, scene, start)

    _assert_state_equal(eager, multi)
    assert multi[1]["count"] == 8
    assert multi_metrics.keys() == eager_metrics.keys()
    for k in eager_metrics:
        assert torch.equal(multi_metrics[k], eager_metrics[k]), k
    if occ_cfg is not None:
        assert fractions[:6] == [1.0] * 6 and 0.0 < fractions[-1] < 1.0


def test_multi_step_takes_given_inputs():
    """``inputs`` replace the call's draws: the steps' own draws, passed in,
    give the same state as the call that draws them; a wrong count raises."""
    cfg = t_nerf.NeRFConfig(**NERF)
    scene = _scene()
    tcfg = t_config.TrainConfig(**TRAIN)
    static = t_loop.scene_static(scene)
    multi_fn = t_loop.make_multi_step(cfg, tcfg, static, 2, device="cpu")
    drawn = _state(_params(), None)
    drawn, _ = _run(multi_fn, drawn, scene, 2)
    given = _state(_params(), None)
    inputs = [t_loop.draw_step_inputs(cfg, tcfg, static, s, i, 0, "cpu")
              for i, s in enumerate((2, 3))]
    params, opt_state, _ = multi_fn(given[0], given[1], scene.images, scene.poses, 2, 0,
                                    inputs=inputs)
    _assert_state_equal(drawn, (params, opt_state, None))
    with pytest.raises(ValueError):
        multi_fn(params, opt_state, scene.images, scene.poses, 4, 0, inputs=inputs[:1])


def test_adam_apply_equals_the_update_on_python_floats():
    """The update on device scalars (``adam_scalars``) equals, bit for bit,
    the one with the LR and bias corrections as Python floats, over counts
    whose corrections are far from 1."""
    rng = np.random.default_rng(0)
    shapes = [(37, 5), (64,), (3, 7, 2)]
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    ref = [p.clone() for p in params]
    state = t_loop.adam_init(params)
    mu, nu = [torch.zeros_like(p) for p in ref], [torch.zeros_like(p) for p in ref]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    for count in range(1, 6):
        grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 1e-3)
                 for s in shapes]
        lr = f32(5e-4) * f32(0.9) ** count
        state = t_loop.adam_update(params, grads, state, lr)
        bc1, bc2 = float(1 - f32(0.9) ** count), float(1 - f32(0.999) ** count)
        for p, g, m, v in zip(ref, grads, mu, nu):
            m.copy_(0.1 * g + 0.9 * m)
            v.copy_((1 - 0.999) * (g * g) + 0.999 * v)
            p.add_(-float(lr) * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8)))
        assert state["count"] == count
        for a, b in zip(params, ref):
            assert torch.equal(a, b)


def _jax_draws(key, n, cfg):
    """The uniforms JAX ``render_rays_fused`` draws from ``key`` (as
    ``tests/test_torch_training.py`` derives them)."""
    k_coarse, k_cdf = jax.random.split(key)
    k_eps, k_jit = jax.random.split(k_cdf)
    u = lambda k, shape: torch.from_numpy(  # noqa: E731
        np.array(jax.random.uniform(k, shape, dtype=jnp.float32)))
    return {"coarse": u(k_coarse, (n, cfg.coarse_samples)), "eps": u(k_eps, (n, 1)),
            "jitter": u(k_jit, (n, cfg.fine_samples, 1))}


def _jax_step_inputs(base_key, step, static, tcfg, jcfg, steps_per_epoch):
    """JAX's draws of train step ``step`` (``_build_step_runner.run_step``):
    ``fold_in(base_key, step)`` split into the batch and render keys; the
    pixels of ``sample_random_coordinates`` (what ``sample_train_batch``
    draws), the frame from the epoch's permutation, the render's uniforms
    from ``fold_in(k_render, 0)``."""
    key = jax.random.fold_in(base_key, step)
    k_batch, k_render = jax.random.split(key)
    epoch = step // steps_per_epoch
    xs, ys = j_synth.sample_random_coordinates(k_batch, tcfg.num_rays, static.height,
                                               static.width, epoch < tcfg.cropping_epochs)
    perm = jnp.argsort(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(base_key, j_loop._PERM_STREAM_TAG), epoch),
        (static.num_frames,)))
    frame = int(perm[step % steps_per_epoch % static.num_frames])
    as_t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))  # noqa: E731
    return dict(frame=frame, xs=as_t(xs), ys=as_t(ys),
                uniforms=_jax_draws(jax.random.fold_in(k_render, 0), tcfg.num_rays, jcfg))


def test_multi_step_matches_jax():
    """Four steps of the port's ``make_multi_step`` (the fused render's plain
    version) against JAX's ``make_multi_step(..., num_inner=4)`` (its fused
    render in interpret mode) on JAX's draws, fp32: shared weights (He
    init), scene and draws; the crop ends inside the call.

    Tolerance, four times ``tests/test_torch_training.py``'s one-step bound
    (``_assert_step_matches``): each Adam step moves a weight by about ``lr
    * sign(g)``, where the two sides' fp32 sums differ by far less than
    ``1e-3 * lr``, except where ``|g|`` is within a few ``eps`` of 0, where
    one step may move the two sides up to ``2 * lr`` apart. After four
    steps: ``4e-3 * lr`` per weight, ``8 * lr`` for the weights whose
    gradient (the port's, recorded per step) came within ``1e-6`` of 0 in
    any step; the last step's loss and gradient norm within ``4e-5``
    (relative); the Adam count exact, the LR as in
    ``test_lr_schedule_matches_jax``.
    """
    jcfg = j_nerf.NeRFConfig(**NERF)
    tcfg_nerf = t_nerf.NeRFConfig(**NERF)
    kw = dict(num_rays=16, precision="fp32", cropping_epochs=1, start_lr=5e-4, end_lr=5e-5,
              lr_decay_epochs=10)
    j_tcfg, t_tcfg = j_config.TrainConfig(**kw), t_config.TrainConfig(**kw)
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, size=(3, 12, 12, 3), dtype=np.uint8)
    poses = np.stack([t_cam.pose_spherical(-180 + 120 * i, -30.0, 4.0)
                      for i in range(3)]).astype(np.float32)
    focal = t_cam.focal_from_angle(12, 0.6911112070083618)
    j_static = j_loop.SceneStatic(height=12, width=12, focal=focal, num_frames=3)
    t_static = t_loop.SceneStatic(height=12, width=12, focal=focal, num_frames=3)
    keys = jax.random.split(jax.random.PRNGKey(3))
    jp = {k: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jax.device_get(j_mlp.init_nerf_mlp(key, 4, 2, width=64, rgb_width=32)))
        for k, key in zip(("coarse", "fine"), keys)}
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * (HE_GAIN if path[-1].key == "w" else 1.0), jp)
    base_key = jax.random.PRNGKey(11)

    loss_fn = functools.partial(j_loop.nerf_loss, render_fn=j_fused.make_fused_render_fn(
        ray_tile=8, interpret=True))
    j_multi, tx = j_loop.make_multi_step(jcfg, j_tcfg, j_static, 4, loss_fn=loss_fn)
    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    j_params, j_opt, j_metrics = j_multi(j_params, tx.init(j_params),
                                         j_synth.pack_images(images), jnp.asarray(poses), 0,
                                         base_key)

    tp = t_mlp.params_from_jax(jp, "cpu")
    steps_per_epoch = 3
    inputs = [dict(t_loop.draw_step_inputs(tcfg_nerf, t_tcfg, t_static, s, s, 0, "cpu"),
                   **_jax_step_inputs(base_key, s, t_static, t_tcfg, jcfg, steps_per_epoch))
              for s in range(4)]
    near_zero = [torch.zeros_like(leaf, dtype=torch.bool) for leaf in flatten_tree(tp)]
    grads_of = t_loop.loss_and_grads

    def recording(*args, **kwargs):
        metrics, grads = grads_of(*args, **kwargs)
        for z, g in zip(near_zero, flatten_tree(grads)):
            z |= g.abs() < 1e-6
        return metrics, grads

    t_multi = t_loop.make_multi_step(tcfg_nerf, t_tcfg, t_static, 4,
                                     t_fused.make_fused_render_fn(), "cpu")
    t_loop.loss_and_grads = recording
    try:
        tp, t_opt, t_metrics = t_multi(tp, t_loop.adam_init(tp), torch.from_numpy(images),
                                       torch.from_numpy(poses), 0, 0, inputs=inputs)
    finally:
        t_loop.loss_and_grads = grads_of

    lr = kw["start_lr"]
    for a, b, z in zip(flatten_tree(jax.device_get(j_params)), flatten_tree(tp), near_zero):
        diff = np.abs(b.detach().numpy() - a)
        z = z.numpy()
        assert diff[~z].max(initial=0) <= 4 * 1e-3 * lr
        assert diff[z].max(initial=0) <= 4 * 2 * lr
    assert t_opt["count"] == int(j_opt[0].count) == 4
    for k in ("train_loss", "grad_2.0_norm_total"):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=4e-5)
    np.testing.assert_allclose(float(t_metrics["lr"]), float(j_metrics["lr"]), rtol=2e-7)


def _rows(path):
    """metrics.csv without its timing columns (host clocks)."""
    timing = {"iterations_per_sec", "rays_per_sec", "train iteration speed", "wall_seconds",
              "val_seconds", "ckpt_seconds"}
    with open(path, newline="") as f:
        return [{k: v for k, v in row.items() if k not in timing} for row in csv.DictReader(f)]


@pytest.mark.parametrize("case", ["uniform", "occupancy"])
def test_trainer_steps_per_call_matches_single(case, fixture_scene, tmp_path):
    """``Trainer`` at ``steps_per_call=4`` against ``steps_per_call=1`` (JAX's
    ``test_trainer_steps_per_call`` and ``..._matches_single``): epochs of 6
    steps, a CSV row every 6, a validation and a save every 2 epochs, 15
    steps (not a multiple of 4): calls of 4 at steps 0 and 6, single steps
    elsewhere. The CSV's rows (its timing columns aside), the checkpoints'
    names and leaves, and the final state bit for bit."""
    occ = dict(occupancy=True, occ_resolution=8, occ_num_bins=16, occ_update_every=2,
               occ_warmup_steps=3) if case == "occupancy" else {}
    runs = {}
    for spc in (1, 4):
        tr = t_trainer.Trainer(
            t_nerf.NeRFConfig(**NERF),
            t_config.TrainConfig(num_rays=32, max_steps=15, precision="fp32", log_every=6,
                                 steps_per_epoch=6, check_val_every_n_epoch=2,
                                 ckpt_every_steps=100, val_render_every=1, kernel="fused",
                                 steps_per_call=spc, **occ),
            fixture_scene, tmp_path, name=f"spc{spc}", device="cpu")
        calls = []
        if spc > 1:
            multi_fn = tr.multi_fn
            tr.multi_fn = lambda *a, **k: calls.append(a[-2]) or multi_fn(*a, **k)
        tr.fit()
        run = tmp_path / f"spc{spc}"
        ckpts = sorted(p.name.replace(f"spc{spc}", "NAME")
                       for p in (run / "checkpoints").glob("*.ckpt"))
        runs[spc] = (tr.final_state, _rows(run / "metrics.csv"), ckpts, run, calls)
    (s1, rows1, ck1, run1, _), (s4, rows4, ck4, run4, calls) = runs[1], runs[4]
    assert calls == [0, 6]
    assert s1[3] == s4[3] == 15
    _assert_state_equal(s1[:3], s4[:3])
    assert rows1 == rows4 and [r["step"] for r in rows4 if r["train_loss"]] == ["6", "12", "15"]
    assert ck1 == ck4 == ["model=NAME-epoch=2-step=12.ckpt", "model=NAME-epoch=2-step=15.ckpt"]
    for name in ck1:
        h1, l1 = t_ckpt.load_checkpoint(run1 / "checkpoints" / name.replace("NAME", "spc1"))
        h4, l4 = t_ckpt.load_checkpoint(run4 / "checkpoints" / name.replace("NAME", "spc4"))
        assert h1["step"] == h4["step"] and h1["num_leaves"] == h4["num_leaves"]
        assert all(np.array_equal(l1[i], l4[i]) for i in range(h1["num_leaves"]))


def test_cli_steps_per_call_runs_multi_step_calls(tmp_path, capsys, monkeypatch):
    """``train.main([... "--steps-per-call", "4" ...])`` on the CPU: calls of
    4 steps where the boundaries allow (epochs of 5 frames, a row every 5
    steps: steps 0-3 and 5-8), no "one step per call" notice, and the same
    metrics.csv rows and final state as ``--steps-per-call 1``."""
    scenes, _ = t_proc.make_procedural_scene((("train", 5), ("val", 1)), height=8, width=8,
                                             gt_samples=8, scene="object", device="cpu")
    t_proc.save_scene_tree(scenes, tmp_path / "tree")
    made = []
    make = t_loop.make_multi_step

    def counting(*args, **kwargs):
        multi_fn = make(*args, **kwargs)
        made.append([])
        return lambda *a, **k: made[-1].append(a[-2]) or multi_fn(*a, **k)

    monkeypatch.setattr(t_loop, "make_multi_step", counting)
    out = {}
    for spc in ("1", "4"):
        tr = t_train.main(["--device", "cpu", "-n", f"spc{spc}", "-s", "10", "-r", "16",
                           "--precision", "fp32", "--log-every", "5", "-p", "4", "-d", "2",
                           "--steps-per-call", spc, "-rd", str(tmp_path / "runs"), "full",
                           "-b", str(tmp_path / "tree"), "-c", "8", "-f", "8"])
        out[spc] = (tr.final_state, _rows(tmp_path / "runs" / f"spc{spc}" / "metrics.csv"))
    err = capsys.readouterr().err
    assert "one step per call" not in err
    assert made == [[0, 5]]
    (s1, rows1), (s4, rows4) = out["1"], out["4"]
    _assert_state_equal(s1[:3], s4[:3])
    assert rows1 == rows4 and [r["step"] for r in rows4 if r["train_loss"]] == ["5", "10"]
