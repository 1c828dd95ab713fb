"""The port's ``mode="single"`` (one MLP on the coarse-only render) against
the JAX package's: ``render_single`` (plain, and through the point kernels'
hook against JAX's Pallas kernel in interpret mode), ``single_nerf_loss``
with its gradients and one Adam step, ``make_batched_eval_step_single`` on
replayed draws, the ``SingleNeRF`` and ``NeRFNetwork`` wrappers, the
``Trainer(mode="single")`` with its checkpoints crossing to and from JAX,
and ``train single`` through ``train.main``. Small: position_dim 4, 8
samples, widths 64/32 for the parity cases, fp32, the shared fixture tree.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minimal_nerf_torch import inference as t_inf
from minimal_nerf_torch import train as t_train
from minimal_nerf_torch.data.synthetic import SyntheticScene as TScene
from minimal_nerf_torch.kernels import raymarch as t_rm
from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import loop as t_loop
from minimal_nerf_torch.training import trainer as t_trainer
from minimal_nerf_tpu.data import synthetic as j_synth
from minimal_nerf_tpu.kernels import raymarch as j_rm
from minimal_nerf_tpu.models import mlp as j_mlp
from minimal_nerf_tpu.models import nerf as j_nerf
from minimal_nerf_tpu.training import checkpoint as j_ckpt
from minimal_nerf_tpu.training import config as j_config
from minimal_nerf_tpu.training import loop as j_loop
from minimal_nerf_tpu.training import trainer as j_trainer

NERF = dict(position_dim=4, direction_dim=2, coarse_samples=8)
LR = dict(start_lr=5e-4, end_lr=5e-5, lr_decay_epochs=10)
# the Trainer's runs: 3 train frames per epoch, a validation and a save at
# steps 3 and 6 (a val view at the first), a save at 4, rows at 2, 4, 6, 7
TRAIN = dict(num_rays=32, max_steps=7, precision="fp32", log_every=2, cropping_epochs=0,
             check_val_every_n_epoch=1, ckpt_every_steps=4, val_render_every=2, kernel="xla")
KERNELS = ["plain", "pallas"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU work on one thread (see tests/test_torch_trainer.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _he_mlp(seed, width=64, rgb_width=32):
    """A He-gain JAX ``init_nerf_mlp`` at position_dim 4 as numpy arrays."""
    jp = j_mlp.init_nerf_mlp(jax.random.PRNGKey(seed), 4, 2, width=width, rgb_width=rgb_width)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, np.float32) * (np.sqrt(6.0) if path[-1].key == "w" else 1.0),
        jax.device_get(jp))


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = (rng.normal(size=(n, 3)) - [0.0, 0.0, 2.0]).astype(np.float32)
    return o, d, rng.uniform(size=(n, 3)).astype(np.float32)


def _coarse(key, n, s=NERF["coarse_samples"]):
    """The coarse uniforms JAX ``render_single`` draws from ``key``."""
    return {"coarse": T(jax.random.uniform(key, (n, s), dtype=jnp.float32))}


def _hooks(kernel):
    """(JAX mlp_apply, port mlp_apply) of a case."""
    if kernel == "pallas":
        return (j_rm.make_pallas_mlp_apply(tile=64, interpret=True, differentiable=True),
                t_rm.make_mlp_kernel_apply())
    return None, None


@pytest.mark.parametrize("kernel", KERNELS)
def test_render_single_matches_jax(kernel):
    """``render_single`` on shared weights, rays and draws: every output
    within rtol 1e-5 / atol 1e-6 (fp32 sum orders); under ``pallas`` the
    point kernels' hook (its plain version) against JAX's Pallas kernel."""
    jcfg, tcfg = j_nerf.NeRFConfig(**NERF), t_nerf.NeRFConfig(**NERF)
    jp = _he_mlp(1)
    o, d, _ = _rays(2, 16)
    key = jax.random.PRNGKey(3)
    j_apply, t_apply = _hooks(kernel)
    want = j_nerf.render_single(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, jnp.asarray(o),
                                jnp.asarray(d), key, mlp_apply=j_apply)
    before = t_rm.launches
    got = t_nerf.render_single(t_mlp.params_from_jax(jp, "cpu"), tcfg, T(o), T(d),
                               mlp_apply=t_apply, uniforms=_coarse(key, 16))
    assert t_rm.launches == before  # the plain versions launch nothing
    assert sorted(got) == sorted(want) == ["deltas", "density", "pred_rgbs", "samples", "ts"]
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(got["density"].max()) > 0 and float(got["pred_rgbs"].std()) > 1e-3


@pytest.mark.parametrize("kernel", KERNELS)
def test_single_nerf_loss_grads_and_adam_match_jax(kernel):
    """``single_nerf_loss`` through ``loss_and_grads(mode="single")`` against
    ``jax.value_and_grad(single_nerf_loss)``, then one Adam step against
    optax on the schedule: loss within 1e-5, every gradient within 5e-5 of
    its leaf's largest, the parameters after Adam within 1e-3 lr save where
    a gradient is within 1e-6 of 0 (there Adam's first step may move by up
    to 2 lr; tests/test_torch_training.py::_assert_step_matches)."""
    jcfg, tcfg = j_nerf.NeRFConfig(**NERF), t_nerf.NeRFConfig(**NERF)
    jp = _he_mlp(4)
    o, d, rgb = _rays(5, 16)
    key = jax.random.PRNGKey(6)
    j_apply, t_apply = _hooks(kernel)
    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    (j_loss, j_metrics), j_grads = jax.value_and_grad(j_loop.single_nerf_loss, has_aux=True)(
        j_params, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(rgb), key,
        mlp_apply=j_apply)
    tx = j_loop.make_optimizer(j_config.TrainConfig(**LR), 1)
    updates, _ = tx.update(j_grads, tx.init(j_params), j_params)
    j_after = jax.device_get(optax.apply_updates(j_params, updates))

    tp = t_mlp.params_from_jax(jp, "cpu")
    batch = {"origin": T(o), "direc": T(d), "rgb": T(rgb)}
    metrics, grads = t_loop.loss_and_grads(tp, tcfg, batch, uniforms=_coarse(key, 16),
                                           mlp_apply=t_apply, mode="single")
    assert sorted(metrics) == sorted(j_metrics) == ["train_loss"]
    np.testing.assert_allclose(float(metrics["train_loss"]), float(j_loss), rtol=1e-5)
    j_leaves = t_ckpt.flatten_tree(jax.device_get(j_grads))
    for a, b in zip(j_leaves, t_ckpt.flatten_tree(grads)):
        assert np.abs(b.numpy() - a).max() <= 5e-5 * np.abs(a).max()
    lr = float(t_loop.make_lr_schedule(t_config.TrainConfig(**LR), 1)(0))
    t_loop.adam_update(tp, grads, t_loop.adam_init(tp), lr)
    for a, b, g in zip(t_ckpt.flatten_tree(j_after), t_ckpt.flatten_tree(tp), j_leaves):
        diff, near = np.abs(b.detach().numpy() - a), np.abs(g) < 1e-6
        assert diff[~near].max(initial=0) <= 1e-3 * lr
        assert diff[near].max(initial=0) <= 2 * lr
    assert float(t_loop.global_norm(grads)) > 0


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_single_train_step_and_multi_step(fixture_scene, kernel):
    """``make_train_step(mode="single")`` draws only the coarse uniforms and
    trains one MLP: its metrics are JAX's single-mode names; four steps of
    ``make_multi_step(mode="single")`` equal four eager steps bit for bit;
    the loss falls over 12 steps of one frame."""
    cfg = t_nerf.NeRFConfig(**NERF)
    tcfg = t_config.TrainConfig(**dict(TRAIN, kernel=kernel, start_lr=5e-3))
    scene = TScene.load(fixture_scene, "train", device="cpu")
    static = t_loop.scene_static(scene)
    inp = t_loop.draw_step_inputs(cfg, tcfg, static, 0, 0, 0, "cpu", mode="single")
    assert list(inp["uniforms"]) == ["coarse"]
    assert tuple(inp["uniforms"]["coarse"].shape) == (32, 8)
    mlp_apply, render_fn = t_loop.kernel_hooks(kernel, "cpu", mode="single")
    assert render_fn is None and (mlp_apply is None) == (kernel == "xla")
    init = t_mlp.init_nerf_mlp(torch.Generator().manual_seed(8), 4, 2, width=64, rgb_width=32,
                               device="cpu", gain=np.sqrt(6.0))
    runs = []
    for multi in (False, True):
        params = t_mlp.map_params(lambda t: t.clone(), init)
        state = t_loop.adam_init(params)
        if multi:
            fn = t_loop.make_multi_step(cfg, tcfg, static, 4, None, "cpu", mlp_apply,
                                        mode="single")
            params, state, metrics = fn(params, state, scene.images, scene.poses, 0, 0)
        else:
            fn = t_loop.make_train_step(cfg, tcfg, static, None, "cpu", mlp_apply, mode="single")
            for step in range(4):
                params, state, metrics = fn(params, state, scene.images, scene.poses, step, 0)
        runs.append((params, state, metrics))
    (p1, s1, m1), (p4, s4, m4) = runs
    assert sorted(m1) == ["grad_2.0_norm_total", "lr", "train_loss"]
    assert s1["count"] == s4["count"] == 4
    for a, b in zip(t_ckpt.flatten_tree([p1, s1["mu"], s1["nu"]]),
                    t_ckpt.flatten_tree([p4, s4["mu"], s4["nu"]])):
        assert torch.equal(a, b)
    assert all(torch.equal(m1[k], m4[k]) for k in m1)
    # one frame over and over: the loss falls
    losses = []
    fn = t_loop.make_train_step(cfg, dataclasses.replace(tcfg, steps_per_epoch=1000), static,
                                None, "cpu", mlp_apply, mode="single")
    params = t_mlp.map_params(lambda t: t.clone(), init)
    state = t_loop.adam_init(params)
    for step in range(12):
        params, state, metrics = fn(params, state, scene.images, scene.poses, step, 0)
        losses.append(float(metrics["train_loss"]))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_single_step_refuses_occupancy_and_unknown_modes(fixture_scene):
    cfg = t_nerf.NeRFConfig(**NERF)
    tcfg = t_config.TrainConfig(**dict(TRAIN, occupancy=True, occ_resolution=8))
    static = t_loop.scene_static(TScene.load(fixture_scene, "train", device="cpu"))
    with pytest.raises(ValueError, match="occupancy"):
        t_loop.make_train_step(cfg, tcfg, static, None, "cpu", None, tcfg.occupancy_config,
                               mode="single")
    with pytest.raises(ValueError, match="mode"):
        t_loop.make_train_step(cfg, t_config.TrainConfig(**TRAIN), static, None, "cpu",
                               mode="simple")


@pytest.mark.parametrize("kernel", KERNELS)
def test_batched_eval_step_single_matches_jax(fixture_scene, kernel):
    """``make_batched_eval_step_single`` against JAX's on the val split,
    each frame's pixels and draws replayed from JAX's key stream
    (``fold_in(base_key, 10_000_000 + step + idx)``, its render key
    ``fold_in(key, 1)``): the mean val loss within rtol 3e-5 / atol 1e-6."""
    jcfg, tcfg = j_nerf.NeRFConfig(**NERF), t_nerf.NeRFConfig(**NERF)
    train = dict(num_rays=32, precision="fp32")
    jp = _he_mlp(9)
    j_val = j_synth.SyntheticScene.load(fixture_scene, "val")
    t_val = TScene.load(fixture_scene, "val", device="cpu")
    static = j_loop.scene_static(j_val)
    j_apply, t_apply = _hooks(kernel)
    j_eval = j_loop.make_batched_eval_step_single(jcfg, j_config.TrainConfig(**train), static,
                                                  mlp_apply=j_apply)
    arrays = j_val.device_arrays()
    base_key, step = jax.random.PRNGKey(10), 6
    want = jax.device_get(j_eval(jax.tree_util.tree_map(jnp.asarray, jp), arrays["images"],
                                 arrays["poses"], step, base_key))
    coords, uniforms = [], []
    for idx in range(j_val.num_frames):
        key = jax.random.fold_in(base_key, 10_000_000 + step + idx)
        xs, ys = j_synth.sample_random_coordinates(key, 32, static.height, static.width)
        coords.append((np.asarray(xs), np.asarray(ys)))
        uniforms.append(_coarse(jax.random.fold_in(key, 1), 32))
    t_eval = t_loop.make_batched_eval_step_single(tcfg, t_config.TrainConfig(**train),
                                                  t_loop.scene_static(t_val), mlp_apply=t_apply)
    got = t_eval(t_mlp.params_from_jax(jp, "cpu"), t_val.images, t_val.poses, step, 0,
                 coords=coords, uniforms=uniforms)
    assert sorted(got) == sorted(want) == ["val_loss"]
    assert got["val_loss"].shape == () and not got["val_loss"].requires_grad
    np.testing.assert_allclose(float(got["val_loss"]), float(want["val_loss"]), rtol=3e-5,
                               atol=1e-6)
    assert float(want["val_loss"]) > 1e-3
    # the draws of the port's own stream run too
    assert np.isfinite(float(t_eval(t_mlp.params_from_jax(jp, "cpu"), t_val.images,
                                    t_val.poses, step, 0)["val_loss"]))


def test_single_nerf_and_nerf_network_wrappers_match_jax():
    """``SingleNeRF`` and ``NeRFNetwork`` forwards on given params and draws
    against the JAX wrappers' with the same key; without params or draws
    they init from their seed and draw from (seed, call), so two wrappers of
    one seed agree and a second call draws anew."""
    o, d, _ = _rays(11, 16)
    key = jax.random.PRNGKey(12)
    jp = _he_mlp(13, width=256, rgb_width=128)
    want = j_nerf.SingleNeRF(position_dim=4, direction_dim=2, num_samples=8,
                             params=jax.tree_util.tree_map(jnp.asarray, jp)).forward(
        jnp.asarray(o), jnp.asarray(d), key=key)
    single = t_nerf.SingleNeRF(position_dim=4, direction_dim=2, num_samples=8,
                               params=t_mlp.params_from_jax(jp, "cpu"), device="cpu")
    got = single.forward(T(o), T(d), uniforms=_coarse(key, 16))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)

    jnet = {k: _he_mlp(s, width=256, rgb_width=128) for k, s in (("coarse", 14), ("fine", 15))}
    want = j_nerf.NeRFNetwork(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8,
                              params=jax.tree_util.tree_map(jnp.asarray, jnet)).forward(
        jnp.asarray(o), jnp.asarray(d), key=key)
    k_coarse, k_cdf = jax.random.split(key)
    k_eps, k_jit = jax.random.split(k_cdf)
    draws = {"coarse": T(jax.random.uniform(k_coarse, (16, 8))),
             "eps": T(jax.random.uniform(k_eps, (16, 1))),
             "jitter": T(jax.random.uniform(k_jit, (16, 8, 1)))}
    net = t_nerf.NeRFNetwork(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8,
                             params=t_mlp.params_from_jax(jnet, "cpu"), device="cpu")
    got = net.forward(T(o), T(d), uniforms=draws)
    assert sorted(got) == sorted(want) == ["coarse_rgb_rays", "fine_rgb_rays"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)

    a, b = (t_nerf.SingleNeRF(num_samples=8, seed=3, device="cpu") for _ in range(2))
    first = a(T(o), T(d))["pred_rgbs"]
    assert torch.equal(first, b(T(o), T(d))["pred_rgbs"])
    assert not torch.equal(first, a(T(o), T(d))["pred_rgbs"])
    net = t_nerf.NeRFNetwork(coarse_samples=4, fine_samples=4, device="cpu")
    out = net(T(o), T(d))
    assert out["fine_rgb_rays"].shape == (16, 3) and torch.isfinite(out["fine_rgb_rays"]).all()


def _trainer(root, base_dir, name="s", **kw):
    train = {k: kw.pop(k) for k in list(kw) if k in TRAIN or k == "steps_per_call"}
    return t_trainer.Trainer(t_nerf.NeRFConfig(**NERF), t_config.TrainConfig(**dict(TRAIN, **train)),
                             base_dir, root, name=name, device="cpu", mode="single", **kw)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_trainer_single_fit_checkpoints_and_resume(fixture_scene, tmp_path):
    """``Trainer(mode="single")``: CSV rows at 2, 4, 6, 7 with validation
    rows (coarse-only ``val_loss``) at 3 and 6, a val view at 3,
    single-mode checkpoints of one MLP (62 leaves) at 3, 4, 6, 7; a run
    resumed from the step-4 checkpoint ends on the uninterrupted run's state
    bit for bit; JAX's ``load_state_for_inference`` reads the port's
    checkpoint leaf for leaf, and a full checkpoint cannot resume a single
    run."""
    trainer = _trainer(tmp_path, fixture_scene)
    final = trainer.fit()
    run = tmp_path / "s"
    rows = _rows(run / "metrics.csv")
    steps = [int(r["step"]) for r in rows]
    assert steps == [2, 3, 4, 6, 6, 7]
    val = [r for r in rows if r.get("val_loss")]
    assert [int(r["step"]) for r in val] == [3, 6]
    assert all(np.isfinite(float(r["val_loss"])) for r in val)
    assert "val_coarse_loss" not in rows[0]
    train_rows = [r for r in rows if r.get("train_loss")]
    assert {"train_loss", "grad_2.0_norm_total", "lr"} <= set(train_rows[0])
    assert list((run / "images").glob("recon-val*-3.png"))
    names = sorted(p.name for p in (run / "checkpoints").glob("*.ckpt"))
    assert names == [f"model=s-epoch={s // 3}-step={s}.ckpt" for s in (3, 4, 6, 7)]
    last = run / "checkpoints" / "model=s-epoch=2-step=7.ckpt"
    header = t_ckpt.read_header(last)
    assert header["extra"] == {"mode": "single"} and header["num_leaves"] == 62

    # JAX reads the port's single checkpoint leaf for leaf
    jp, jcfg, jtcfg, grid, step = j_trainer.load_state_for_inference(str(last))
    assert (step, grid, jcfg.coarse_samples) == (7, None, 8)
    for a, b in zip(t_ckpt.flatten_tree(jax.device_get(jp)), t_ckpt.flatten_tree(final)):
        np.testing.assert_array_equal(a, b.detach().numpy())
    tp, *_ = t_trainer.load_state_for_inference(last, device="cpu")
    assert sorted(tp) == ["density", "feature", "rgb", "trunk"]
    with pytest.raises(ValueError, match="single"):
        t_inf.build_render_chunk(str(last), 32, device="cpu")

    resumed = _trainer(tmp_path, fixture_scene, name="r",
                       resume_ckpt=str(run / "checkpoints" / "model=s-epoch=1-step=4.ckpt"))
    again = resumed.fit()
    for a, b in zip(t_ckpt.flatten_tree(again), t_ckpt.flatten_tree(final)):
        assert torch.equal(a, b)
    full = tmp_path / "full.ckpt"
    t_ckpt.save_checkpoint(full, t_nerf.init_nerf_network(
        torch.Generator().manual_seed(0), t_nerf.NeRFConfig(**NERF), device="cpu"), 4,
        t_nerf.NeRFConfig(**NERF).to_dict(), t_config.TrainConfig(**TRAIN).to_dict())
    with pytest.raises(ValueError, match="full"):
        _trainer(tmp_path, fixture_scene, name="x", resume_ckpt=str(full)).init_state()


def test_jax_single_checkpoint_resumes_in_the_port(fixture_scene, tmp_path):
    """A single-mode checkpoint written by JAX (one MLP, optax's Adam state
    after real updates) loads leaf for leaf in the port, moments and count
    too, and a port Trainer resumes from it."""
    jcfg = j_nerf.NeRFConfig(**NERF)
    j_tcfg = j_config.TrainConfig(**dict(TRAIN, kernel="xla"))
    params = j_mlp.init_nerf_mlp(jax.random.PRNGKey(16), 4, 2)
    tx = j_loop.make_optimizer(j_tcfg, 3)
    opt_state = tx.init(params)
    grads = jax.tree_util.tree_map(lambda a: jnp.full_like(a, 1e-3), params)
    for _ in range(2):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    path = tmp_path / "model=j-epoch=1-step=5.ckpt"
    j_ckpt.save_checkpoint(path, params, opt_state, 5, jcfg.to_dict(), j_tcfg.to_dict(),
                           extra={"mode": "single"})
    tp, ncfg, tcfg, grid, step = t_trainer.load_state_for_inference(path, device="cpu")
    assert (step, grid, ncfg.coarse_samples, tcfg.kernel) == (5, None, 8, "xla")
    for a, b in zip(t_ckpt.flatten_tree(jax.device_get(params)), t_ckpt.flatten_tree(tp)):
        np.testing.assert_array_equal(a, b.numpy())
    trainer = _trainer(tmp_path, fixture_scene, name="j", resume_ckpt=str(path))
    p, state, start = trainer.init_state()
    assert start == 5 and state["count"] == 2
    mu = t_ckpt.flatten_tree(jax.device_get(opt_state[0].mu))
    for a, b in zip(mu, t_ckpt.flatten_tree(state["mu"])):
        np.testing.assert_array_equal(a, b.numpy())
    trainer.fit()
    assert (tmp_path / "j" / "checkpoints" / "model=j-epoch=2-step=7.ckpt").is_file()


@pytest.mark.parametrize("kernel", ["auto", "pallas"])
def test_train_single_cli(fixture_scene, tmp_path, kernel):
    """``train single`` through ``train.main`` (``tests/test_cli.py``'s
    ``test_train_single_cli``): checkpoints of the single mode at the
    kernel the run resolved (``auto`` on the CPU is the plain path), one
    step per call, no crop warmup."""
    trainer = t_train.main(["--device", "cpu", "-n", "singletest", "-s", "4", "-r", "64", "-rd",
                            str(tmp_path), "--precision", "fp32", "--kernel", kernel, "single",
                            "-b", str(fixture_scene), "-c", "8"])
    ckpts = sorted((tmp_path / "singletest" / "checkpoints").glob("*.ckpt"))
    assert ckpts
    header = t_ckpt.read_header(ckpts[-1])
    assert header["extra"]["mode"] == "single" and header["step"] == 4
    tcfg = header["train_config"]
    assert (tcfg["kernel"], tcfg["cropping_epochs"], tcfg["steps_per_call"]) == (
        "xla" if kernel == "auto" else "pallas", 0, 1)
    assert header["nerf_config"]["coarse_samples"] == 8
    assert trainer.mode == "single" and (trainer.mlp_apply is None) == (kernel == "auto")
