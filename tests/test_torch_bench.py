"""``python -m minimal_nerf_torch.bench`` against the JAX package's
``bench.py``: the scene and the init bit for bit, the JSON line's keys, the
window arithmetic, no fallback, the bench's call against JAX's
``make_multi_step`` as ``bench.py`` builds it, and the fast path's call
against eager steps. On the CPU, tiny: 3 frames of 12x12, 16 rays, widths
64/32 where steps run.
"""

import ast
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_multi_step import _jax_step_inputs

from minimal_nerf_torch import bench
from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops import occupancy as t_occ
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import loop as t_loop
from minimal_nerf_torch.training.checkpoint import flatten_tree
from minimal_nerf_torch.utils import threefry
from minimal_nerf_tpu.data import synthetic as j_synth
from minimal_nerf_tpu.kernels import fused_raymarch as j_fused
from minimal_nerf_tpu.models import nerf as j_nerf
from minimal_nerf_tpu.training import config as j_config
from minimal_nerf_tpu.training import loop as j_loop

ROOT = Path(__file__).resolve().parents[1]
NERF = dict(position_dim=4, direction_dim=2)
HE_GAIN = np.float32(np.sqrt(6.0))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny CPU runs take one thread: with a thread per core in every
    parallel test worker, PyTorch's threads mostly wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tiny_init():
    """The bench's init scheme (JAX's ``init_nerf_network`` from
    ``PRNGKey(0)``) at widths 64/32, as numpy, its weights scaled to
    He-uniform (times sqrt(6)): at this size the plain scale leaves the
    coarse MLP's densities at 0 and its gradients too."""
    keys = threefry.split(threefry.prng_key(bench.SEED))
    tree = {k: threefry.init_nerf_mlp(key, NERF["position_dim"], NERF["direction_dim"],
                                      width=64, rgb_width=32)
            for k, key in zip(("coarse", "fine"), keys)}
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * HE_GAIN if path[-1].key == "w" else a, tree)


def test_bench_scene_matches_bench_py():
    """``bench.py:55-63``'s frames, poses and ``SceneStatic``, bit for bit."""
    images, poses, static = bench.bench_scene(3, 12, 12, "cpu")
    want = np.random.default_rng(0).integers(0, 256, (3, 12, 12, 3), dtype=np.uint8)
    want_poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    want_poses[:, 2, 3] = 4.0
    assert images.dtype == torch.uint8 and poses.dtype == torch.float32
    np.testing.assert_array_equal(images.numpy(), want)
    np.testing.assert_array_equal(poses.numpy(), want_poses)
    j_static = j_loop.SceneStatic(height=12, width=12, focal=1111.111, num_frames=3)
    assert dataclasses.asdict(static) == dataclasses.asdict(j_static)


def test_bench_init_matches_jax():
    """``init_nerf_network(PRNGKey(0), NeRFConfig())``, leaf by leaf."""
    params = bench.bench_init(t_nerf.NeRFConfig(), "cpu")
    want = jax.device_get(j_nerf.init_nerf_network(jax.random.PRNGKey(0), j_nerf.NeRFConfig()))
    assert all(leaf.dtype == torch.float32 for leaf in flatten_tree(params))
    got = t_mlp.params_to_numpy(params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert len(jax.tree_util.tree_leaves(got)) == 40
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


class _FakeCalls:
    """``bench.TrainCalls`` without steps: records each call's start step
    and returns a fixed loss; raises on the kernel in ``fail``. The last
    one made is ``_FakeCalls.last``."""

    fail = None
    last = None

    def __init__(self, nerf_cfg, train_cfg, static, kernel, params, device,
                 occupancy_cfg=None, num_inner=20):
        if kernel == self.fail:
            raise RuntimeError(f"{kernel} failed to launch")
        self.starts = []
        _FakeCalls.last = self

    def __call__(self, images, poses, start_step, inputs=None):
        self.starts.append(start_step)
        return {"train_loss": torch.tensor(0.25)}


@pytest.fixture
def fake_calls(monkeypatch):
    monkeypatch.setattr(bench, "TrainCalls", _FakeCalls)
    monkeypatch.setattr(bench, "bench_init", lambda cfg, device: None)
    monkeypatch.setattr(_FakeCalls, "fail", None)
    return _FakeCalls


def _bench_py_keys():
    """The keys of the dict that ``bench.py`` prints with ``json.dumps``,
    read from its source (not imported: it imports JAX's TPU paths)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("bench.py prints no json.dumps({...})")


def test_json_line_has_bench_py_keys(fake_calls):
    keys = _bench_py_keys()
    assert {"metric", "value", "production_64_128_rays_per_sec"} <= keys
    line = bench.run("cpu", num_frames=2, height=8, width=8, num_rays=8, num_inner=2, reps=1,
                     windows=1)
    assert set(line) == keys | {"device", "power_limit"}
    assert line["metric"] == "train_rays_per_sec_per_chip_fast"
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert "quality-neutral" not in line["config"]


def test_window_arithmetic(fake_calls):
    """Each window's rate is ``reps * num_inner * num_rays / elapsed`` on the
    injected clock, the value their maximum; the warm-up call starts at 0
    and ``start_step`` advances by ``num_inner`` per call across windows."""
    ticks = iter([0.0, 1.0, 1.0, 3.0, 10.0, 12.0, 20.0, 25.0, 30.0, 34.0])
    tcfg = t_config.TrainConfig(num_rays=16, cropping_epochs=0)
    images, poses, static = bench.bench_scene(2, 8, 8, "cpu")
    out = bench.measure("fake", t_nerf.NeRFConfig(), tcfg, static, images, poses, "fused",
                        num_inner=4, windows=3, reps=2, clock=lambda: next(ticks))
    assert fake_calls.last.starts == [0, 4, 8, 12, 16, 20, 24]
    assert out["rates"] == [2 * 4 * 16 / 2.0, 2 * 4 * 16 / 5.0, 2 * 4 * 16 / 4.0]
    assert out["best"] == 2 * 4 * 16 / 2.0 and out["median"] == 2 * 4 * 16 / 4.0
    assert out["build_s"] == 1.0 and out["warmup_s"] == 2.0 and out["loss"] == 0.25
    assert out["peak_bytes"] is None


@pytest.mark.parametrize("failing", ["fused", "pallas"])
def test_failing_path_fails_the_run(fake_calls, monkeypatch, capsys, failing):
    """No fallback: a path that raises makes ``run`` raise, and nothing is
    printed on stdout (no ``xla`` measurement, no JSON line)."""
    monkeypatch.setattr(_FakeCalls, "fail", failing)
    with pytest.raises(RuntimeError, match=f"{failing} failed"):
        bench.run("cpu", num_frames=2, height=8, width=8, num_rays=8, num_inner=2, reps=1,
                  windows=1)
    out = capsys.readouterr()
    assert out.out == "" and "xla" not in out.err


def test_bench_calls_match_jax_make_multi_step():
    """Two calls of 2 steps through the bench's call (``TrainCalls``, fused,
    64+128 samples, fp32, no crop) from steps 0 and 2 on JAX's draws against
    ``bench.py``'s ``make_multi_step`` (fused render in interpret mode) on
    the same scene and init; tolerances of
    ``test_torch_multi_step.py::test_multi_step_matches_jax`` (four steps):
    ``4e-3 * lr`` per weight, ``8 * lr`` where a gradient came within 1e-6
    of 0; loss and gradient norm rtol 4e-5, the LR rtol 2e-7."""
    cfg = dict(NERF, coarse_samples=64, fine_samples=128)
    jcfg, tcfg_nerf = j_nerf.NeRFConfig(**cfg), t_nerf.NeRFConfig(**cfg)
    kw = dict(num_rays=16, cropping_epochs=0, precision="fp32")
    j_tcfg, t_tcfg = j_config.TrainConfig(**kw), t_config.TrainConfig(**kw)
    images, poses, static = bench.bench_scene(3, 12, 12, "cpu")
    j_static = j_loop.SceneStatic(**dataclasses.asdict(static))
    jp = _tiny_init()
    base_key = jax.random.PRNGKey(bench.SEED)

    loss_fn = functools.partial(j_loop.nerf_loss, render_fn=j_fused.make_fused_render_fn(
        ray_tile=8, interpret=True))
    j_multi, tx = j_loop.make_multi_step(jcfg, j_tcfg, j_static, num_inner=2, mlp_apply=None,
                                         occupancy_cfg=None, loss_fn=loss_fn)
    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    j_opt = tx.init(j_params)
    j_images, j_poses = j_synth.pack_images(images.numpy()), jnp.asarray(poses.numpy())
    for start in (0, 2):
        j_params, j_opt, j_metrics = j_multi(j_params, j_opt, j_images, j_poses, start,
                                             base_key)

    calls = bench.TrainCalls(tcfg_nerf, t_tcfg, static, "fused", t_mlp.params_from_jax(jp, "cpu"),
                             "cpu", num_inner=2)
    near_zero = [torch.zeros_like(leaf, dtype=torch.bool) for leaf in flatten_tree(calls.params)]
    grads_of = t_loop.loss_and_grads

    def recording(*args, **kwargs):
        metrics, grads = grads_of(*args, **kwargs)
        for z, g in zip(near_zero, flatten_tree(grads)):
            z |= g.abs() < 1e-6
        return metrics, grads

    t_loop.loss_and_grads = recording
    try:
        for start in (0, 2):
            inputs = [dict(t_loop.draw_step_inputs(tcfg_nerf, t_tcfg, static, s, s, bench.SEED,
                                                   "cpu"),
                           **_jax_step_inputs(base_key, s, static, t_tcfg, jcfg, 3))
                      for s in (start, start + 1)]
            t_metrics = calls(images, poses, start, inputs=inputs)
    finally:
        t_loop.loss_and_grads = grads_of

    lr = t_tcfg.start_lr
    for a, b, z in zip(flatten_tree(jax.device_get(j_params)), flatten_tree(calls.params),
                       near_zero):
        diff = np.abs(b.detach().numpy() - a)
        z = z.numpy()
        assert diff[~z].max(initial=0) <= 4 * 1e-3 * lr
        assert diff[z].max(initial=0) <= 4 * 2 * lr
    assert calls.opt_state["count"] == int(j_opt[0].count) == 4
    for k in ("train_loss", "grad_2.0_norm_total"):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=4e-5)
    np.testing.assert_allclose(float(t_metrics["lr"]), float(j_metrics["lr"]), rtol=2e-7)


def test_fast_calls_equal_eager_steps():
    """The fast path's call (``TrainCalls``, fused, occupancy, 16+48) twice
    at 2 steps against ``make_train_step`` stepped 4 times from the same
    init: parameters, Adam state, grid and last metrics bit for bit. A small
    grid (G=16) updated every 2nd step, its warmup ending at step 2."""
    cfg = t_nerf.NeRFConfig(**NERF, coarse_samples=16, fine_samples=48)
    tcfg = t_config.TrainConfig(num_rays=16, cropping_epochs=0, precision="fp32",
                                occupancy=True, occ_resolution=16, occ_num_bins=16,
                                occ_update_every=2, occ_warmup_steps=2)
    occ_cfg = tcfg.occupancy_config
    images, poses, static = bench.bench_scene(3, 12, 12, "cpu")
    calls = bench.TrainCalls(cfg, tcfg, static, "fused", t_mlp.params_from_jax(_tiny_init(), "cpu"),
                             "cpu", occ_cfg, num_inner=2)
    for start in (0, 2):
        multi_metrics = calls(images, poses, start)

    mlp_apply, render_fn = t_loop.kernel_hooks("fused", "cpu")
    step_fn = t_loop.make_train_step(cfg, tcfg, static, render_fn, "cpu", mlp_apply, occ_cfg)
    params = t_mlp.params_from_jax(_tiny_init(), "cpu")
    opt_state, grid = t_loop.adam_init(params), t_occ.init_grid(occ_cfg, "cpu")
    for step in range(4):
        params, opt_state, grid, metrics = step_fn(params, opt_state, grid, images, poses, step,
                                                   bench.SEED)

    assert calls.opt_state["count"] == opt_state["count"] == 4
    for a, b in zip(flatten_tree([calls.params, calls.opt_state["mu"], calls.opt_state["nu"],
                                  calls.grid]),
                    flatten_tree([params, opt_state["mu"], opt_state["nu"], grid])):
        assert torch.equal(a, b)
    assert multi_metrics.keys() == metrics.keys()
    for k in metrics:
        assert torch.equal(multi_metrics[k], metrics[k]), k
    assert float(metrics["occ_fraction"]) < 1.0
