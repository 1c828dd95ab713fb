"""TensoRF's field in the port (``models/tensorf.py``, the VM sampling's plain
versions in ``kernels/vm_sample.py``, the field's Adam in
``training/loop.py``) against the plain reference ``nerfbench/
reference/tensorf.py`` on the CPU, at a small size (N 8, 2 + 3 components
a mode, 5 appearance features, an 8-wide MLP) and on seeded random
weights, in fp32.

Tolerances: the port samples the factors with its own index arithmetic and
the reference with ``grid_sample``, which computes the same bilinear
weights in another order, so the densities and colors agree to fp32
rounding (1e-6 relative); the factors' gradients sum their terms in
another order too (``index_add_`` against ``grid_sample``'s backward),
1e-5 relative. A train step's Adam update is ``lr * m / sqrt(v)``, whose
direction swings for an entry whose gradient is at the level of that
round-off, so the steps are held by each leaf's change over the steps and
its first moment, relative in L2 (1e-4), and by the losses (1e-5). bf16 in
place of fp32, in the factors or in the MLP, moves the densities or the
colors by 1e-3 or more (``test_tolerances_catch_bf16``).
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from minimal_nerf_torch.fields import checkpoint_field
from minimal_nerf_torch.kernels import vm_sample as vm
from minimal_nerf_torch.models.nerf import NeRFConfig
from minimal_nerf_torch.models.tensorf import TensoRFConfig, TensoRFField, param_shapes
from minimal_nerf_torch.training import loop
from minimal_nerf_torch.training.checkpoint import flatten_tree, save_checkpoint
from minimal_nerf_torch.training.config import TrainConfig
from nerfbench.fields import tensorf as F
from nerfbench.reference import nerf as R
from nerfbench.reference import tensorf as RT
from nerfbench.traffic import generate as gen

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"resolution": 8, "density_components": 2, "app_components": 3, "app_dim": 5,
         "feature_width": 8, "coarse_samples": 8, "fine_samples": 8}
TRAFFIC = {"frames": 3, "height": 16, "width": 16, "camera_angle_x": 0.6911112070083618,
           "radius": 4.0, "phi_deg": -30.0,
           "weights": {"gain": math.sqrt(6.0), "density_bias": 0.5},
           "grid": {"spheres": 6, "center_extent": 1.0, "radius_range": [0.3, 0.8],
                    "density": 8.0}}
FEATURE_RTOL = 1e-6   # the same operations, grid_sample's weights in another order
GRAD_RTOL = 1e-5      # the factors' terms summed in another order
STEP_RTOL = 1e-4      # a leaf's change over three Adam steps (module doc)
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny CPU runs take one thread: with a thread per core in every
    parallel test worker, PyTorch's threads mostly wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def small_cfg(**tensorf):
    """The benchmark's configuration at the test's size, in fp32."""
    cfg = json.loads((ROOT / "nerfbench/configs/tensorf_vm192_16_48.json").read_text())
    cfg["tensorf"].update(SMALL, **tensorf)
    cfg["train"].update(num_rays=64, precision="fp32", steps_per_call=3)
    cfg["occupancy"].update(resolution=8, warmup_steps=0)
    return cfg


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def weights(cfg, seed=7):
    return F.weights(seed, cfg, TRAFFIC, "cpu")


def _points(n, s, seed):
    """Points over ``[-1.8, 1.8]^3`` (some outside the box), the first ray's
    first points on the box's far faces and corners."""
    x = (torch.rand(n, s, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1) * 1.8
    x[0, 0] = torch.tensor([1.5, 1.5, 1.5])
    x[0, 1] = torch.tensor([-1.5, 0.3, 1.5])
    x[0, 2] = torch.tensor([0.2, 1.5, -1.5])
    return x


def test_published_sizes_and_counts():
    """lego.txt's sizes: 4,320,000 + 12,960,000 plane entries, 14,400 +
    43,200 line entries, 3,888 basis entries, 36,227 MLP parameters
    (17,377,715 in all); the MLP reads 150 values; the basis and MLP's
    39,856 multiply-adds a point forward and 77,792 backward; 592 bytes a
    point that no sampling kernel avoids."""
    cfg = TensoRFConfig()
    sizes = {k: math.prod(s) for k, s in param_shapes(cfg).items() if k != "mlp"}
    assert sizes == {"density_planes": 4_320_000, "app_planes": 12_960_000,
                     "density_lines": 14_400, "app_lines": 43_200, "basis": 3_888}
    mlp = sum(math.prod(s) for s in flatten_tree(param_shapes(cfg)["mlp"]))
    assert mlp == 36_227 and cfg.mlp_input == 150
    assert sum(sizes.values()) + mlp == 17_377_715
    bench = json.loads((ROOT / "nerfbench/configs/tensorf_vm192_16_48.json").read_text())
    assert F.mlp_macs(bench) == (3_888 + 19_200 + 16_384 + 384, 2 * 39_856 - 15 * 128)
    assert F.points_per_ray(bench) == 80 and F.vm_bytes_per_point(bench) == 592
    assert TensoRFConfig.from_dict(bench["tensorf"]) == cfg
    assert F.shapes(bench["tensorf"]) == param_shapes(cfg)


def test_cells_and_places_by_hand():
    """The near and far faces, the center and an outside point: ``(x + 1.5)
    * (2 / 3) - 1`` then ``* 0.5 * 299`` after ``+ 1``; the far face lands
    in the last cell at its far side."""
    x = torch.tensor([[-1.5, 0.0, 1.5], [1.6, 0.0, 0.0], [0.75, -0.75, 0.3]])
    inside, cell, frac = vm.locate(x, 1.5, 300)
    assert inside.tolist() == [True, False, True]
    assert cell[0].tolist() == [0, 149, 298] and frac[0, 0] == 0.0 and frac[0, 2] == 1.0
    assert abs(float(frac[0, 1]) - 0.5) < 1e-6
    assert cell[2].tolist() == [224, 74, 179]  # 224.25, 74.75, 179.4
    plane, line = vm._corners(cell, frac, 300, 1)  # mode 1: plane (w, h) = (0, 2), line 1
    assert int(plane[0][0][2]) == 179 * 300 + 224 and int(plane[3][0][2]) == 180 * 300 + 225
    assert int(line[1][0][2]) == 75


@pytest.mark.parametrize("kernels", [True, False], ids=["function", "plain"])
def test_density_and_color(kernels):
    cfg = small_cfg()
    params = weights(cfg)
    field = TensoRFField(TensoRFConfig.from_dict(cfg["tensorf"]), kernels)
    ref = RT.tensorf_field(cfg)
    x, d = _points(64, 5, 1), torch.randn(64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), R.exact_float32():
        sigma, rgb = field.apply(params, x, d)
        r_sigma, r_rgb = ref.point(params, "fine", x, d, RT.Numerics())
        density = field.density(params, x.reshape(-1, 3))
        r_density = ref.density(params, x.reshape(-1, 3), RT.Numerics())
    assert rel(sigma[..., 0], r_sigma) < FEATURE_RTOL and rel(rgb, r_rgb) < FEATURE_RTOL
    assert rel(density, r_density) < FEATURE_RTOL
    outside = (x.abs() > 1.5).any(dim=-1)
    assert torch.all(sigma[..., 0][outside] == 0) and torch.all(sigma[..., 0][~outside] > 0)
    assert float(r_sigma.std()) > 0.1 and float(r_rgb.std()) > 0.02  # the weights vary


@pytest.mark.parametrize("kernels", [True, False], ids=["function", "plain"])
def test_gradients_of_every_leaf(kernels):
    """Every leaf's gradient, with points outside the box (which send the
    factors none) and on its far faces and corners."""
    cfg = small_cfg()
    params = R.map_tree(lambda t: t.requires_grad_(True), weights(cfg))
    field = TensoRFField(TensoRFConfig.from_dict(cfg["tensorf"]), kernels)
    ref = RT.tensorf_field(cfg)
    x, d = _points(128, 4, 3), torch.randn(128, 3, generator=torch.Generator().manual_seed(4))
    probe = torch.randn(128, 4, 4, generator=torch.Generator().manual_seed(5))

    def grads(sigma, rgb):
        loss = torch.sum(torch.cat([sigma, rgb], dim=-1) * probe)
        return torch.autograd.grad(loss, R.leaves(params))

    with R.exact_float32():
        got = grads(*field.apply(params, x, d))
        r_sigma, r_rgb = ref.point(params, "fine", x, d, RT.Numerics())
        want = grads(r_sigma[..., None], r_rgb)
    assert len(got) == 11
    for g, w in zip(got, want):
        assert rel(g, w) < GRAD_RTOL
    # only points inside reach the factors: the far corner's rows are touched
    inside_only = _points(128, 4, 3)[(_points(128, 4, 3).abs() <= 1.5).all(dim=-1)]
    _, cell, _ = vm.locate(inside_only, 1.5, 8)
    assert int((got[4] != 0).any(dim=-1).sum()) <= 3 * 4 * cell.shape[0]
    assert bool((got[4][0, 7, 7] != 0).any())  # the corner (1.5, 1.5, 1.5) on mode 0


def test_tolerances_catch_bf16():
    """The factors or the MLPs one precision step lower (bf16) move the
    densities and colors beyond the tolerances above."""
    cfg = small_cfg()
    params = weights(cfg)
    field, ref = TensoRFField(TensoRFConfig.from_dict(cfg["tensorf"])), RT.tensorf_field(cfg)
    x, d = _points(64, 5, 1), torch.randn(64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), R.exact_float32():
        r_sigma, r_rgb = ref.point(params, "fine", x, d, RT.Numerics())
        low = dict(params, **{k: params[k].bfloat16().float() for k in vm.KEYS})
        sigma, rgb = field.apply(low, x, d)
        assert rel(sigma[..., 0], r_sigma) > 100 * FEATURE_RTOL
        assert rel(rgb, r_rgb) > 100 * FEATURE_RTOL
        sigma, rgb = field.apply(params, x, d, compute_dtype=torch.bfloat16)
        assert rel(rgb, r_rgb) > 100 * FEATURE_RTOL


def test_adam_apply_lr_scale_and_l1():
    """The field's Adam on hand-made gradients: b2 0.99 and eps 1e-8; the
    basis and MLP at 0.05 of the learning rate; ``w / numel`` of one mode's
    density plane or line times ``sign(p)`` added to their gradients, ``w``
    the sixth scalar; a leaf with neither takes optax's update bit for bit."""
    cfg = small_cfg()
    field = TensoRFField(TensoRFConfig.from_dict(cfg["tensorf"]))
    params = weights(cfg)
    before = R.map_tree(lambda t: t.clone(), params)
    grads = R.map_tree(lambda t: torch.randn(t.shape, generator=torch.Generator().manual_seed(
        t.numel())), params)
    state = loop.adam_init(params)
    scalars = loop.adam_scalars(torch.tensor(2e-2), 1, 0.9, 0.99, l1=0.5)
    assert scalars.shape == (6,) and float(scalars[5]) == 0.5
    loop.adam_apply(params, grads, state, scalars, **field.adam_options(params))
    g = grads["density_planes"] + 0.5 / (8 * 8 * 2) * torch.sign(before["density_planes"])
    torch.testing.assert_close(state["mu"]["density_planes"], 0.1 * g)
    g = grads["density_lines"] + 0.5 / (8 * 2) * torch.sign(before["density_lines"])
    torch.testing.assert_close(state["nu"]["density_lines"], 0.01 * g * g)
    step = lambda m, v: m / 0.1 / ((v / 0.01).sqrt() + 1e-8)  # noqa: E731
    m, v = state["mu"]["basis"], state["nu"]["basis"]
    torch.testing.assert_close(params["basis"], before["basis"] - 0.05 * 2e-2 * step(m, v))
    torch.testing.assert_close(state["mu"]["app_planes"], 0.1 * grads["app_planes"])
    # a leaf at scale 1 with no L1 term: optax's update, bit for bit
    plain = R.map_tree(lambda t: t.clone(), before)
    plain_state = loop.adam_init(plain)
    loop.adam_apply(plain, grads, plain_state, scalars[:5], 0.9, 0.99, 1e-8)
    assert torch.equal(plain["app_planes"], params["app_planes"])
    assert field.l1_weight(1999) == 8e-5 and field.l1_weight(2000) == 4e-5


def _scene(cfg, seed=5):
    images, poses, focal = gen.scene(seed, TRAFFIC, "cpu")
    grid = gen.grid(seed, cfg["occupancy"], TRAFFIC["grid"], "cpu")
    return images, poses, focal, grid


def _program_steps(cfg, params, make, kernels, seed, start, n):
    images, poses, focal, grid = _scene(cfg)
    nerf_cfg, train_cfg, tensorf_cfg = F.program_configs(cfg)
    field = TensoRFField(tensorf_cfg, kernels)
    static = loop.SceneStatic(TRAFFIC["height"], TRAFFIC["width"], focal, TRAFFIC["frames"])
    occ_cfg = train_cfg.occupancy_config
    params = R.map_tree(lambda t: t.clone(), params)
    state = loop.adam_init(params)
    if make == "multi":
        fn = loop.make_multi_step(nerf_cfg, train_cfg, static, n, None, "cpu", None, occ_cfg,
                                  field=field)
        params, state, grid, metrics = fn(params, state, grid, images, poses, start, seed)
        return params, state, grid, [float(metrics["train_loss"])]
    fn = loop.make_train_step(nerf_cfg, train_cfg, static, None, "cpu", None, occ_cfg,
                              field=field)
    losses = []
    for s in range(start, start + n):
        params, state, grid, metrics = fn(params, state, grid, images, poses, s, seed)
        losses.append(float(metrics["train_loss"]))
    return params, state, grid, losses


@pytest.mark.parametrize("make,kernels", [("single", True), ("multi", True), ("multi", False)],
                         ids=["train_step-function", "multi_step-function", "multi_step-plain"])
def test_three_train_steps_match_the_reference(make, kernels):
    """Three steps from step 16 (a grid update first) through
    ``make_train_step`` or ``make_multi_step`` against the reference's
    ``train_steps`` on the same draws, the L1 weight switching after the
    first update (``l1_switch`` 1, weights large enough to move the
    density factors): losses, each leaf's change, the moments, the grid."""
    cfg = small_cfg(l1_initial=0.5, l1_rest=0.2, l1_switch=1)
    params0 = weights(cfg)
    seed, start = 2 ** 31 + 17, 16
    params, state, grid, losses = _program_steps(cfg, params0, make, kernels, seed, start, 3)
    images, poses, focal, grid0 = _scene(cfg)
    with R.exact_float32():
        ref = R.train_steps(params0, cfg, images, poses, focal, seed, start, 3,
                            RT.reference_numerics(cfg), grid0, 32, field=RT.tensorf_field(cfg))
        no_l1 = R.train_steps(params0, small_cfg(l1_initial=0.0, l1_rest=0.0), images, poses,
                              focal, seed, start, 3, RT.reference_numerics(cfg), grid0, 32,
                              field=RT.tensorf_field(small_cfg(l1_initial=0.0, l1_rest=0.0)))
    want = ref["losses"] if make == "single" else ref["losses"][-1:]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    got, p0 = flatten_tree(params), R.leaves(params0)
    for g, r, a in zip(got, ref["params"], p0):
        assert rel(g - a, r - a) < STEP_RTOL
    for g, r in zip(flatten_tree(state["mu"]), ref["mu"]):
        assert rel(g, r) < STEP_RTOL
    assert rel(grid, ref["grid"]) < FEATURE_RTOL and state["count"] == 3
    # the L1 term moved the density factors well beyond the tolerance
    assert rel(ref["mu"][4], no_l1["mu"][4]) > 100 * STEP_RTOL


def test_grid_update_reads_the_field_density():
    cfg = small_cfg()
    params = weights(cfg)
    nerf_cfg, train_cfg, tensorf_cfg = F.program_configs(cfg)
    _, _, _, grid = _scene(cfg)
    got = grid.clone()
    loop.update_step_grid(train_cfg.occupancy_config, nerf_cfg, None, params, got, 32, 9,
                          field=TensoRFField(tensorf_cfg))
    with R.exact_float32():
        want = R.update_grid(grid, params, cfg, 32, 9, RT.reference_numerics(cfg),
                             RT.tensorf_field(cfg))
    assert rel(got, want) < FEATURE_RTOL and not torch.equal(got, grid)


def _checkpoint(tmp_path, cfg, params, grid):
    nerf_cfg, train_cfg, tensorf_cfg = F.program_configs(cfg)
    return save_checkpoint(tmp_path / "model=tensorf-epoch=3-step=300.ckpt", params, 300,
                           nerf_cfg.to_dict(), train_cfg.to_dict(),
                           extra=dict({"mode": "full"}, **TensoRFField(tensorf_cfg).header()),
                           grid=grid)


def test_checkpoint_round_trip(tmp_path):
    from minimal_nerf_torch.training.checkpoint import read_header
    from minimal_nerf_torch.training.trainer import load_state_for_inference

    cfg = small_cfg()
    params = weights(cfg)
    _, _, _, grid = _scene(cfg)
    path = _checkpoint(tmp_path, cfg, params, grid)
    header = read_header(path)
    assert header["num_leaves"] == 1 + 2 + 3 * 11
    field = checkpoint_field(header)
    assert isinstance(field, TensoRFField) and field.cfg == F.program_configs(cfg)[2]
    loaded, _, _, loaded_grid, step = load_state_for_inference(path, "cpu")
    assert step == 300 and torch.equal(loaded_grid, grid)
    assert all(torch.equal(a, b) for a, b in zip(flatten_tree(loaded), flatten_tree(params)))
    assert field.shapes()["app_planes"] == (3, 8, 8, 3)
    assert dataclasses.asdict(field.cfg) == TensoRFConfig.from_dict(
        field.cfg.to_dict()).to_dict()


@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_render_chunk_of_a_tensorf_checkpoint(tmp_path, kernel):
    """One chunk of ``inference.build_render_chunk`` of a TensoRF checkpoint
    (through the grid it saved) against the reference's render on the same
    draws."""
    from minimal_nerf_torch import inference

    cfg = small_cfg()
    params = weights(cfg)
    _, poses, focal, grid = _scene(cfg)
    path = _checkpoint(tmp_path, cfg, params, grid)
    chunk, _, _ = inference.build_render_chunk(str(path), rays=48, kernel=kernel, device="cpu")
    flat = torch.arange(48)
    o, d = R.pixel_rays((flat % 16).float(), (flat // 16).float(), 16, 16, focal, poses[0])
    o = o.contiguous()
    got = chunk(o, d, torch.Generator().manual_seed(11))
    draws = R.draw_uniforms(cfg, cfg["tensorf"], 48, torch.Generator().manual_seed(11))
    with torch.no_grad(), R.exact_float32():
        want = R.render(RT.tensorf_field(cfg), params, cfg, o, d, draws, RT.Numerics(),
                        R.occupied(grid, cfg["occupancy"], False))[1]
    assert rel(got, want) < 1e-5


def test_train_cli_trains_renders_and_scores_the_field(fixture_scene, tmp_path):
    """``train full --fast --field tensorf`` at the published sizes (two
    calls of 3 steps), its checkpoint naming the field, rendered by the
    render CLI and scored by the score CLI; data parallel raises."""
    from minimal_nerf_torch import render, score, train
    from minimal_nerf_torch.training.checkpoint import read_header

    args = ["--device", "cpu", "-n", "tensorf", "-s", "6", "-r", "32", "--precision", "fp32",
            "--log-every", "3", "--steps-per-call", "3", "-rd", str(tmp_path), "full", "-b",
            str(fixture_scene), "-c", "8", "-f", "8", "--fast", "--field", "tensorf",
            "--occ-resolution", "8", "--occ-warmup-steps", "2"]
    trainer = train.main(args)
    params = trainer.final_state[0]
    assert set(params) == {"density_planes", "density_lines", "app_planes", "app_lines",
                           "basis", "mlp"}
    assert tuple(params["app_planes"].shape) == (3, 300, 300, 48)
    tc = trainer.train_config
    assert (tc.start_lr, tc.end_lr, tc.lr_decay_epochs) == (0.02, 0.002, 300)
    ckpt = sorted((tmp_path / "tensorf" / "checkpoints").glob("*.ckpt"))[-1]
    assert read_header(ckpt)["extra"]["field"] == "tensorf"
    gif = render.main(["-c", str(ckpt), "-r", "64", "-p", "1", "--height", "8", "--width", "8",
                       "--device", "cpu", "-s", str(tmp_path / "recons")])
    assert gif.is_file()
    scores = score.main(["-c", str(ckpt), "-r", "1024", "-b", str(fixture_scene), "--limit",
                         "1", "--device", "cpu"])
    assert all(np.isfinite(scores))
    assert len((tmp_path / "tensorf" / "metrics.csv").read_text().splitlines()) >= 3
    with pytest.raises(ValueError, match="one device"):
        loop.make_train_step(NeRFConfig(), TrainConfig(), loop.SceneStatic(8, 8, 5.0, 1),
                             device="cpu", field=TensoRFField(),
                             mesh=type("M", (), {"size": 2})())


def test_kernel_inputs_are_checked():
    """The kernels take the published component counts (16 + 48), fp32,
    contiguous, on one device, and CUDA tensors only (``vm_sample`` too);
    the plain version takes any, and the field sends CPU tensors to it."""
    small = {k: torch.zeros(s) for k, s in param_shapes(TensoRFConfig(resolution=4)).items()
             if k in vm.KEYS}
    vm.check_inputs(torch.zeros(4, 3), small)
    for bad in ({"density_planes": torch.zeros(3, 4, 4, 8)},
                {"app_lines": torch.zeros(3, 4, 48, dtype=torch.float64)},
                {"app_planes": torch.zeros(3, 4, 4, 48).transpose(1, 2)}):
        with pytest.raises(ValueError):
            vm.check_inputs(torch.zeros(4, 3), dict(small, **bad))
    with pytest.raises(ValueError):
        vm.check_inputs(torch.zeros(4, 2), small)
    with pytest.raises(ValueError, match="CUDA"):
        vm.forward(torch.zeros(4, 3), small, 1.5)
    with pytest.raises(ValueError, match="CUDA"):
        vm.backward(torch.zeros(4, 3), small, 1.5, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        vm.vm_sample(torch.zeros(4, 3), small, 1.5)
    tiny_cfg = TensoRFConfig.from_dict(SMALL)
    tiny = {k: torch.rand(s) for k, s in param_shapes(tiny_cfg).items() if k in vm.KEYS}
    f_sigma, prods = TensoRFField(tiny_cfg, kernels=True).sample(tiny, torch.zeros(5, 3))
    assert f_sigma.shape == (5,) and prods.shape == (5, 9)


@pytest.mark.parametrize("given", ["both", "sigma", "prods"])
def test_backward_plain_matches_autograd_of_sample_plain(given):
    """``backward_plain``, the backward kernel's reference on the card,
    against autograd through ``sample_plain`` on the CPU, with points
    outside the box and on its far faces and corners, and with either
    output's gradient left out (None)."""
    cfg = small_cfg()
    factors = {k: t.requires_grad_(True) for k, t in weights(cfg).items() if k in vm.KEYS}
    x = _points(96, 4, 6).reshape(-1, 3)
    gen = torch.Generator().manual_seed(8)
    g_s = torch.randn(x.shape[0], generator=gen) if given != "prods" else None
    g_p = torch.randn(x.shape[0], 9, generator=gen) if given != "sigma" else None
    with R.exact_float32():
        f_sigma, prods = vm.sample_plain(x, factors, 1.5)
        loss = 0.0
        if g_s is not None:
            loss = loss + torch.sum(torch.where(torch.isfinite(f_sigma), f_sigma, 0.0) * g_s)
        if g_p is not None:
            loss = loss + torch.sum(prods * g_p)
        want = torch.autograd.grad(loss, [factors[k] for k in vm.KEYS], allow_unused=True)
        got = vm.backward_plain(x, {k: t.detach() for k, t in factors.items()}, 1.5, g_s, g_p)
    for key, g, w in zip(vm.KEYS, got, want):
        w = torch.zeros_like(g) if w is None else w
        assert g.shape == factors[key].shape
        assert (rel(g, w) < GRAD_RTOL) if bool(w.any()) else not bool(g.any()), key


def test_a_step_keeps_the_field_spans():
    """Inside the tracer, a TensoRF step keeps ``nerf.tensorf.sample`` and
    ``nerf.tensorf.mlp`` spans: both passes and the grid update."""
    from minimal_nerf_torch.utils import profiling

    cfg = small_cfg()
    profiling.reset()
    with profiling.tracing():
        _program_steps(cfg, weights(cfg), "single", True, 3, 16, 1)
    names = [s.name for s in profiling.spans()]
    assert names.count("nerf.tensorf.sample") == 3 and names.count("nerf.tensorf.mlp") == 3
