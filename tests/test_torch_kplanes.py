"""K-Planes' hybrid field in the port (``models/kplanes.py``, the plane
sampling's plain versions in ``kernels/kplane_sample.py``, the TV term in
``training/loop.py::adam_apply``) against the plain reference
``nerfbench/reference/kplanes.py`` on the CPU, at small resolutions (4^2,
8^2, 16^2 and 32^2 planes) with the published 32 features a plane and
64-wide MLPs, on seeded random weights, in fp32.

Tolerances: the port samples the planes with its own index arithmetic and
the reference with ``grid_sample``, which computes the same bilinear
weights in another order, so the features, densities and colors agree to
fp32 rounding (1e-6 relative); the planes' gradients sum their terms in
another order too (``index_add_`` against ``grid_sample``'s backward),
1e-5 relative, and so does the TV term's stencil against autograd of the
authors' expression. A train step's Adam update is ``lr * m / sqrt(v)``,
whose direction swings for an entry whose gradient is at the level of that
round-off (at ``eps`` 1e-15 a gradient of any size moves its entry by the
learning rate), so the steps are held by each leaf's change over the steps
and its first moment, relative in L2 (1e-4), and by the losses (1e-5).
bf16 in place of fp32, in the planes or in the MLPs, moves the densities or
the colors by 1e-3 or more (``test_tolerances_catch_bf16``).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from minimal_nerf_torch.fields import checkpoint_field, make_field
from minimal_nerf_torch.kernels import kplane_sample as kp
from minimal_nerf_torch.models.kplanes import (KPlanesConfig, KPlanesField, param_shapes,
                                               trunc_exp)
from minimal_nerf_torch.models.nerf import NeRFConfig
from minimal_nerf_torch.training import loop
from minimal_nerf_torch.training.checkpoint import flatten_tree, save_checkpoint
from minimal_nerf_torch.training.config import TrainConfig
from nerfbench.fields import kplanes as F
from nerfbench.reference import kplanes as RK
from nerfbench.reference import nerf as R
from nerfbench.traffic import generate as gen

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"base_resolution": 4, "coarse_samples": 8, "fine_samples": 8}
TRAFFIC = {"frames": 3, "height": 16, "width": 16, "camera_angle_x": 0.6911112070083618,
           "radius": 4.0, "phi_deg": -30.0,
           "weights": {"gain": math.sqrt(6.0), "density_bias": 0.5},
           "grid": {"spheres": 6, "center_extent": 1.0, "radius_range": [0.3, 0.8],
                    "density": 8.0}}
FEATURE_RTOL = 1e-6   # the same operations, grid_sample's weights in another order
GRAD_RTOL = 1e-5      # the planes' terms summed in another order
STEP_RTOL = 1e-4      # a leaf's change over three Adam steps (module doc)
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU runs take one thread: with a thread per core in every
    parallel test worker, PyTorch's threads mostly wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def small_cfg(**kplanes):
    """The benchmark's configuration at the test's size, in fp32."""
    cfg = json.loads((ROOT / "nerfbench/configs/kplanes_hybrid_16_48.json").read_text())
    cfg["kplanes"].update(SMALL, **kplanes)
    cfg["train"].update(num_rays=64, precision="fp32", steps_per_call=3)
    cfg["occupancy"].update(resolution=8, warmup_steps=0)
    return cfg


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def weights(cfg, seed=7):
    return F.weights(seed, cfg, TRAFFIC, "cpu")


def field_of(cfg, kernels=True):
    return KPlanesField(KPlanesConfig.from_dict(cfg["kplanes"]), kernels)


def _points(n, s, seed):
    """Points over ``[-1.6, 1.6]^3`` (some outside the box, which read its
    border), the first ray's first points on the box's far faces and
    corners."""
    x = (torch.rand(n, s, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1) * 1.6
    x[0, 0] = torch.tensor([1.3, 1.3, 1.3])
    x[0, 1] = torch.tensor([-1.3, 0.3, 1.3])
    x[0, 2] = torch.tensor([0.2, 1.3, -1.3])
    return x


def test_published_sizes_and_counts():
    """nerf_hybrid.py's sizes: 3 x 32 x (64^2 + 128^2 + 256^2 + 512^2) =
    33,423,360 plane entries, 9,216 density and 6,272 color MLP weights;
    the MLPs' 15,488 multiply-adds a point forward and 29,952 backward; 524
    bytes a point that no sampling kernel avoids."""
    cfg = KPlanesConfig()
    shapes = param_shapes(cfg)
    assert cfg.resolutions == (64, 128, 256, 512)
    assert sum(math.prod(s) for s in shapes["planes"]) == 33_423_360
    assert sum(math.prod(s) for s in shapes["density"]) == 9_216
    assert sum(math.prod(s) for s in shapes["color"]) == 6_272
    bench = json.loads((ROOT / "nerfbench/configs/kplanes_hybrid_16_48.json").read_text())
    assert F.mlp_macs(bench) == (128 * 64 + 64 * 16 + 31 * 64 + 64 * 64 + 64 * 3,
                                 2 * 15_488 - 16 * 64) == (15_488, 29_952)
    assert F.points_per_ray(bench) == 80 and F.plane_bytes_per_point(bench) == 12 + 4 * 128
    assert KPlanesConfig.from_dict(bench["kplanes"]) == cfg
    assert F.shapes(bench["kplanes"]) == param_shapes(cfg)
    assert KPlanesConfig.from_dict(json.loads(json.dumps(cfg.to_dict()))) == cfg


@pytest.mark.parametrize("case", ["inside", "border"])
def test_plain_sampling_matches_grid_sample(case):
    """``sample_plain`` against ``grid_sample`` (bilinear, align_corners,
    border padding) on K-Planes' layout: points inside the box, and points
    outside it and on its faces, which read the border."""
    cfg = small_cfg()
    planes = weights(cfg)["planes"]
    x = _points(64, 5, 1).reshape(-1, 3)
    if case == "inside":
        x = x.clamp(-1.2, 1.2)
    with R.exact_float32():
        got = kp.sample_plain(x, planes, 1.3)
        want = RK.features(planes, x, cfg["kplanes"])
    assert got.shape == (320, 128) and rel(got, want) < FEATURE_RTOL
    if case == "border":
        far = torch.tensor([[5.0, -7.0, 9.0]])
        edge = torch.tensor([[1.3, -1.3, 1.3]])
        assert torch.equal(kp.sample_plain(far, planes, 1.3), kp.sample_plain(edge, planes, 1.3))


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_density_and_color(kernels):
    cfg = small_cfg()
    params = weights(cfg)
    field, ref = field_of(cfg, kernels), RK.kplanes_field(cfg)
    x, d = _points(64, 5, 1), torch.randn(64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), R.exact_float32():
        sigma, rgb = field.apply(params, x, d)
        r_sigma, r_rgb = ref.point(params, "fine", x, d, RK.Numerics())
        density = field.density(params, x.reshape(-1, 3))
        r_density = ref.density(params, x.reshape(-1, 3), RK.Numerics())
    assert rel(sigma[..., 0], r_sigma) < FEATURE_RTOL and rel(rgb, r_rgb) < FEATURE_RTOL
    assert rel(density, r_density) < FEATURE_RTOL
    assert torch.equal(density, sigma.reshape(-1))
    assert float(r_sigma.std()) > 0.01 and float(r_rgb.std()) > 0.02  # the weights vary


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_gradients_of_every_leaf(kernels):
    """Every leaf's gradient, with points outside the box (which send their
    gradient to the border's rows) and on its far faces and corners."""
    cfg = small_cfg()
    params = R.map_tree(lambda t: t.requires_grad_(True), weights(cfg))
    field, ref = field_of(cfg, kernels), RK.kplanes_field(cfg)
    x, d = _points(128, 4, 3), torch.randn(128, 3, generator=torch.Generator().manual_seed(4))
    probe = torch.randn(128, 4, 4, generator=torch.Generator().manual_seed(5))

    def grads(sigma, rgb):
        loss = torch.sum(torch.cat([sigma, rgb], dim=-1) * probe)
        return torch.autograd.grad(loss, R.leaves(params))

    with R.exact_float32():
        got = grads(*field.apply(params, x, d))
        r_sigma, r_rgb = ref.point(params, "fine", x, d, RK.Numerics())
        want = grads(r_sigma[..., None], r_rgb)
    assert len(got) == 3 + 2 + 4
    for g, w in zip(got, want):
        assert rel(g, w) < GRAD_RTOL
    assert bool((got[-1][0, -1, -1] != 0).any())  # the corner (1.3, 1.3, 1.3) on plane 0


def test_trunc_exp_clamps_its_gradient():
    """``exp(h)`` forward; the gradient ``g exp(min(h, 15))``: above 15 it
    stays ``g exp(15)``, as the reference's."""
    h = torch.tensor([-30.0, -2.0, 0.0, 14.5, 15.0, 20.0, 60.0], requires_grad=True)
    g = torch.tensor([1.0, 2.0, -1.0, 0.5, 1.0, 3.0, -2.0])
    out = trunc_exp(h)
    (grad,) = torch.autograd.grad(out, h, g)
    assert torch.equal(out.detach(), torch.exp(h.detach()))
    assert torch.equal(grad, g * torch.exp(torch.clamp(h.detach(), max=15.0)))
    assert float(grad[5]) == pytest.approx(3.0 * math.exp(15.0), rel=1e-6)
    (want,) = torch.autograd.grad(RK.trunc_exp(h), h, g)
    assert torch.equal(grad, want)


@pytest.mark.parametrize("shape", [(3, 4, 4, 32), (3, 8, 16, 5), (2, 2, 2, 1)])
def test_tv_gradient_matches_autograd(shape):
    """``loop.plane_tv_grad`` of channel-last planes against autograd of the
    authors' ``compute_plane_tv`` on K-Planes' ``[1, C, H, W]`` layout,
    summed over the planes."""
    p = torch.randn(*shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    q = p.clone().requires_grad_(True)
    tv = RK.plane_tv(q.unbind(0))
    (want,) = torch.autograd.grad(tv, q)
    got = loop.plane_tv_grad(p)
    assert rel(got, want) < 1e-12 and float(want.abs().max()) > 0
    assert rel(loop.plane_tv_grad(p, 1e-4), 1e-4 * want) < 1e-12


def test_adam_apply_tv():
    """The field's Adam on hand-made gradients: b2 0.999 and eps 1e-15;
    ``plane_tv_grad(p, tv_weight)`` added to every plane's gradient; a
    leaf with no TV term (the MLPs) takes optax's update bit for bit."""
    cfg = small_cfg(tv_weight=0.5)
    field = field_of(cfg)
    params = weights(cfg)
    before = R.map_tree(lambda t: t.clone(), params)
    grads = R.map_tree(lambda t: torch.randn(t.shape, generator=torch.Generator().manual_seed(
        t.numel())), params)
    state = loop.adam_init(params)
    scalars = loop.adam_scalars(torch.tensor(1e-2), 1, 0.9, 0.999)
    opts = field.adam_options(params)
    assert (opts["b1"], opts["b2"], opts["eps"]) == (0.9, 0.999, 1e-15)
    loop.adam_apply(params, grads, state, scalars, **opts)
    for s, plane in enumerate(before["planes"]):
        g = grads["planes"][s] + loop.plane_tv_grad(plane, 0.5)
        torch.testing.assert_close(state["mu"]["planes"][s], 0.1 * g)
        torch.testing.assert_close(state["nu"]["planes"][s], 0.001 * g * g)
    plain = R.map_tree(lambda t: t.clone(), before)
    plain_state = loop.adam_init(plain)
    loop.adam_apply(plain, grads, plain_state, scalars, 0.9, 0.999, 1e-15)
    assert all(torch.equal(a, b) for key in ("density", "color")
               for a, b in zip(plain[key], params[key]))
    assert not torch.equal(plain["planes"][0], params["planes"][0])


@pytest.mark.parametrize("name", ["nerf", "ngp", "tensorf"])
def test_other_fields_adam_apply_is_unchanged_without_tv(name):
    """Every other field's update, with its own options, bit for bit the
    same as with a ``tv`` of zeros on every leaf: no TV term, no change."""
    from minimal_nerf_torch.models.mlp import map_params

    small = {"ngp": {"log2_table": 8, "max_resolution": 64},
             "tensorf": {"resolution": 8}}.get(name, {})
    field = make_field(name, NeRFConfig(), "xla", "cpu", **({name: small} if small else {}))
    params = field.init(torch.Generator().manual_seed(3), device="cpu")
    grads = map_params(lambda t: torch.randn(t.shape, generator=torch.Generator().manual_seed(
        t.numel())), params)
    scalars = loop.adam_scalars(torch.tensor(1e-2), 4, field.adam["b1"], field.adam["b2"],
                                l1=1e-3 if name == "tensorf" else None)
    out = []
    for tv in (None, map_params(lambda _: 0.0, params)):
        p = map_params(lambda t: t.clone(), params)
        state = loop.adam_init(p)
        extra = {} if tv is None else {"tv": tv}
        loop.adam_apply(p, grads, state, scalars, **field.adam_options(p), **extra)
        out.append(flatten_tree(p) + flatten_tree(state["mu"]) + flatten_tree(state["nu"]))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def _scene(cfg, seed=5):
    images, poses, focal = gen.scene(seed, TRAFFIC, "cpu")
    grid = gen.grid(seed, cfg["occupancy"], TRAFFIC["grid"], "cpu")
    return images, poses, focal, grid


def _program_steps(cfg, params, make, kernels, seed, start, n):
    images, poses, focal, grid = _scene(cfg)
    nerf_cfg, train_cfg, kplanes_cfg = F.program_configs(cfg)
    field = KPlanesField(kplanes_cfg, kernels)
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
                         ids=["train_step-kernels", "multi_step-kernels", "multi_step-plain"])
def test_three_train_steps_match_the_reference(make, kernels):
    """Three steps from step 16 (a grid update first) through
    ``make_train_step`` or ``make_multi_step`` against the reference's
    ``train_steps`` on the same draws, with a TV weight large enough to move
    the planes: losses, each leaf's change, the moments, the grid."""
    cfg = small_cfg(tv_weight=0.05)
    params0 = weights(cfg)
    seed, start = 2 ** 31 + 17, 16
    params, state, grid, losses = _program_steps(cfg, params0, make, kernels, seed, start, 3)
    images, poses, focal, grid0 = _scene(cfg)
    no_tv = small_cfg(tv_weight=0.0)
    with R.exact_float32():
        ref = R.train_steps(params0, cfg, images, poses, focal, seed, start, 3,
                            RK.reference_numerics(cfg), grid0, 32, field=RK.kplanes_field(cfg))
        plain = R.train_steps(params0, no_tv, images, poses, focal, seed, start, 3,
                              RK.reference_numerics(cfg), grid0, 32,
                              field=RK.kplanes_field(no_tv))
    want = ref["losses"] if make == "single" else ref["losses"][-1:]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    got, p0 = flatten_tree(params), R.leaves(params0)
    for g, r, a in zip(got, ref["params"], p0):
        assert rel(g - a, r - a) < STEP_RTOL
    for g, r in zip(flatten_tree(state["mu"]), ref["mu"]):
        assert rel(g, r) < STEP_RTOL
    assert rel(grid, ref["grid"]) < FEATURE_RTOL and state["count"] == 3
    # the TV term moved the planes' moments well beyond the tolerance
    assert rel(ref["mu"][-1], plain["mu"][-1]) > 100 * STEP_RTOL


def test_grid_update_reads_the_field_density():
    cfg = small_cfg()
    params = weights(cfg)
    nerf_cfg, train_cfg, kplanes_cfg = F.program_configs(cfg)
    _, _, _, grid = _scene(cfg)
    got = grid.clone()
    loop.update_step_grid(train_cfg.occupancy_config, nerf_cfg, None, params, got, 32, 9,
                          field=KPlanesField(kplanes_cfg))
    with R.exact_float32():
        want = R.update_grid(grid, params, cfg, 32, 9, RK.reference_numerics(cfg),
                             RK.kplanes_field(cfg))
    assert rel(got, want) < FEATURE_RTOL and not torch.equal(got, grid)


def _checkpoint(tmp_path, cfg, params, grid):
    nerf_cfg, train_cfg, kplanes_cfg = F.program_configs(cfg)
    return save_checkpoint(tmp_path / "model=kplanes-epoch=3-step=300.ckpt", params, 300,
                           nerf_cfg.to_dict(), train_cfg.to_dict(),
                           extra=dict({"mode": "full"}, **KPlanesField(kplanes_cfg).header()),
                           grid=grid)


def test_checkpoint_round_trip(tmp_path):
    """The header names the field and its sizes (the planes' layout ``[3,
    N_s, N_s, C]`` a scale, from ``shapes()``); the leaves, the grid and the
    step come back as saved."""
    from minimal_nerf_torch.training.checkpoint import read_header
    from minimal_nerf_torch.training.trainer import load_state_for_inference

    cfg = small_cfg()
    params = weights(cfg)
    _, _, _, grid = _scene(cfg)
    path = _checkpoint(tmp_path, cfg, params, grid)
    header = read_header(path)
    assert header["num_leaves"] == 1 + 2 + 3 * 9
    assert header["extra"]["field"] == "kplanes"
    assert header["extra"]["kplanes"]["multiscale"] == [1, 2, 4, 8]
    field = checkpoint_field(header)
    assert isinstance(field, KPlanesField) and field.cfg == F.program_configs(cfg)[2]
    loaded, _, _, loaded_grid, step = load_state_for_inference(path, "cpu")
    assert step == 300 and torch.equal(loaded_grid, grid)
    assert all(torch.equal(a, b) for a, b in zip(flatten_tree(loaded), flatten_tree(params)))
    assert field.shapes()["planes"] == [(3, r, r, 32) for r in (4, 8, 16, 32)]


@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_render_chunk_of_a_kplanes_checkpoint(tmp_path, kernel):
    """One chunk of ``inference.build_render_chunk`` of a K-Planes
    checkpoint (through the grid it saved) against the reference's render
    on the same draws."""
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
    draws = R.draw_uniforms(cfg, cfg["kplanes"], 48, torch.Generator().manual_seed(11))
    with torch.no_grad(), R.exact_float32():
        want = R.render(RK.kplanes_field(cfg), params, cfg, o, d, draws, RK.Numerics(),
                        R.occupied(grid, cfg["occupancy"], False))[1]
    assert rel(got, want) < 1e-5


def test_train_cli_trains_renders_and_scores_the_field(fixture_scene, tmp_path):
    """``train full --fast --field kplanes`` at the published sizes (two
    calls of 3 steps), its checkpoint naming the field, rendered by the
    render CLI and scored by the score CLI."""
    from minimal_nerf_torch import render, score, train
    from minimal_nerf_torch.training.checkpoint import read_header

    args = ["--device", "cpu", "-n", "kplanes", "-s", "6", "-r", "32", "--precision", "fp32",
            "--log-every", "3", "--steps-per-call", "3", "-rd", str(tmp_path), "full", "-b",
            str(fixture_scene), "-c", "8", "-f", "8", "--fast", "--field", "kplanes",
            "--occ-resolution", "8", "--occ-warmup-steps", "2"]
    trainer = train.main(args)
    params = trainer.final_state[0]
    assert set(params) == {"planes", "density", "color"}
    assert [tuple(p.shape) for p in params["planes"]] == [(3, r, r, 32)
                                                          for r in (64, 128, 256, 512)]
    tc = trainer.train_config
    assert (tc.start_lr, tc.end_lr, tc.lr_decay_epochs) == (0.01, 0.001, 300)
    ckpt = sorted((tmp_path / "kplanes" / "checkpoints").glob("*.ckpt"))[-1]
    assert read_header(ckpt)["extra"]["field"] == "kplanes"
    gif = render.main(["-c", str(ckpt), "-r", "64", "-p", "1", "--height", "8", "--width", "8",
                       "--device", "cpu", "-s", str(tmp_path / "recons")])
    assert gif.is_file()
    scores = score.main(["-c", str(ckpt), "-r", "1024", "-b", str(fixture_scene), "--limit",
                         "1", "--device", "cpu"])
    assert all(np.isfinite(scores))
    assert len((tmp_path / "kplanes" / "metrics.csv").read_text().splitlines()) >= 3


def test_data_parallel_raises():
    """One device only: a mesh of two raises, as ``--data-parallel 2``
    does through the CLI's train step."""
    with pytest.raises(ValueError, match="one device"):
        loop.make_train_step(NeRFConfig(), TrainConfig(), loop.SceneStatic(8, 8, 5.0, 1),
                             device="cpu", field=KPlanesField(),
                             mesh=type("M", (), {"size": 2})())
    assert KPlanesField.data_parallel is False


def test_kernel_inputs_are_checked():
    """The kernels take 4 scales of 32 channels, fp32, contiguous, on one
    device, any resolution of at least 2, and CUDA tensors only
    (``kplane_sample`` too); the plain version takes any, and the field
    sends CPU tensors to it."""
    small = [torch.zeros(3, r, r, 32) for r in (2, 4, 8, 16)]
    kp.check_inputs(torch.zeros(4, 3), small)
    for bad in (small[:3], [torch.zeros(3, 4, 4, 16)] + small[1:],
                small[:2] + [torch.zeros(3, 8, 8, 32, dtype=torch.float64), small[3]],
                small[:3] + [torch.zeros(3, 16, 16, 32).transpose(1, 2)],
                [torch.zeros(3, 1, 1, 32)] + small[1:], small[:3] + [torch.zeros(3, 16, 8, 32)]):
        with pytest.raises(ValueError):
            kp.check_inputs(torch.zeros(4, 3), bad)
    with pytest.raises(ValueError):
        kp.check_inputs(torch.zeros(4, 2), small)
    with pytest.raises(ValueError, match="CUDA"):
        kp.forward(torch.zeros(4, 3), small, 1.3)
    with pytest.raises(ValueError, match="CUDA"):
        kp.backward(torch.zeros(4, 3), small, 1.3, torch.zeros(4, 128))
    with pytest.raises(ValueError, match="CUDA"):
        kp.kplane_sample(torch.zeros(4, 3), small, 1.3)
    cfg = small_cfg()
    feats = field_of(cfg, kernels=True).features(weights(cfg), torch.zeros(5, 3))
    assert feats.shape == (5, 128)


def test_backward_plain_matches_autograd_of_sample_plain():
    """``backward_plain``, the backward kernel's reference on the card,
    against autograd through ``sample_plain`` on the CPU, with points
    outside the box (their gradient goes to the border's rows) and on its
    far faces and corners."""
    cfg = small_cfg()
    planes = [t.requires_grad_(True) for t in weights(cfg)["planes"]]
    x = _points(96, 4, 6).reshape(-1, 3)
    g = torch.randn(x.shape[0], 128, generator=torch.Generator().manual_seed(8))
    with R.exact_float32():
        want = torch.autograd.grad(torch.sum(kp.sample_plain(x, planes, 1.3) * g), planes)
        got = kp.backward_plain(x, [t.detach() for t in planes], 1.3, g)
    for a, b, p in zip(got, want, planes):
        assert a.shape == p.shape and rel(a, b) < GRAD_RTOL


def test_tolerances_catch_bf16():
    """The planes or the MLPs one precision step lower (bf16) move the
    densities and colors beyond the tolerances above."""
    cfg = small_cfg()
    params = weights(cfg)
    field, ref = field_of(cfg), RK.kplanes_field(cfg)
    x, d = _points(64, 5, 1), torch.randn(64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), R.exact_float32():
        r_sigma, r_rgb = ref.point(params, "fine", x, d, RK.Numerics())
        low = dict(params, planes=[p.bfloat16().float() for p in params["planes"]])
        sigma, rgb = field.apply(low, x, d)
        assert rel(sigma[..., 0], r_sigma) > 100 * FEATURE_RTOL
        assert rel(rgb, r_rgb) > 100 * FEATURE_RTOL
        sigma, rgb = field.apply(params, x, d, compute_dtype=torch.bfloat16)
        assert rel(sigma[..., 0], r_sigma) > 100 * FEATURE_RTOL
        assert rel(rgb, r_rgb) > 100 * FEATURE_RTOL


def test_a_step_keeps_the_field_spans():
    """Inside the tracer, a K-Planes step keeps ``nerf.kplanes.sample`` and
    ``nerf.kplanes.mlp`` spans (both passes and the grid update) and one
    ``nerf.kplanes.tv`` span a scale (the Adam update)."""
    from minimal_nerf_torch.utils import profiling

    cfg = small_cfg()
    profiling.reset()
    with profiling.tracing():
        _program_steps(cfg, weights(cfg), "single", True, 3, 16, 1)
    names = [s.name for s in profiling.spans()]
    assert names.count("nerf.kplanes.sample") == 3 and names.count("nerf.kplanes.mlp") == 3
    assert names.count("nerf.kplanes.tv") == 4
