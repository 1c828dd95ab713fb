"""Instant-NGP's field in the port (``models/ngp.py``, the hash encoding and
SH of ``ops/encoding.py``, the kernels' CPU dispatch, the field's Adam in
``training/loop.py``) against the plain reference ``nerfbench/reference/
ngp.py`` on the CPU, at a small size that keeps dense and hashed levels (L
4, T 2^12, N 4 to 64: levels 4 and 10 dense, 25 and 64 hashed) and on
seeded random weights, in fp32.

Tolerances: the port and the reference compute the same operations in
fp32, in the same order where both index (the encoding's weights and corner
sums, the MLPs' matmuls), so the features, densities and colors agree to a
few ulps (1e-6 relative); the table's gradient sums its corner terms in
another order (``index_add_`` against autograd's scatter), 1e-5 relative.
A train step's Adam update is ``lr * m / sqrt(v)``, whose direction swings
for a table entry whose gradient is at the level of that round-off, so the
steps are held by each leaf's change over the steps, relative in L2 (1e-4),
and by the losses (1e-5). bf16 in place of fp32, in the table or in the MLP,
moves every one of these by 1e-3 or more (``test_tolerances_catch_bf16``).
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from minimal_nerf_torch.fields import checkpoint_field
from minimal_nerf_torch.kernels import hash_encode as he
from minimal_nerf_torch.models.nerf import NeRFConfig
from minimal_nerf_torch.models.ngp import NGPConfig, NGPField
from minimal_nerf_torch.ops import encoding as enc
from minimal_nerf_torch.training import loop
from minimal_nerf_torch.training.checkpoint import flatten_tree, save_checkpoint
from minimal_nerf_torch.training.config import TrainConfig
from nerfbench.fields import ngp as F
from nerfbench.reference import nerf as R
from nerfbench.reference import ngp as RN
from nerfbench.traffic import generate as gen

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"levels": 4, "features": 2, "log2_table": 12, "min_resolution": 4,
         "max_resolution": 64, "coarse_samples": 8, "fine_samples": 8, "table_scale": 2.0}
TRAFFIC = {"frames": 3, "height": 16, "width": 16, "camera_angle_x": 0.6911112070083618,
           "radius": 4.0, "phi_deg": -30.0,
           "weights": {"gain": math.sqrt(6.0), "density_bias": 0.5},
           "grid": {"spheres": 6, "center_extent": 1.0, "radius_range": [0.3, 0.8],
                    "density": 8.0}}
FEATURE_RTOL = 1e-6   # the same fp32 operations in the same order
GRAD_RTOL = 1e-5      # the table's corner terms summed in another order
STEP_RTOL = 1e-4      # a leaf's change over three Adam steps (module doc)
LOSS_RTOL = 1e-5


def small_cfg():
    """The benchmark's configuration at the test's size, in fp32."""
    cfg = json.loads((ROOT / "nerfbench/configs/ngp_hash_16_48.json").read_text())
    cfg["ngp"].update(SMALL)
    cfg["train"].update(num_rays=64, precision="fp32", steps_per_call=3)
    cfg["occupancy"].update(resolution=8, warmup_steps=0)
    return cfg


def port_field(cfg, kernels=True):
    return NGPField(NGPConfig.from_dict(dict(cfg["ngp"], bound=cfg["occupancy"]["bound"])),
                    kernels)


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def weights(cfg, seed=7):
    return F.weights(seed, cfg, TRAFFIC, "cpu")


def test_published_levels_and_sizes():
    """L 16, N 16 .. 2048 (b = 1.38191), levels 0-4 dense with 331,757
    entries, 11 hashed levels of 2^19: 6,098,925 entries, 12,197,850 table
    parameters; the MLPs' 9,408 multiply-adds a point."""
    cfg = NGPConfig()
    levels = cfg.grid
    assert [lv.resolution for lv in levels] == [16, 22, 30, 42, 58, 80, 111, 153, 212, 294,
                                                406, 561, 776, 1072, 1482, 2048]
    assert [lv.dense for lv in levels] == [True] * 5 + [False] * 11
    assert sum(lv.size for lv in levels if lv.dense) == 331_757
    assert cfg.entries == 6_098_925 and cfg.entries * cfg.features == 12_197_850
    assert [tuple(lv) for lv in levels] == [tuple(lv) for lv in map(
        lambda t: enc.GridLevel(*t), RN.levels(dict(NGPConfig().to_dict())))]
    bench = json.loads((ROOT / "nerfbench/configs/ngp_hash_16_48.json").read_text())
    assert F.mlp_macs(bench) == (9_408, 17_792)
    assert F.points_per_ray(bench) == 80 and F.encode_bytes_per_point(bench) == 140


def test_indices_by_hand():
    """Hand-picked points: the cell, the place in it and the entries of its
    corners on a dense and a hashed level, against arithmetic done here."""
    levels = NGPConfig.from_dict(SMALL).grid
    dense, hashed = levels[0], levels[2]
    assert (dense.resolution, dense.size, dense.dense) == (4, 125, True)
    assert (hashed.resolution, hashed.size, hashed.dense) == (25, 4096, False)
    x = torch.tensor([[0.5, 0.25, 1.0], [0.1, 0.7, 0.33]])
    cell, frac = enc.grid_cell(x, dense)
    # 0.5 * 4 = 2, 0.25 * 4 = 1, 1.0 * 4 = 4 -> the last cell, 3, at its far side
    assert cell[0].tolist() == [2, 1, 3] and frac[0].tolist() == [0.0, 0.0, 1.0]
    far = cell + torch.tensor([1, 1, 1])
    assert enc.grid_index(cell, dense)[0] == 2 + 5 * (1 + 5 * 3)
    assert enc.grid_index(far, dense)[0] == 3 + 5 * (2 + 5 * 4)
    cell, _ = enc.grid_cell(x, hashed)
    # 0.1 * 25 = 2.5, 0.7 * 25 = 17.5, 0.33 * 25 = 8.25
    assert cell[1].tolist() == [2, 17, 8]
    want = (2 * 1 ^ 17 * 2654435761 ^ 8 * 805459861) % 2 ** 32 % 4096
    assert enc.grid_index(cell, hashed)[1] == want
    assert RN.vertex_index(cell, 25, 4096, False)[1] == want
    assert RN.vertex_index(far, 4, 125, True)[0] == enc.grid_index(far, dense)[0]
    rows, w = enc.grid_corners(x, levels)
    assert rows.shape == (2, 4, 8) and int(rows[1, 2, 0]) == hashed.offset + want
    torch.testing.assert_close(w.sum(-1), torch.ones(2, 4))


def test_spherical_harmonics_are_orthonormal_and_the_references():
    d = torch.randn(400_000, 3, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    y = enc.sh_encode(d)
    gram = 4 * math.pi * (y.T @ y) / d.shape[0]
    assert float((gram - torch.eye(16, dtype=torch.float64)).abs().max()) < 0.02
    assert rel(y, RN.spherical_harmonics(d)) < 1e-14  # float64, another product order


@pytest.mark.parametrize("kernels", [True, False], ids=["function", "plain"])
def test_features_density_and_rgb(kernels):
    cfg = small_cfg()
    params = weights(cfg)
    field, ref = port_field(cfg, kernels), RN.ngp_field(cfg)
    x = (torch.rand(64, 5, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1) * 3.0
    d = torch.randn(64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        feats = field.features(params, x.reshape(-1, 3))
        sigma, rgb = field.apply(params, x, d)
        r_sigma, r_rgb = ref.point(params, "fine", x, d, RN.Numerics())
        r_feats = RN._features(params, x.reshape(-1, 3), cfg, RN.Numerics())
        r_density = ref.density(params, x.reshape(-1, 3), RN.Numerics())
    assert rel(feats, r_feats) < FEATURE_RTOL
    assert rel(sigma[..., 0], r_sigma) < FEATURE_RTOL and rel(rgb, r_rgb) < FEATURE_RTOL
    assert rel(field.density(params, x.reshape(-1, 3)), r_density) < FEATURE_RTOL
    assert float(r_sigma.std()) > 0.1 and float(r_rgb.std()) > 0.02  # the weights vary


@pytest.mark.parametrize("kernels", [True, False], ids=["function", "plain"])
def test_gradients_of_table_and_mlps(kernels):
    cfg = small_cfg()
    params = R.map_tree(lambda t: t.requires_grad_(True), weights(cfg))
    field, ref = port_field(cfg, kernels), RN.ngp_field(cfg)
    x = (torch.rand(128, 4, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1) * 3.0
    d = torch.randn(128, 3, generator=torch.Generator().manual_seed(4))
    probe = torch.randn(128, 4, 4, generator=torch.Generator().manual_seed(5))

    def grads(sigma, rgb):
        loss = torch.sum(torch.cat([sigma, rgb], dim=-1) * probe)
        return torch.autograd.grad(loss, R.leaves(params))

    sigma, rgb = field.apply(params, x, d)
    got = grads(sigma, rgb)
    r_sigma, r_rgb = ref.point(params, "fine", x, d, RN.Numerics())
    want = grads(r_sigma[..., None], r_rgb)
    assert len(got) == 6 and got[-1].shape == (NGPConfig.from_dict(SMALL).entries, 2)
    for g, w in zip(got, want):
        assert rel(g, w) < GRAD_RTOL
    assert torch.equal(got[-1] != 0, want[-1] != 0)  # the same entries touched


def test_tolerances_catch_bf16():
    """The table or the MLPs one precision step lower (bf16) moves the
    features, colors and gradients beyond the tolerances above."""
    cfg = small_cfg()
    params = weights(cfg)
    field, ref = port_field(cfg), RN.ngp_field(cfg)
    x = (torch.rand(64, 5, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1) * 3.0
    d = torch.randn(64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        r_sigma, r_rgb = ref.point(params, "fine", x, d, RN.Numerics())
        low_table = dict(params, table=params["table"].bfloat16().float())
        sigma, rgb = field.apply(low_table, x, d)
        assert rel(sigma[..., 0], r_sigma) > 100 * FEATURE_RTOL
        sigma, rgb = field.apply(params, x, d, compute_dtype=torch.bfloat16)
        assert rel(sigma[..., 0], r_sigma) > 100 * FEATURE_RTOL
        assert rel(rgb, r_rgb) > 100 * FEATURE_RTOL


def test_adam_apply_sparse_rows_and_l2():
    """The field's Adam on hand-made gradients: a table row with a zero
    gradient keeps its value and moments; the MLP weights' moments take
    ``g + 1e-6 w``; b2 0.99 and eps 1e-15."""
    cfg = small_cfg()
    field = port_field(cfg)
    params = weights(cfg)
    before = R.map_tree(lambda t: t.clone(), params)
    state = loop.adam_init(params)
    state["mu"]["table"].fill_(0.5)
    state["nu"]["table"].fill_(0.25)
    grads = R.map_tree(lambda t: torch.randn_like(t), params)
    grads["table"][::2] = 0.0
    scalars = loop.adam_scalars(torch.tensor(1e-2), 1, 0.9, 0.99)
    loop.adam_apply(params, grads, state, scalars, **field.adam_options(params))
    t = params["table"]
    assert torch.equal(t[::2], before["table"][::2])
    assert torch.all(state["mu"]["table"][::2] == 0.5)
    assert torch.all(state["nu"]["table"][::2] == 0.25)
    assert not torch.equal(t[1::2], before["table"][1::2])
    g_table = grads["table"][1::2]
    torch.testing.assert_close(state["mu"]["table"][1::2], 0.1 * g_table + 0.9 * 0.5)
    torch.testing.assert_close(state["nu"]["table"][1::2], 0.01 * g_table ** 2 + 0.99 * 0.25)
    w, g = before["density"][0], grads["density"][0]
    torch.testing.assert_close(state["mu"]["density"][0], 0.1 * (g + 1e-6 * w))
    m_hat, v_hat = state["mu"]["color"][1] / 0.1, state["nu"]["color"][1] / 0.01
    torch.testing.assert_close(params["color"][1],
                               before["color"][1] - 1e-2 * m_hat / (v_hat.sqrt() + 1e-15))
    assert abs(float(loop.adam_scalars(0.01, 3, 0.9, 0.99)[2]) - (1 - 0.99 ** 3)) < 1e-7


def _scene(cfg, seed=5):
    images, poses, focal = gen.scene(seed, TRAFFIC, "cpu")
    grid = gen.grid(seed, cfg["occupancy"], TRAFFIC["grid"], "cpu")
    return images, poses, focal, grid


def _program_steps(cfg, params, make, kernels, seed, start, n):
    images, poses, focal, grid = _scene(cfg)
    nerf_cfg, train_cfg, ngp_cfg = F.program_configs(cfg)
    field = NGPField(ngp_cfg, kernels)
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
    ``train_steps`` on the same draws: losses, each leaf's change, the
    moments, the grid; a table row no step touched keeps its value and zero
    moments, and rows touched in the first step but not in the last keep
    the moments they had."""
    cfg = small_cfg()
    params0 = weights(cfg)
    seed, start = 2 ** 31 + 17, 16
    params, state, grid, losses = _program_steps(cfg, params0, make, kernels, seed, start, 3)
    images, poses, focal, grid0 = _scene(cfg)
    with R.exact_float32():
        ref = R.train_steps(params0, cfg, images, poses, focal, seed, start, 3,
                            RN.reference_numerics(cfg), grid0, 32, field=RN.ngp_field(cfg))
    want = ref["losses"] if make == "single" else ref["losses"][-1:]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    got, p0 = flatten_tree(params), R.leaves(params0)
    for g, r, a in zip(got, ref["params"], p0):
        assert rel(g - a, r - a) < STEP_RTOL
    for g, r in zip(flatten_tree(state["mu"]), ref["mu"]):
        assert rel(g, r) < STEP_RTOL
    assert rel(grid, ref["grid"]) < FEATURE_RTOL and state["count"] == 3
    untouched = state["nu"]["table"] == 0
    assert 0 < int(untouched.sum()) < untouched.numel()
    assert torch.equal(params["table"][untouched], params0["table"][untouched])
    assert torch.all(ref["nu"][-1][untouched] == 0)


def test_zero_gradient_rows_keep_their_moments_between_steps():
    cfg = small_cfg()
    params0 = weights(cfg)
    p1, s1, _, _ = _program_steps(cfg, params0, "single", True, 3, 16, 1)
    p2, s2, _, _ = _program_steps(cfg, params0, "single", True, 3, 16, 2)
    kept = (s1["nu"]["table"] != 0) & (s2["nu"]["table"] == s1["nu"]["table"])
    kept &= s2["mu"]["table"] == s1["mu"]["table"]
    assert int(kept.sum()) > 0  # rows touched by step 16 and not by step 17
    assert torch.equal(p2["table"][kept], p1["table"][kept])
    decayed = (s1["nu"]["table"] != 0) & ~kept
    assert int(decayed.sum()) > 0


def test_grid_update_reads_the_field_density():
    cfg = small_cfg()
    params = weights(cfg)
    nerf_cfg, train_cfg, ngp_cfg = F.program_configs(cfg)
    _, _, _, grid = _scene(cfg)
    got = grid.clone()
    loop.update_step_grid(train_cfg.occupancy_config, nerf_cfg, None, params, got, 32, 9,
                          field=NGPField(ngp_cfg))
    with R.exact_float32():
        want = R.update_grid(grid, params, cfg, 32, 9, RN.reference_numerics(cfg),
                             RN.ngp_field(cfg))
    assert rel(got, want) < FEATURE_RTOL and not torch.equal(got, grid)


def _checkpoint(tmp_path, cfg, params, grid):
    nerf_cfg, train_cfg, ngp_cfg = F.program_configs(cfg)
    return save_checkpoint(tmp_path / "model=ngp-epoch=3-step=300.ckpt", params, 300,
                           nerf_cfg.to_dict(), train_cfg.to_dict(),
                           extra=dict({"mode": "full"}, **NGPField(ngp_cfg).header()),
                           grid=grid)


def test_checkpoint_round_trip(tmp_path):
    from minimal_nerf_torch.training.checkpoint import read_header
    from minimal_nerf_torch.training.trainer import load_state_for_inference

    cfg = small_cfg()
    params = weights(cfg)
    _, _, _, grid = _scene(cfg)
    path = _checkpoint(tmp_path, cfg, params, grid)
    header = read_header(path)
    assert header["num_leaves"] == 1 + 2 + 3 * 6
    field = checkpoint_field(header)
    assert field.cfg == F.program_configs(cfg)[2]
    loaded, nerf_cfg, train_cfg, loaded_grid, step = load_state_for_inference(path, "cpu")
    assert step == 300 and torch.equal(loaded_grid, grid)
    assert all(torch.equal(a, b) for a, b in zip(flatten_tree(loaded), flatten_tree(params)))
    assert checkpoint_field({"extra": {"mode": "full"}}).name == "nerf"


@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_render_chunk_of_an_ngp_checkpoint(tmp_path, kernel):
    """One chunk of ``inference.build_render_chunk`` of an NGP checkpoint
    (through the grid it saved) against the reference's render on the same
    draws."""
    from minimal_nerf_torch import inference

    cfg = small_cfg()
    params = weights(cfg)
    _, poses, focal, grid = _scene(cfg)
    path = _checkpoint(tmp_path, cfg, params, grid)
    chunk, nerf_cfg, _ = inference.build_render_chunk(str(path), rays=48, kernel=kernel,
                                                      device="cpu")
    flat = torch.arange(48)
    o, d = R.pixel_rays((flat % 16).float(), (flat // 16).float(), 16, 16, focal, poses[0])
    o = o.contiguous()
    got = chunk(o, d, torch.Generator().manual_seed(11))
    draws = R.draw_uniforms(cfg, cfg["ngp"], 48, torch.Generator().manual_seed(11))
    with torch.no_grad(), R.exact_float32():
        want = R.render(RN.ngp_field(cfg), params, cfg, o, d, draws, RN.Numerics(),
                        R.occupied(grid, cfg["occupancy"], False))[1]
    assert rel(got, want) < 1e-5


def test_train_cli_trains_and_renders_the_field(fixture_scene, tmp_path):
    """``train full --fast --field ngp`` at the published sizes (two calls
    of 3 steps), its checkpoint naming the field, rendered by the render
    CLI; data parallel raises."""
    from minimal_nerf_torch import render, train

    args = ["--device", "cpu", "-n", "ngp", "-s", "6", "-r", "32", "--precision", "fp32",
            "--log-every", "3", "--steps-per-call", "3", "-rd", str(tmp_path), "full", "-b",
            str(fixture_scene), "-c", "8", "-f", "8", "--fast", "--field", "ngp",
            "--occ-resolution", "8", "--occ-warmup-steps", "2"]
    trainer = train.main(args)
    params = trainer.final_state[0]
    assert set(params) == {"table", "density", "color"}
    assert tuple(params["table"].shape) == (6_098_925, 2)
    assert trainer.train_config.start_lr == 1e-2
    ckpt = sorted((tmp_path / "ngp" / "checkpoints").glob("*.ckpt"))[-1]
    from minimal_nerf_torch.training.checkpoint import read_header

    assert read_header(ckpt)["extra"]["field"] == "ngp"
    gif = render.main(["-c", str(ckpt), "-r", "64", "-p", "1", "--height", "8", "--width", "8",
                       "--device", "cpu", "-s", str(tmp_path / "recons")])
    assert gif.is_file()
    rows = (tmp_path / "ngp" / "metrics.csv").read_text().splitlines()
    assert len(rows) >= 3
    with pytest.raises(ValueError, match="one device"):
        loop.make_train_step(NeRFConfig(), TrainConfig(), loop.SceneStatic(8, 8, 5.0, 1),
                             device="cpu", field=NGPField(NGPConfig()),
                             mesh=type("M", (), {"size": 2})())


def test_other_trees_keep_their_render():
    """``render_rays`` keeps its parameters and still queries
    ``params["coarse"]`` and ``["fine"]``: the field's hook hands it one tree
    under both names. The kernels refuse what they do not take (F other than
    2 among it)."""
    import inspect

    from minimal_nerf_torch.models import nerf

    assert list(inspect.signature(nerf.render_rays).parameters) == [
        "params", "config", "o_rays", "d_rays", "generator", "compute_dtype", "mlp_apply",
        "coarse_sampler", "uniforms", "return_stats"]
    seen = []
    real = nerf.render_rays
    nerf.render_rays = lambda params, *a, **k: seen.append(params)
    try:
        tree = {"table": torch.zeros(1)}
        NGPField(NGPConfig.from_dict(SMALL), kernels=False).hooks()[1](tree, None, None, None)
    finally:
        nerf.render_rays = real
    assert seen[0]["coarse"] is tree and seen[0]["fine"] is tree
    levels = NGPConfig.from_dict(SMALL).grid
    with pytest.raises(ValueError):
        he.check_inputs(torch.zeros(4, 3), torch.zeros(10, 2), levels)
    with pytest.raises(ValueError):
        he.check_inputs(torch.zeros(4, 3), torch.zeros(NGPConfig.from_dict(SMALL).entries, 4),
                        levels)
    with pytest.raises(ValueError):
        he.check_inputs(torch.zeros(4, 3, dtype=torch.float64),
                        torch.zeros(NGPConfig.from_dict(SMALL).entries, 2), levels)
    with pytest.raises(ValueError, match="CUDA"):
        he.forward(torch.zeros(4, 3), torch.zeros(NGPConfig.from_dict(SMALL).entries, 2),
                   levels)
    assert dataclasses.asdict(NGPConfig()) == NGPConfig.from_dict(NGPConfig().to_dict()).to_dict()


def test_merged_share_reads_the_counters():
    """``he.merged_share`` turns the counted backward's counters into the
    share of row updates merged away, per level and overall (levels with no
    updates left out); the backward wrappers take CUDA tensors only."""
    from minimal_nerf_torch.utils import profiling

    profiling.reset()
    try:
        assert he.merged_share(16) == {}
        profiling.count(f"{he.REDS}.l0", 8)
        profiling.count(f"{he.ROW_UPDATES}.l0", 256)
        profiling.count(f"{he.REDS}.l2", 256)
        profiling.count(f"{he.ROW_UPDATES}.l2", 256)
        assert he.merged_share(16) == {"l0": 31 / 32, "l2": 0.0, "all": 1 - 264 / 512}
    finally:
        profiling.reset()
    levels = NGPConfig.from_dict(SMALL).grid
    entries = NGPConfig.from_dict(SMALL).entries
    x, grad = torch.zeros(4, 3), torch.zeros(4, 2 * len(levels))
    for fn in (he.backward, he.backward_counted):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, grad, (entries, 2), levels)


def test_a_step_keeps_the_field_spans():
    """Inside the tracer, an NGP step keeps ``nerf.ngp.encode`` (both passes
    and the grid update), ``nerf.ngp.mlp`` and ``nerf.ngp.table_adam`` spans
    under the step's ``nerf.train.body``."""
    from minimal_nerf_torch.utils import profiling

    cfg = small_cfg()
    profiling.reset()
    with profiling.tracing():
        _program_steps(cfg, weights(cfg), "single", True, 3, 16, 1)
    names = [s.name for s in profiling.spans()]
    assert names.count("nerf.ngp.encode") == 3 and names.count("nerf.ngp.mlp") == 3
    assert names.count("nerf.ngp.table_adam") == 1
    body = next(s for s in profiling.spans() if s.name == "nerf.train.body")
    adam = next(s for s in profiling.spans() if s.name == "nerf.ngp.table_adam")
    assert body.start_ns <= adam.start_ns <= adam.end_ns <= body.end_ns
    profiling.reset()
