"""Instant-NGP's hash encoding kernels and the field's replayed train step
and graph-swept views, on a card, at the published sizes (L 16, F 2, T
2^19, N 16 to 2048).

Marked ``cuda``: they skip without a card. This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ngp_cuda.py

Tolerances: the forward kernel does the plain version's operations in its
order with no FMA (``csrc/hash_encode_common.cuh``), so the features agree
to fp32 rounding (1e-6 relative per element, against the largest feature);
the backward adds its terms with atomics in an order that changes from run
to run, as does ``index_add_`` on the card, and sums the terms of a run of
neighbouring points in one cell in registers first, so each table entry's
gradient is held within 1e-5 of the sum of its terms' magnitudes (fp32
summation error of up to 8 L terms a point, a few hundred terms an entry;
with a sum already in the buffer, it counts as one more term). The
counted backward's float2 adds per level equal 8 times the runs of equal
cells among each 32 consecutive points, counted here from the plain
version's cells. A
replayed step and an eager one differ only by that order, which Adam
amplifies: ``m / sqrt(v)`` turns a gradient's sign into a whole step of the
learning rate, so an entry whose gradient the order flips moves the other
way, and the steps after it differ a little everywhere. After 20 steps an
H100 read the losses 2.2e-5 apart and the leaves' changes 0.14-5.3% apart
in L2 (the table's the most) with equal norms: the test holds the losses to
1e-4, each leaf's change and first moment by the norm (1e-2) and the
direction (cosine 0.99), the grid to 1e-3 in L2.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from minimal_nerf_torch.kernels import hash_encode as he
from minimal_nerf_torch.models.ngp import NGPConfig, NGPField
from minimal_nerf_torch.ops import encoding as enc
from minimal_nerf_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
POINTS = 1 << 18


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    profiling.reset()
    return torch.device("cuda")


def _points(dev, n=POINTS, seed=0):
    x = torch.rand(n, 3, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    x[:8] = torch.tensor([0.0, 1.0], device=dev)[torch.tensor(
        [[(c >> a) & 1 for a in range(3)] for c in range(8)], device=dev)]  # the box's corners
    return x


@pytest.mark.cuda
def test_kernels_match_the_plain_encoding(cuda_device):
    levels = NGPConfig().grid
    entries = he.entries(levels)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    table = (torch.rand(entries, 2, generator=g, device=cuda_device) * 4 - 2).contiguous()
    x = _points(cuda_device)
    got = he.forward(x, table, levels)
    want = enc.hash_encode_plain(x, table, levels)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), err
    grad = torch.randn(POINTS, 32, generator=g, device=cuda_device)
    got_t = he.backward(x, grad, (entries, 2), levels)
    want_t = enc.hash_encode_backward_plain(x, grad, entries, levels)
    scale = enc.hash_encode_backward_plain(x, grad.abs(), entries, levels)
    excess = float(((got_t - want_t).abs() - 1e-5 * scale).max())
    print(f"[ngp-kernels] forward max |k - p| {err:.3e}; backward max |k - p| "
          f"{float((got_t - want_t).abs().max()):.3e}, touched {int((want_t != 0).sum())}")
    assert excess <= 0.0
    assert torch.equal(got_t != 0, want_t != 0)
    again = he.backward(x, grad, (entries, 2), levels)
    assert float(((again - got_t).abs() - 1e-5 * scale).max()) <= 0.0
    assert profiling.counter(he.LAUNCHES_FWD) == 1 and profiling.counter(he.LAUNCHES_BWD) == 2


def _ray_points(dev, rays, gen):
    """Points as the fine pass lays them out: per ray 16 even samples and 48
    drawn around one depth, sorted along the ray (64 a ray), in the box."""
    o = torch.rand(rays, 1, 3, generator=gen, device=dev) * 0.6 + 0.2
    d = torch.nn.functional.normalize(torch.randn(rays, 1, 3, generator=gen, device=dev), dim=-1)
    even = torch.linspace(0.0, 0.6, 16, device=dev).expand(rays, 16)
    near = torch.rand(rays, 1, generator=gen, device=dev) * 0.5
    drawn = near + 0.05 * torch.rand(rays, 48, generator=gen, device=dev)
    t = torch.sort(torch.cat([even, drawn], dim=1), dim=1).values
    return (o + t[..., None] * d).clamp(0.0, 1.0).reshape(-1, 3).contiguous()


def _one_cell(dev, n, levels, gen):
    """``n`` points in one cell on every level: a base whose place in its
    cell lies in [0.01, 0.99] on each axis of each level, jittered by far less
    than the finest cell."""
    for k in range(1000):
        base = torch.tensor([0.31 + 1.23e-3 * k, 0.47 + 0.77e-3 * k, 0.59 + 0.41e-3 * k])
        if all(bool(((f > 0.01) & (f < 0.99)).all())
               for f in (enc.grid_cell(base[None], lv)[1] for lv in levels)):
            break
    else:
        raise AssertionError("no base point lies inside a cell on every level")
    jitter = (torch.rand(n, 3, generator=gen, device=dev) - 0.5) * 2e-6
    return (base.to(dev) + jitter).contiguous()


def _backward_case(case, dev, levels, gen):
    """``(points, table's gradient on entry or None)`` of a named case."""
    if case == "rays":
        return _ray_points(dev, 4096, gen), None
    if case == "rays_ragged":  # P a multiple of neither the warp, the tile nor the block
        return _ray_points(dev, 2049, gen)[:-19].contiguous(), None
    if case == "one_cell":
        return _one_cell(dev, 65536, levels, gen), None
    if case == "random":
        return _points(dev), None
    if case == "few":
        return _points(dev, 45), None
    if case == "sum_on_entry":
        out = torch.randn(he.entries(levels), 2, generator=gen, device=dev)
        return _ray_points(dev, 1024, gen), out
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rays", "rays_ragged", "one_cell", "random", "few",
                                  "sum_on_entry"])
def test_backward_matches_the_plain_version(cuda_device, case):
    """The backward against ``hash_encode_backward_plain`` at ``ngp_hash_16_48``'s
    levels (L 16, T 2^19, dense and hashed): points along rays as the fine
    pass lays them out (all P, and a ragged P), all in one cell (every lane
    merges), uniform at random (nothing merges), fewer than a warp, and a
    buffer holding a sum on entry; each entry within 1e-5 of the sum of its
    terms' magnitudes, the same entries touched."""
    levels = NGPConfig().grid
    entries = he.entries(levels)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x, before = _backward_case(case, cuda_device, levels, gen)
    grad = torch.randn(x.shape[0], 2 * len(levels), generator=gen, device=cuda_device)
    want = enc.hash_encode_backward_plain(x, grad, entries, levels)
    scale = enc.hash_encode_backward_plain(x, grad.abs(), entries, levels)
    out = None
    if before is not None:
        out = before.clone()
        want, scale = want + before, scale + before.abs()
    got = he.backward(x, grad, (entries, 2), levels, out=out)
    assert out is None or got is out
    excess = float(((got - want).abs() - 1e-5 * scale).max())
    print(f"[ngp-bwd] {case} P={x.shape[0]}: max |k - p| {float((got - want).abs().max()):.3e}, "
          f"touched {int((want != 0).sum())}")
    assert excess <= 0.0
    assert torch.equal(got != 0, want != 0)
    assert profiling.counter(he.LAUNCHES_BWD) == 1


def _runs(x, level):
    """Runs of equal cells among each 32 consecutive points of ``x`` on one
    level: the counted kernel's float2 adds on it, over 8."""
    cell = enc.grid_cell(x, level)[0]
    same = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    same[1:] = (cell[1:] == cell[:-1]).all(dim=1)
    same[::32] = False
    return int((~same).sum())


@pytest.mark.cuda
def test_merged_share_counter(cuda_device):
    """``hash_encode_bwd.merged_share`` from the counted backward: one point
    repeated 32 times merges 31/32 of its updates on every level; uniform
    random points merge about none on the finest level; the fine pass's
    layout merges most on the coarse levels. On each the adds issued equal
    8 times the runs of equal cells among each 32 points, and the counted
    launch's gradient equals the uncounted one's within the tolerance."""
    levels = NGPConfig().grid
    entries = he.entries(levels)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    cases = {"repeated": torch.tensor([[0.3137, 0.5821, 0.7043]],
                                      device=cuda_device).expand(32, 3).contiguous(),
             "random": _points(cuda_device, POINTS, seed=3),
             "rays": _ray_points(cuda_device, 4096, gen)}
    shares = {}
    for name, x in cases.items():
        grad = torch.randn(x.shape[0], 2 * len(levels), generator=gen, device=cuda_device)
        profiling.reset()
        got, issued = he.backward_counted(x, grad, (entries, 2), levels)
        assert issued == [8 * _runs(x, lv) for lv in levels], name
        assert profiling.counter(f"{he.REDS}.l0") == issued[0]
        assert profiling.counter(f"{he.ROW_UPDATES}.l0") == 8 * x.shape[0]
        shares[name] = he.merged_share(len(levels))
        plain = he.backward(x, grad, (entries, 2), levels)
        scale = enc.hash_encode_backward_plain(x, grad.abs(), entries, levels)
        assert float(((got - plain).abs() - 1e-5 * scale).max()) <= 0.0, name
        assert torch.equal(got != 0, plain != 0), name
    print(f"[ngp-merged] {shares}")
    assert all(shares["repeated"][f"l{lv}"] >= 31 / 32 for lv in range(len(levels)))
    assert shares["random"][f"l{len(levels) - 1}"] <= 1e-3
    assert shares["rays"]["l0"] > shares["rays"][f"l{len(levels) - 1}"]


def _setup(dev, num_rays=4096, frames=8, size=200):
    from nerfbench.fields import ngp as F
    from nerfbench.traffic import generate as gen

    cfg = json.loads((ROOT / "nerfbench/configs/ngp_hash_16_48.json").read_text())
    cfg["train"]["num_rays"] = num_rays
    traffic = json.loads((ROOT / "nerfbench/traffic/train_steps.json").read_text())
    traffic.update(frames=frames, height=size, width=size)
    images, poses, focal = gen.scene(5, traffic, dev)
    grid = gen.grid(5, cfg["occupancy"], traffic["grid"], dev)
    return cfg, traffic, images, poses, focal, grid, F.weights(5, cfg, traffic, dev)


def _norm_gap(a, b):
    return abs(float(torch.linalg.norm(a.double())) / float(torch.linalg.norm(b.double())) - 1)


def _cos(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b)))


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.cuda
def test_replayed_ngp_steps_match_eager_steps(cuda_device):
    """A call of 20 steps of ``make_multi_step`` (one eager step, the
    capture, 19 replays; a grid update at step 1,008) against 20 eager
    steps of ``make_train_step``: the last loss, each leaf's change, the
    moments and the grid within the atomics' tolerance (module doc); the
    launch counters count the capture's launches again for each replay."""
    from nerfbench.fields import ngp as F
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    cfg, tr, images, poses, focal, grid0, params0 = _setup(cuda_device)
    nerf_cfg, train_cfg, ngp_cfg = F.program_configs(cfg)
    static = loop.SceneStatic(tr["height"], tr["width"], focal, tr["frames"])
    field, occ_cfg = NGPField(ngp_cfg), train_cfg.occupancy_config
    clone = lambda: ({k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])  # noqa: E731
                      for k, v in params0.items()}, grid0.clone())
    params, grid = clone()
    state = loop.adam_init(params)
    step_fn = loop.make_train_step(nerf_cfg, train_cfg, static, None, cuda_device, None,
                                   occ_cfg, field=field)
    for s in range(1000, 1020):
        params, state, grid, eager = step_fn(params, state, grid, images, poses, s, 7)
    e_params, e_state, e_grid = params, state, grid
    params, grid = clone()
    state = loop.adam_init(params)
    multi = loop.make_multi_step(nerf_cfg, train_cfg, static, 20, None, cuda_device, None,
                                 occ_cfg, field=field)
    profiling.reset()
    params, state, grid, replayed = multi(params, state, grid, images, poses, 1000, 7)
    counts = profiling.counters()
    assert counts["graph.replays"] == 19
    # the eager first step, the capture and 19 replays: 21 steps' launches,
    # and the grid update's encoding at step 1,008
    assert counts[he.LAUNCHES_FWD] == 2 * 21 + 1 and counts[he.LAUNCHES_BWD] == 2 * 21
    loss_gap = abs(float(replayed["train_loss"]) - float(eager["train_loss"]))
    changes = [(a - p0, b - p0) for a, b, p0 in zip(flatten_tree(params), flatten_tree(e_params),
                                                    flatten_tree(params0))]
    moments = list(zip(flatten_tree(state["mu"]), flatten_tree(e_state["mu"])))
    print(f"[ngp-multi-step] loss {float(eager['train_loss'])!r} / {float(replayed['train_loss'])!r}"
          f"; per leaf, change: L2 gap {[_rel(a, b) for a, b in changes]}, norm gap "
          f"{[_norm_gap(a, b) for a, b in changes]}, 1 - cos {[1 - _cos(a, b) for a, b in changes]}"
          f"; first moment: 1 - cos {[1 - _cos(a, b) for a, b in moments]}; grid {_rel(grid, e_grid)}")
    assert loss_gap <= 1e-4 * float(eager["train_loss"])
    for a, b in changes + moments:
        assert _norm_gap(a, b) <= 1e-2 and _cos(a, b) >= 0.99
    assert _rel(grid, e_grid) <= 1e-3


@pytest.mark.cuda
def test_ngp_graph_swept_frames_equal_eager_frames(cuda_device, tmp_path):
    """Two 200x200 views (9 full chunks of 4096 rays and a tail each) of an NGP
    checkpoint through the serving set-up's ``StaticRenderChunk`` (the first
    full chunk eager, a capture, replays) equal the eager loop's frames bit
    for bit: the forward kernel has no atomics."""
    from nerfbench.fields import ngp as F
    from minimal_nerf_torch import views
    from minimal_nerf_torch.ops import cameras

    cfg, tr, images, poses, focal, grid, params = _setup(cuda_device)
    view = dict(tr, checkpoint_step=2000, chunk=4096)
    chunk = F.serve_program(cfg, view, params, grid, tmp_path, cuda_device)
    assert isinstance(chunk, views.StaticRenderChunk)
    hw = 200
    focal = cameras.focal_from_angle(hw, views.DEFAULT_CAM_ANGLE_X)
    poses = torch.as_tensor(cameras.spherical_poses(num_poses=5)[1:3], device=cuda_device)
    sweep = lambda c: list(views.render_poses_batched(  # noqa: E731
        c, poses, hw, hw, focal, chunk=4096, frame_seeds=[3141592653, 2 ** 31 + 12345],
        frames_per_dispatch=1, device=cuda_device, device_frames=True))
    want = sweep(chunk.render_chunk)
    assert not torch.equal(want[0], want[1]) and want[0].float().std() > 0
    profiling.reset()
    got = sweep(chunk)
    assert profiling.counter("view.graph_replays") == 2 * (math.ceil(hw * hw / 4096) - 1) - 1
    assert profiling.counter(he.LAUNCHES_FWD) == 2 * 2 * math.ceil(hw * hw / 4096)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
