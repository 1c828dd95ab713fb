"""K-Planes' plane sampling kernels and the field's replayed train step and
graph-swept views, on a card, at the published sizes (4 scales of 3 planes
of 32 features at 64^2 to 512^2) and at small resolutions (4^2 to 32^2).

Marked ``cuda``: they skip without a card. This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kplanes_cuda.py

Tolerances: the forward kernel does the plain version's operations in its
order with no FMA (``csrc/plane_corners.cuh``), so the features equal the
plain version's bit for bit; the backward adds its terms with float4
atomics in an order that changes from run to run, as does ``index_add_`` on
the card, and sums the terms of a run of consecutive points in one cell in
registers first, so each plane entry's gradient is held within 1e-5 of the
sum of its terms' magnitudes (fp32 summation error of a few thousand terms
an entry at most; the 64^2 planes take the most). A replayed step and an
eager one differ only by that order, which the steps amplify: Adam at
``eps`` 1e-15 turns the sign of a gradient near 0 into a step of the
learning rate, and the fine samples, drawn from the coarse weights' CDF,
jump to another bin when a weight moves across a draw. After 20 steps an
H100 read, over five runs (the benchmark's draw in the last: a density
pre-activation moved down by 1.1 of its bound, a third or so of the box
above the grid's threshold; before it U(+-3.0) once and a narrower draw
three times), the last losses up to 4.5e-4 apart (relative), each leaf's
change within 7.5e-4 in norm and a cosine of at least 0.9937, each first
moment within 0.034 in norm (0.0051 before the benchmark's draw) and a
cosine of at least 0.979 (the planes' the lowest), the grid up to 0.020
apart in L2: REPLAY_TOL holds them to about three times those readings.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from minimal_nerf_torch.kernels import kplane_sample as kp
from minimal_nerf_torch.models.kplanes import KPlanesConfig, KPlanesField
from minimal_nerf_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
POINTS = 1 << 18
BOUND = KPlanesConfig().bound
# 20 replayed against 20 eager steps: the last loss (relative), each leaf's
# change and first moment (their norms' relative gap), the cosine of each
# leaf's change and moment, the grid (relative L2)
REPLAY_TOL = {"loss": 1.5e-3, "change": 2e-3, "moment": 0.1, "cos": 0.94, "grid": 0.02}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    profiling.reset()
    return torch.device("cuda")


def _planes(dev, base=64, seed=1, scale=3.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.rand(3, base * m, base * m, 32, generator=g, device=dev) * 2 - 1) * scale
            for m in (1, 2, 4, 8)]


def _points(dev, n=POINTS, seed=0, spread=1.6):
    """Uniform points over ``[-spread, spread]^3`` (some outside the box,
    which read its border), the first 16 on the box's corners and faces."""
    x = (torch.rand(n, 3, generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev) * 2 - 1) * spread
    k = min(n, 16)
    edge = torch.tensor([[(c >> a) & 1 for a in range(3)] for c in range(8)], device=dev)
    faces = (edge.float() * 2 - 1) * BOUND
    x[:k] = torch.cat([faces, faces * torch.tensor([1.0, 0.3, 1.0], device=dev)])[:k]
    return x.contiguous()


def _ray_points(dev, rays, gen):
    """Points as the fine pass lays them out: per ray 16 even samples and 48
    drawn around one depth, sorted along the ray (64 a ray), mostly inside
    the box."""
    o = (torch.rand(rays, 1, 3, generator=gen, device=dev) * 2 - 1) * 1.0
    d = torch.nn.functional.normalize(torch.randn(rays, 1, 3, generator=gen, device=dev), dim=-1)
    even = torch.linspace(0.0, 1.3, 16, device=dev).expand(rays, 16)
    near = torch.rand(rays, 1, generator=gen, device=dev)
    drawn = near + 0.1 * torch.rand(rays, 48, generator=gen, device=dev)
    t = torch.sort(torch.cat([even, drawn], dim=1), dim=1).values
    return (o + t[..., None] * d).reshape(-1, 3).contiguous()


def _case(case, dev, gen):
    if case == "rays":
        return _ray_points(dev, 4096, gen)
    if case == "rays_ragged":  # P a multiple of neither the chunk, the block nor 32
        return _ray_points(dev, 2049, gen)[:-19].contiguous()
    if case == "one_cell":
        base = torch.tensor([0.3137, -0.5821, 0.7043], device=dev)
        return (base + (torch.rand(65536, 3, generator=gen, device=dev) - 0.5) * 1e-4
                ).contiguous()
    if case == "random":
        return _points(dev)
    if case == "few":
        return _points(dev, 45)
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("base", [64, 4], ids=["published", "small"])
@pytest.mark.parametrize("case", ["rays", "rays_ragged", "one_cell", "random", "few"])
def test_forward_equals_the_plain_version(cuda_device, case, base):
    """The forward kernel's 128 features against ``sample_plain`` on the
    card, bit for bit, border points included."""
    planes = _planes(cuda_device, base)
    x = _case(case, cuda_device, torch.Generator(device=cuda_device).manual_seed(11))
    got = kp.forward(x, planes, BOUND)
    want = kp.sample_plain(x, planes, BOUND)
    print(f"[kplane-fwd] {case} base {base} P={x.shape[0]}: max |k - p| "
          f"{float((got - want).abs().max()):.3e}, outside the box "
          f"{int((x.abs() > BOUND).any(dim=1).sum())}")
    assert torch.equal(got, want)
    assert profiling.counter(kp.LAUNCHES_FWD) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("base", [64, 4], ids=["published", "small"])
@pytest.mark.parametrize("case", ["rays", "rays_ragged", "one_cell", "random", "few", "again"])
def test_backward_matches_the_plain_version(cuda_device, case, base):
    """The planes' gradients of the backward kernel against
    ``backward_plain``: points along rays as the fine pass lays them out (all
    P, and a ragged P), all in one cell (every run merges), uniform over a
    box larger than the field's (nothing merges; the outside reads and adds
    to the border), fewer than a block's chunk; each entry within 1e-5 of
    the sum of its terms' magnitudes, an entry no term reaches left at 0; a
    second launch on the same inputs within it too."""
    planes = _planes(cuda_device, base)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x = _case("rays" if case == "again" else case, cuda_device, gen)
    g = torch.randn(x.shape[0], 128, generator=gen, device=cuda_device)
    got = kp.backward(x, planes, BOUND, g)
    want = kp.backward_plain(x, planes, BOUND, g)
    scale = kp.backward_plain(x, [t.abs() for t in planes], BOUND, g.abs())
    if case == "again":
        got = kp.backward(x, planes, BOUND, g)
    for s, (a, b, m) in enumerate(zip(got, want, scale)):
        excess = float(((a - b).abs() - 1e-5 * m).max())
        print(f"[kplane-bwd] {case} base {base} P={x.shape[0]} scale {s}: max |k - p| "
              f"{float((a - b).abs().max()):.3e}, touched {int((b != 0).sum())}")
        assert excess <= 0.0, s
        # an entry no term reaches has a tolerance of 0: the kernel leaves it
        # untouched (a reached entry may sum to an exact 0 in one order only)
        assert not bool(a[m == 0].any()), s
    assert profiling.counter(kp.LAUNCHES_BWD) == (2 if case == "again" else 1)


@pytest.mark.cuda
def test_function_matches_autograd_of_the_plain_version(cuda_device):
    """``kplane_sample`` (the kernels under autograd) against autograd
    through ``sample_plain``: the features equal, the planes' gradients
    within the atomics' tolerance."""
    planes = [t.requires_grad_(True) for t in _planes(cuda_device)]
    x = _ray_points(cuda_device, 1024, torch.Generator(device=cuda_device).manual_seed(13))
    probe = torch.randn(x.shape[0], 128, device=cuda_device)
    outs, grads = [], []
    for fn in (kp.kplane_sample, kp.sample_plain):
        f = fn(x, planes, BOUND)
        outs.append(f.detach())
        grads.append(torch.autograd.grad((f * probe).sum(), planes))
    assert torch.equal(*outs)
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _setup(dev, num_rays=4096, frames=8, size=200):
    from nerfbench.fields import kplanes as F
    from nerfbench.traffic import generate as gen

    cfg = json.loads((ROOT / "nerfbench/configs/kplanes_hybrid_16_48.json").read_text())
    cfg["train"]["num_rays"] = num_rays
    traffic = json.loads((ROOT / "nerfbench/traffic/train_steps.json").read_text())
    traffic.update(frames=frames, height=size, width=size)
    images, poses, focal = gen.scene(5, traffic, dev)
    grid = gen.grid(5, cfg["occupancy"], traffic["grid"], dev)
    return cfg, traffic, images, poses, focal, grid, F.weights(5, cfg, traffic, dev)


def _norm_gap(a, b):
    a, b = a.detach(), b.detach()
    return abs(float(torch.linalg.norm(a.double())) / float(torch.linalg.norm(b.double())) - 1)


def _cos(a, b):
    a, b = a.detach().double().reshape(-1), b.detach().double().reshape(-1)
    return float(torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b)))


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.cuda
def test_replayed_kplanes_steps_match_eager_steps(cuda_device):
    """A call of 20 steps of ``make_multi_step`` (one eager step, the
    capture, 19 replays; a grid update at step 1,008) against 20 eager
    steps of ``make_train_step``: the last loss, each leaf's change, the
    moments and the grid within REPLAY_TOL (module doc); the launch
    counters of the call count the capture's launches again for each
    replay, and the TV term's span runs in the capture only."""
    from nerfbench.fields import kplanes as F
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    cfg, tr, images, poses, focal, grid0, params0 = _setup(cuda_device)
    nerf_cfg, train_cfg, kplanes_cfg = F.program_configs(cfg)
    static = loop.SceneStatic(tr["height"], tr["width"], focal, tr["frames"])
    field, occ_cfg = KPlanesField(kplanes_cfg), train_cfg.occupancy_config
    clone = lambda: (map_params(lambda t: t.clone(), params0), grid0.clone())  # noqa: E731
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
    with profiling.tracing():
        params, state, grid, replayed = multi(params, state, grid, images, poses, 1000, 7)
    counts = profiling.counters()
    spans = [s.name for s in profiling.spans()]
    assert counts["graph.replays"] == 19
    # the eager first step, the capture and 19 replays: 21 steps' launches,
    # and the grid update's forward launch at step 1,008
    assert counts[kp.LAUNCHES_FWD] == 2 * 21 + 1 and counts[kp.LAUNCHES_BWD] == 2 * 21
    # the TV gradient of the 4 scales' planes: the eager step's and the capture's
    assert spans.count("nerf.kplanes.tv") == 2 * 4
    loss_gap = abs(float(replayed["train_loss"]) - float(eager["train_loss"]))
    changes = [(a - p0, b - p0) for a, b, p0 in zip(flatten_tree(params), flatten_tree(e_params),
                                                    flatten_tree(params0))]
    moments = list(zip(flatten_tree(state["mu"]), flatten_tree(e_state["mu"])))
    print(f"[kplanes-multi-step] loss {float(eager['train_loss'])!r} / "
          f"{float(replayed['train_loss'])!r}; per leaf, change: L2 gap "
          f"{[_rel(a, b) for a, b in changes]}, norm gap {[_norm_gap(a, b) for a, b in changes]}"
          f", 1 - cos {[1 - _cos(a, b) for a, b in changes]}; first moment: norm gap "
          f"{[_norm_gap(a, b) for a, b in moments]}, 1 - cos {[1 - _cos(a, b) for a, b in moments]}"
          f"; grid {_rel(grid, e_grid)}")
    assert loss_gap <= REPLAY_TOL["loss"] * float(eager["train_loss"])
    for (a, b), key in [(c, "change") for c in changes] + [(m, "moment") for m in moments]:
        assert _norm_gap(a, b) <= REPLAY_TOL[key] and _cos(a, b) >= REPLAY_TOL["cos"]
    assert _rel(grid, e_grid) <= REPLAY_TOL["grid"]


@pytest.mark.cuda
def test_kplanes_graph_swept_frames_equal_eager_frames(cuda_device, tmp_path):
    """Two 200x200 views (9 full chunks of 4096 rays and a tail each) of a
    K-Planes checkpoint through the serving set-up's ``StaticRenderChunk``
    (the first full chunk eager, a capture, replays) equal the eager loop's
    frames bit for bit: the forward kernel has no atomics."""
    from nerfbench.fields import kplanes as F
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
    assert profiling.counter(kp.LAUNCHES_FWD) == 2 * 2 * math.ceil(hw * hw / 4096)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


@pytest.mark.cuda
def test_one_replayed_call_counts_its_launches(cuda_device):
    """A second call of 20 replayed steps of the benchmark cell's program
    (``fields/kplanes.py::train_program``, its steps 1,020-1,039, a grid
    update at step 1,024) counts 40 forward and 40 backward launches in its
    replays and one forward launch in the grid update, and no eager
    step."""
    from nerfbench.fields import kplanes as F

    cfg, tr, images, poses, focal, grid, params = _setup(cuda_device)
    step, state = F.train_program(cfg, tr, focal, params, cuda_device)
    params, state, grid, _ = step(params, state, grid, images, poses, 1000, 7)
    profiling.reset()
    params, state, grid, metrics = step(params, state, grid, images, poses, 1020, 7)
    torch.cuda.synchronize()
    counts = profiling.counters()
    print(f"[kplanes-launches] one replayed call: {counts}")
    assert counts["graph.replays"] == 20
    assert counts[kp.LAUNCHES_FWD] == 2 * 20 + 1 and counts[kp.LAUNCHES_BWD] == 2 * 20
    assert math.isfinite(float(metrics["train_loss"]))
