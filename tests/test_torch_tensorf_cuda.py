"""TensoRF's VM sampling kernels and the field's replayed train step and
graph-swept views, on a card, at the published widths (N 300, 16 + 48
components a mode).

Marked ``cuda``: they skip without a card. This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tensorf_cuda.py

Tolerances: the forward kernel does the plain version's operations in its
order with no FMA (``csrc/vm_sample_common.cuh``), so ``f_sigma`` and the
products agree to fp32 rounding (1e-6 relative per element, against the
largest value); the backward adds its terms with float4 atomics in an
order that changes from run to run, as does ``index_add_`` on the card,
and sums the terms of a run of consecutive points in one cell in registers
first, so each factor entry's gradient is held within 1e-5 of the sum of
its terms' magnitudes (fp32 summation error of a few thousand terms an
entry at most). A replayed step and an eager one differ only by that order, which
the steps amplify: Adam turns the sign of a gradient near 0 into a step of
the learning rate (0.02 on the factors, twice Instant-NGP's), and the fine
samples, drawn from the coarse weights' CDF, jump to another bin when a
weight moves across a draw. After 20 steps an H100 read, over three runs,
the losses up to 6.7e-4 apart, each leaf's change within 0.0035 in norm,
each first moment within 0.0141 (the last layer's 3-entry bias; the other
leaves within 0.005), a cosine of at least 0.986 (the appearance lines'
moment the lowest), the grid up to 1.04e-3 apart in L2: the test holds the
losses to 2e-3, the changes' norms to 1e-2 and the moments' to 5e-2, the
cosines to 0.95 and the grid to 5e-3, about three times those readings.

The shading kernels (``kernels/tensorf_mlp.py``) round every product's
inputs to bf16 and sum in fp32 as the plain chain does at bf16, but round
the backward's gradients at other points (the plain chain rounds each
gradient that leaves a product; the kernels keep them fp32 until the next
product), so each output is held to the plain chain in relative L2 norm:
rgb within 1e-3, every gradient within 2e-2. An H100 read at most 1.13e-4
and 5.6e-3 on these inputs, while both sides sat 2e-3 to 8e-2 from a
float64 evaluation of the chain, equally far; the plain chain with one input
column of the first layer dropped fails them.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from minimal_nerf_torch.kernels import tensorf_mlp as tm
from minimal_nerf_torch.kernels import vm_sample as vm
from minimal_nerf_torch.models.tensorf import TensoRFConfig, TensoRFField
from minimal_nerf_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
POINTS = 1 << 18
BOUND = TensoRFConfig().bound


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    profiling.reset()
    return torch.device("cuda")


def _factors(dev, seed=1, scale=2.0):
    cfg = TensoRFConfig()
    n = cfg.resolution
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"density_planes": (3, n, n, 16), "density_lines": (3, n, 16),
              "app_planes": (3, n, n, 48), "app_lines": (3, n, 48)}
    return {k: (torch.rand(s, generator=g, device=dev) * 2 - 1) * scale
            for k, s in shapes.items()}


def _points(dev, n=POINTS, seed=0, spread=1.8):
    """Uniform points over ``[-spread, spread]^3`` (some outside the box),
    the first 16 on the box's corners and far faces."""
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
    o = (torch.rand(rays, 1, 3, generator=gen, device=dev) * 2 - 1) * 1.2
    d = torch.nn.functional.normalize(torch.randn(rays, 1, 3, generator=gen, device=dev), dim=-1)
    even = torch.linspace(0.0, 1.5, 16, device=dev).expand(rays, 16)
    near = torch.rand(rays, 1, generator=gen, device=dev)
    drawn = near + 0.1 * torch.rand(rays, 48, generator=gen, device=dev)
    t = torch.sort(torch.cat([even, drawn], dim=1), dim=1).values
    return (o + t[..., None] * d).reshape(-1, 3).contiguous()


def _case(case, dev, gen):
    if case == "rays":
        return _ray_points(dev, 4096, gen)
    if case == "rays_ragged":  # P a multiple of neither the chunk, the block nor 16
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


def _rel_max(got, want):
    finite = torch.isfinite(want)
    assert torch.equal(finite, torch.isfinite(got)) and torch.equal(got[~finite], want[~finite])
    return float((got[finite] - want[finite]).abs().max() / want[finite].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rays", "rays_ragged", "one_cell", "random", "few"])
def test_forward_matches_the_plain_version(cuda_device, case):
    """``f_sigma`` (``-inf`` outside the box) and the 144 products of the
    forward kernel, and its density-only launch, against ``sample_plain``
    on the card."""
    factors = _factors(cuda_device)
    x = _case(case, cuda_device, torch.Generator(device=cuda_device).manual_seed(11))
    sigma, prods = vm.forward(x, factors, BOUND)
    want_s, want_p = vm.sample_plain(x, factors, BOUND)
    alone, none = vm.forward(x, factors, BOUND, with_app=False)
    errs = (_rel_max(sigma, want_s), _rel_max(prods, want_p))
    print(f"[vm-fwd] {case} P={x.shape[0]}: f_sigma {errs[0]:.3e}, products {errs[1]:.3e}, "
          f"outside {int((~torch.isfinite(want_s)).sum())}")
    assert errs[0] <= 1e-6 and errs[1] <= 1e-6
    assert none is None and torch.equal(alone, sigma)
    assert profiling.counter(vm.LAUNCHES_FWD) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rays", "rays_ragged", "one_cell", "random", "few",
                                  "again"])
def test_backward_matches_the_plain_version(cuda_device, case):
    """The four factors' gradients of the backward kernel against
    ``backward_plain``: points along rays as the fine pass lays them out (all
    P, and a ragged P), all in one cell (every run merges), uniform over a
    box larger than the field's (nothing merges, some outside), fewer than
    a block's chunk; each entry within 1e-5 of the sum of its terms'
    magnitudes, an entry no term reaches left at 0; a second launch on the
    same inputs within it too."""
    factors = _factors(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x = _case("rays" if case == "again" else case, cuda_device, gen)
    g_s = torch.randn(x.shape[0], generator=gen, device=cuda_device)
    g_p = torch.randn(x.shape[0], 144, generator=gen, device=cuda_device)
    got = vm.backward(x, factors, BOUND, g_s, g_p)
    want = vm.backward_plain(x, factors, BOUND, g_s, g_p)
    scale = vm.backward_plain(x, {k: t.abs() for k, t in factors.items()}, BOUND, g_s.abs(),
                              g_p.abs())
    if case == "again":
        got = vm.backward(x, factors, BOUND, g_s, g_p)
    for key, a, b, s in zip(vm.KEYS, got, want, scale):
        excess = float(((a - b).abs() - 1e-5 * s).max())
        print(f"[vm-bwd] {case} P={x.shape[0]} {key}: max |k - p| {float((a - b).abs().max()):.3e}"
              f", touched {int((b != 0).sum())}")
        assert excess <= 0.0, key
        # an entry no term reaches has a tolerance of 0: the kernel leaves it
        # untouched (a reached entry may sum to an exact 0 in one order only)
        assert not bool(a[s == 0].any()), key
    assert profiling.counter(vm.LAUNCHES_BWD) == (2 if case == "again" else 1)


@pytest.mark.cuda
def test_function_matches_autograd_of_the_plain_version(cuda_device):
    """``vm_sample`` (the kernels under autograd) against autograd through
    ``sample_plain``: the outputs equal, the factors' gradients within the
    atomics' tolerance."""
    factors = {k: t.requires_grad_(True) for k, t in _factors(cuda_device).items()}
    x = _ray_points(cuda_device, 1024, torch.Generator(device=cuda_device).manual_seed(13))
    probe = torch.randn(x.shape[0], 145, device=cuda_device)
    grads = []
    for fn in (vm.vm_sample, vm.sample_plain):
        s, p = fn(x, factors, BOUND)
        loss = (torch.nan_to_num(s, neginf=0.0) * probe[:, 0]).sum() + (p * probe[:, 1:]).sum()
        grads.append(torch.autograd.grad(loss, [factors[k] for k in vm.KEYS]))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _setup(dev, num_rays=4096, frames=8, size=200):
    from nerfbench.fields import tensorf as F
    from nerfbench.traffic import generate as gen

    cfg = json.loads((ROOT / "nerfbench/configs/tensorf_vm192_16_48.json").read_text())
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
def test_replayed_tensorf_steps_match_eager_steps(cuda_device):
    """A call of 20 steps of ``make_multi_step`` (one eager step, the
    capture, 19 replays; a grid update at step 1,008) against 20 eager
    steps of ``make_train_step``: the last loss, each leaf's change, the
    moments and the grid within the tolerance of the atomics' order
    (module doc); the launch counters count the capture's launches again
    for each replay."""
    from nerfbench.fields import tensorf as F
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    cfg, tr, images, poses, focal, grid0, params0 = _setup(cuda_device)
    nerf_cfg, train_cfg, tensorf_cfg = F.program_configs(cfg)
    static = loop.SceneStatic(tr["height"], tr["width"], focal, tr["frames"])
    field, occ_cfg = TensoRFField(tensorf_cfg), train_cfg.occupancy_config
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
    params, state, grid, replayed = multi(params, state, grid, images, poses, 1000, 7)
    counts = profiling.counters()
    assert counts["graph.replays"] == 19
    # the eager first step, the capture and 19 replays: 21 steps' launches,
    # and the grid update's density-only launch at step 1,008
    assert counts[vm.LAUNCHES_FWD] == 2 * 21 + 1 and counts[vm.LAUNCHES_BWD] == 2 * 21
    loss_gap = abs(float(replayed["train_loss"]) - float(eager["train_loss"]))
    changes = [(a - p0, b - p0) for a, b, p0 in zip(flatten_tree(params), flatten_tree(e_params),
                                                    flatten_tree(params0))]
    moments = list(zip(flatten_tree(state["mu"]), flatten_tree(e_state["mu"])))
    print(f"[tensorf-multi-step] loss {float(eager['train_loss'])!r} / "
          f"{float(replayed['train_loss'])!r}; per leaf, change: L2 gap "
          f"{[_rel(a, b) for a, b in changes]}, norm gap {[_norm_gap(a, b) for a, b in changes]}"
          f", 1 - cos {[1 - _cos(a, b) for a, b in changes]}; first moment: norm gap "
          f"{[_norm_gap(a, b) for a, b in moments]}, 1 - cos {[1 - _cos(a, b) for a, b in moments]}"
          f"; grid {_rel(grid, e_grid)}")
    assert loss_gap <= 2e-3 * float(eager["train_loss"])
    for (a, b), norm_tol in [(c, 1e-2) for c in changes] + [(m, 5e-2) for m in moments]:
        assert _norm_gap(a, b) <= norm_tol and _cos(a, b) >= 0.95
    assert _rel(grid, e_grid) <= 5e-3


@pytest.mark.cuda
def test_tensorf_graph_swept_frames_equal_eager_frames(cuda_device, tmp_path):
    """Two 200x200 views (9 full chunks of 4096 rays and a tail each) of a
    TensoRF checkpoint through the serving set-up's ``StaticRenderChunk``
    (the first full chunk eager, a capture, replays) equal the eager loop's
    frames bit for bit: the forward kernel has no atomics."""
    from nerfbench.fields import tensorf as F
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
    assert profiling.counter(vm.LAUNCHES_FWD) == 2 * 2 * math.ceil(hw * hw / 4096)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


MLP_RTOL = {"rgb": 1e-3, "dprods": 2e-2, "dbasis": 2e-2, "dw1": 2e-2, "db1": 2e-2, "dw2": 2e-2,
            "db2": 2e-2, "dw3": 2e-2, "db3": 2e-2}


def _mlp_inputs(dev, rays, s, seed):
    """Products ``U(+-2)`` with a tenth of the points outside the box (zero
    products), directions, the basis and the layers ``U(+-sqrt(6 / in))``
    (biases ``U(+-1 / sqrt(in))``), the color's gradient."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = rays * s
    prods = (torch.rand(p, tm.PRODS, generator=g, device=dev) * 2 - 1) * 2.0
    prods[torch.rand(p, generator=g, device=dev) < 0.1] = 0.0
    direc = torch.randn(rays, 3, generator=g, device=dev)
    u = lambda *shape, scale: (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * scale  # noqa: E731
    basis = u(tm.PRODS, tm.APP_DIM, scale=math.sqrt(6.0 / tm.PRODS))
    mlp = [{"w": u(k, o, scale=math.sqrt(6.0 / k)), "b": u(o, scale=1.0 / math.sqrt(k))}
           for k, o in ((tm.IN, tm.WIDTH), (tm.WIDTH, tm.WIDTH), (tm.WIDTH, 3))]
    return prods, direc, basis, mlp, torch.randn(p, 3, generator=g, device=dev)


def _mlp_outputs(fn, prods, direc, basis, mlp, g_rgb):
    """``fn``'s rgb and autograd's gradients of the products, the basis and
    each layer's w and b (``MLP_RTOL``'s order)."""
    leaves = [prods.clone().requires_grad_(True), basis.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for layer in mlp for t in (layer["w"], layer["b"])]
    layers = [{"w": leaves[2 + 2 * i], "b": leaves[3 + 2 * i]} for i in range(3)]
    rgb = fn(leaves[0], direc, leaves[1], layers)
    return [rgb.detach()] + list(torch.autograd.grad(rgb, leaves, g_rgb))


def _plain(prods, direc, basis, mlp, dropped=None):
    """The plain chain at bf16; with ``dropped``, that input column of the
    first layer zeroed (a planted fault)."""
    if dropped is None:
        return tm.mlp_plain(prods, direc, basis, mlp, 2, 2, torch.bfloat16)
    from minimal_nerf_torch.models.mlp import linear, round_to

    bf, s = torch.bfloat16, prods.shape[0] // direc.shape[0]
    a = round_to(prods, bf) @ round_to(basis, bf)
    d = direc / torch.linalg.norm(direc, dim=-1, keepdim=True)
    d = torch.cat([d, tm.frequency_encoding(d, 2)], dim=-1).repeat_interleave(s, dim=0)
    h = torch.cat([a, d[:, :3], tm.frequency_encoding(a, 2), d[:, 3:]], dim=-1)
    h = h * (torch.arange(h.shape[1], device=h.device) != dropped)
    for layer in mlp[:-1]:
        h = torch.relu(linear(layer, h, bf))
    return torch.sigmoid(linear(mlp[-1], h, bf))


def _mlp_gaps(got, want):
    return {k: _rel(a, b) for k, a, b in zip(MLP_RTOL, got, want)}


@pytest.mark.cuda
@pytest.mark.parametrize("rays,s", [(4096, 16), (4096, 64), (1000, 7)],
                         ids=["coarse", "fine", "ragged"])
def test_mlp_kernels_match_the_plain_chain(cuda_device, rays, s):
    """The shading kernels under autograd (``tensorf_mlp``) against autograd
    of the plain chain at bf16: rgb and the gradients of the products, the
    basis and every layer, at one ``train.tensorf`` step's coarse (4,096 x
    16) and fine (4,096 x 64) shapes and at a ragged P (1,000 x 7), within
    ``MLP_RTOL`` (module doc); one launch each way."""
    prods, direc, basis, mlp, g = _mlp_inputs(cuda_device, rays, s, rays + s)
    got = _mlp_outputs(tm.tensorf_mlp, prods, direc, basis, mlp, g)
    gaps = _mlp_gaps(got, _mlp_outputs(_plain, prods, direc, basis, mlp, g))
    print(f"[tensorf-mlp] P={rays * s}: " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert all(gaps[k] <= MLP_RTOL[k] for k in gaps), gaps
    assert profiling.counter(tm.LAUNCHES_FWD) == 1 and profiling.counter(tm.LAUNCHES_BWD) == 1


@pytest.mark.cuda
def test_mlp_backward_gives_the_same_bits_twice(cuda_device):
    """Two backward calls on the same inputs: every output bit-identical
    (fixed slices of the points, no atomics)."""
    prods, direc, basis, mlp, g = _mlp_inputs(cuda_device, 4096, 64, 5)
    _, image = tm.forward(prods, direc, basis, mlp)
    first, again = (tm.backward(prods, direc, basis, mlp, image, g) for _ in range(2))
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert all(torch.equal(x[k], y[k]) for x, y in zip(first[2], again[2]) for k in ("w", "b"))


@pytest.mark.cuda
@pytest.mark.parametrize("dropped", [0, 30, 138], ids=["a0", "sin_a0", "sin_d0"])
def test_mlp_tolerance_rejects_a_dropped_column(cuda_device, dropped):
    """The plain chain with one input column of the first layer dropped (a
    feature, a feature's sine, a direction's sine) fails ``MLP_RTOL``
    against the kernels."""
    prods, direc, basis, mlp, g = _mlp_inputs(cuda_device, 4096, 16, 6)
    got = _mlp_outputs(tm.tensorf_mlp, prods, direc, basis, mlp, g)
    bad = _mlp_outputs(lambda *a: _plain(*a, dropped=dropped), prods, direc, basis, mlp, g)
    gaps = _mlp_gaps(got, bad)
    print(f"[tensorf-mlp] column {dropped} dropped: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    assert any(gaps[k] > MLP_RTOL[k] for k in gaps)
