"""The port's CUDA kernels (the fused ray-march forward and backward, the
point-level MLP forward and backward, the occupancy probe and the fused
occupancy sampler) against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip without a card. This file imports neither JAX nor
the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from minimal_nerf_torch.kernels import fused_raymarch as fr
from minimal_nerf_torch.kernels import occupancy_probe as op
from minimal_nerf_torch.kernels import occupancy_sampler as osk
from minimal_nerf_torch.kernels import raymarch as rm
from minimal_nerf_torch.models.mlp import init_nerf_mlp
from minimal_nerf_torch.ops import occupancy as occ
from minimal_nerf_torch.utils import profiling

# the bounds of chip_smoke.py: every element |k - p| <= atol + rtol * |p|,
# and mean |k - p| <= mean_rtol * mean |p|. fp32: same rounding points, other
# sum order; bf16: a different fp32 sum order now and then flips a bf16
# rounding of an activation (relative step 2^-8), which the element bound
# admits and the mean bound keeps rare
TOL = {None: (1e-5, 1e-4, 1e-5), torch.bfloat16: (3e-3, 3e-3, 1e-3)}
# the point kernel, per output (sigma, rgb): chip_smoke.py's POINT_TOL. bf16
# outputs are per point, with no compositing to average a flipped rounding
# away, and sigma is linear in the 256 bf16-rounded h values (H100 readings
# over 786k points: max 2.6e-2 sigma, 7.3e-3 rgb; here 9.6e-3 sigma)
POINT_TOL = {None: (TOL[None], TOL[None]),
             torch.bfloat16: ((6e-2, 1e-2, 1e-3), (2e-2, 3e-3, 1e-3))}
# He-uniform weights: the outputs depend on the input, so a wrong layer shows
HE_GAIN = np.sqrt(6.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    profiling.reset()
    return torch.device("cuda")


def _counts(*names):
    """The launch counters ``names`` (``utils.profiling``)."""
    return tuple(profiling.counter(n) for n in names)


def _assert_close(k, p, tol):
    atol, rtol, mean_rtol = tol
    k, p = k.cpu().numpy(), p.cpu().numpy()
    np.testing.assert_allclose(k, p, rtol=rtol, atol=atol)
    assert np.abs(k - p).mean() <= mean_rtol * np.abs(p).mean()


def _inputs(seed, n, s, dev):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = (rng.normal(size=(n, 3)) - [0.0, 0.0, 2.0]).astype(np.float32)
    ts = np.sort(rng.uniform(2.0, 6.0, size=(n, s)), axis=1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (o, d, ts)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
# S in {1, 7, 64, 192, 250, 1024}; N not a multiple of the rays per CTA
# (128 at S = 1 or 7, 2 at S = 64, 192 or 250; 1 at S = 1024)
@pytest.mark.parametrize("n,s", [(37, 64), (64, 192), (5, 250), (3, 1), (130, 1), (33, 7),
                                 (63, 192), (3, 1024)])
def test_fused_kernel_matches_plain(cuda_device, dtype, n, s):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=cuda_device, gain=HE_GAIN), dtype)
    o, d, ts = _inputs(5, n, s, cuda_device)
    kc, kw = fr.fused_forward(fm, o, d, ts)
    pc, pw = fr.fused_forward_plain(fm, o, d, ts)
    torch.cuda.synchronize()
    _assert_close(kc, pc, TOL[dtype])
    _assert_close(kw, pw, TOL[dtype])
    assert profiling.counter(fr.FWD_LAUNCHES) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("layer", [2, 5, 10])  # trunk[2], skip concat, direction part
def test_fused_tolerance_rejects_a_faulty_layer(cuda_device, dtype, layer):
    """A pass with one layer zeroed fails the tolerance the kernel meets."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=cuda_device, gain=HE_GAIN), dtype)
    o, d, ts = _inputs(5, 64, 192, cuda_device)
    pc, _ = fr.fused_forward_plain(fm, o, d, ts)
    ws = list(fm.ws)
    ws[layer] = torch.zeros_like(ws[layer])
    bc, _ = fr.fused_forward_plain(fm._replace(ws=ws), o, d, ts)
    with pytest.raises(AssertionError):
        _assert_close(bc, pc, TOL[dtype])


@pytest.mark.cuda
def test_fused_kernel_rejects_bad_inputs(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=cuda_device), torch.bfloat16)
    o, d, ts = _inputs(1, 4, 8, cuda_device)
    with pytest.raises(ValueError):
        fr.fused_forward(fm, o, d, ts.double())
    with pytest.raises(ValueError):
        fr.fused_forward(fm, o, d, ts.t())
    with pytest.raises(ValueError):
        fr.fused_forward(fm, o, d, torch.zeros(4, 2000, device=cuda_device))
    assert profiling.counter(fr.FWD_LAUNCHES) == 0


def _bf16_forward(kind, dev, fm, seed=5):
    """A bf16 forward kernel's call and its plain version on fixed inputs."""
    if kind == "fused":
        o, d, ts = _inputs(seed, 63, 192, dev)
        return (lambda m: fr.fused_forward(m, o, d, ts)), fr.fused_forward_plain(fm, o, d, ts)
    x, d = _points(seed, 300 * 128 + 65, dev)
    return (lambda m: rm.points_forward(m, x, d)), rm.points_forward_plain(fm, x, d)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fused", "point"])
def test_bf16_forward_is_deterministic(cuda_device, kind):
    """Two launches of a bf16 forward give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=cuda_device, gain=HE_GAIN), torch.bfloat16)
    run, _ = _bf16_forward(kind, cuda_device, fm)
    first, second = run(fm), run(fm)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fused", "point"])
@pytest.mark.parametrize("layer", [0, 3, 5, 7, 9, 10])  # T0, T3, F0E, F2, R0H, R0D
def test_bf16_forward_reads_every_matrix(cuda_device, kind, layer):
    """With one matrix zeroed in the kernel's operands (its tensor map among
    them), a bf16 forward fails the bounds against the plain version of the
    intact MLP, which the intact kernel meets: each map reaches its layer."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=cuda_device, gain=HE_GAIN), torch.bfloat16)
    ws = list(fm.ws)
    ws[layer] = torch.zeros_like(ws[layer])
    bad = fr._prepared(ws, fm.bs, fm.dtype)
    run, plain = _bf16_forward(kind, cuda_device, fm)
    good, broken = run(fm), run(bad)
    torch.cuda.synchronize()
    tols = ((TOL[torch.bfloat16],) * 2 if kind == "fused" else POINT_TOL[torch.bfloat16])
    for k, p, tol in zip(good, plain, tols):
        _assert_close(k, p, tol)
    # the rgb layers (9, 10) leave sigma and the weights as they are
    failed = []
    for b, p, tol in zip(broken, plain, tols):
        try:
            _assert_close(b, p, tol)
        except AssertionError:
            failed.append(True)
    assert failed


# ---------------------------------------------------------------- backward

# the backward kernel against fused_backward_plain, per gradient leaf:
# max |k - p| <= max_rtol * max |p| and mean |k - p| <= mean_rtol * mean |p|.
# fp32: same rounding points, other sum orders (per-CTA chains, point
#   slices, then a fixed-order sum of the slices);
# bf16: a different fp32 sum order flips the bf16 rounding of an activation
#   now and then; downstream, the compositing's fp32 values differ by ~1e-4
#   and 5-10% of the bf16 gradient activations round to the other neighbour
#   (a 2^-8 step each). Measured on an H100 at these sizes: worst leaf
#   max 2.4e-2, mean 8.3e-3 (the gradients sum many such flips with mixed
#   signs). The bounds sit 2.5x above that; each faulty plain version fails.
BWD_TOL = {None: (1e-4, 1e-5), torch.bfloat16: (6e-2, 2e-2)}
# fp32 at the main path's scale (over 100k points: 4097 rays x 64 samples,
# 4096 x 64 + 100 points): each gradient sums that many products of both
# signs, and a pre-activation within an ulp of 0 may take the other side of
# its ReLU mask in another sum order. These are chip_smoke.py's fp32 bounds
# at that scale ([kernel-bwd], [kernel-mlp-bwd]); H100 readings: fused max
# 5.7e-4, mean 1.1e-4; point max 2.5e-3, mean 9.3e-4.
LARGE_FP32_TOL = {"fused": (3e-3, 5e-4), "point": (5e-3, 2e-3)}


def _bwd_tol(dtype, points, kind):
    return LARGE_FP32_TOL[kind] if dtype is None and points > 100_000 else BWD_TOL[dtype]


def _bwd_errors(k, p):
    """Per leaf (max |k - p| / max |p|, mean |k - p| / mean |p|)."""
    return [((a - b).abs().max().item() / (b.abs().max().item() + 1e-30),
             (a - b).abs().mean().item() / (b.abs().mean().item() + 1e-30))
            for a, b in zip(k, p)]


def _bwd_ok(errs, tol):
    return all(mx <= tol[0] and mn <= tol[1] for mx, mn in errs)


def _bwd_case(dev, dtype, n, s, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=dev, gain=HE_GAIN), dtype)
    o, d, ts = _inputs(seed + 5, n, s, dev)
    rng = np.random.default_rng(seed + 6)
    dc = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    dw = torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32) * 0.1).to(dev)
    return fm, o, d, ts, dc, dw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("n,s,with_dw", [(37, 64, True), (63, 192, False), (64, 192, True),
                                         (5, 250, True), (3, 1, False), (1, 1, True),
                                         (4097, 64, False), (131, 250, True)])
def test_backward_kernel_matches_plain(cuda_device, dtype, n, s, with_dw):
    """Ragged last CTA of rays (37, 63, 4097, 131 rays), fewer points than
    one slice of kernel B (S=1), several slices with a ragged last one and a
    ragged last 64-point stage (4097 x 64), S=250 (4 rays, 1,000 rows per
    CTA)."""
    fm, o, d, ts, dc, dw = _bwd_case(cuda_device, dtype, n, s)
    dw = dw if with_dw else None
    kw, kb = fr.fused_backward(fm, o, d, ts, dc, dw)
    pw, pb = fr.fused_backward_plain(fm, o, d, ts, dc, dw)
    torch.cuda.synchronize()
    assert [k.shape for k in kw + kb] == [p.shape for p in pw + pb]
    errs = _bwd_errors(kw + kb, pw + pb)
    print(f"bwd {dtype} n={n} s={s}: worst max {max(e[0] for e in errs):.3e} "
          f"worst mean {max(e[1] for e in errs):.3e}")
    assert _bwd_ok(errs, _bwd_tol(dtype, n * s, "fused")), errs
    assert _counts(fr.BWD_LAUNCHES, fr.WGRAD_LAUNCHES, fr.FWD_LAUNCHES) == (1, 1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_backward_kernel_is_deterministic(cuda_device, dtype):
    fm, o, d, ts, dc, dw = _bwd_case(cuda_device, dtype, 300, 192, seed=1)
    a = fr.fused_backward(fm, o, d, ts, dc, dw)
    b = fr.fused_backward(fm, o, d, ts, dc, dw)
    assert all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_backward_bounds_reject_faults(cuda_device, dtype, monkeypatch):
    """Plain backwards with one fault each (an inclusive suffix sum, the
    skip concat's encoding term dropped) fail the bounds the kernel meets."""
    fm, o, d, ts, dc, dw = _bwd_case(cuda_device, dtype, 64, 192)
    good = fr.fused_backward_plain(fm, o, d, ts, dc, dw)
    orig = fr._suffix_sum
    monkeypatch.setattr(fr, "_suffix_sum", lambda x: orig(x) + x)
    bad_suffix = fr.fused_backward_plain(fm, o, d, ts, dc, dw)
    monkeypatch.setattr(fr, "_suffix_sum", orig)
    ws = list(fm.ws)
    ws[5] = torch.zeros_like(ws[5])
    bad_skip = fr.fused_backward_plain(fm._replace(ws=ws), o, d, ts, dc, dw)
    for bad in (bad_suffix, bad_skip):
        assert not _bwd_ok(_bwd_errors(bad[0] + bad[1], good[0] + good[1]), BWD_TOL[dtype])


def _tiny_first_layer(fm, sign):
    """``fm`` with the first trunk layer's weights times ``sign * 2^-100`` and
    its bias zero: every a0 activation is ~2^-100 or 0, its sign varying
    with the point and the channel (He weights, varying encodings), far
    below every other activation but inside the normal range of bf16."""
    ws, bs = list(fm.ws), list(fm.bs)
    ws[0] = fm.ws[0] * (sign * 2.0 ** -100)
    bs[0] = torch.zeros_like(fm.bs[0])
    params = rm.unflatten_mlp_grads([w.float() for w in ws], bs)
    return fr.prepare_fused_mlp(params, fm.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fused", "point"])
def test_backward_masks_hold_tiny_activations(cuda_device, dtype, kind):
    """The ReLU mask of each a0 activation ~2^-100 on either side of 0 is
    its own: a bit of another row, channel or layer, or a sign test that
    flushes tiny values, gates g_a0 differently on about half of its
    entries and moves the first layer's gradients far outside the bounds.
    The same network with every a0 sign flipped (the complementary masks)
    must fail the bounds, so the check can see the masks."""
    if kind == "fused":
        fm, o, d, ts, dc, dw = _bwd_case(cuda_device, dtype, 64, 192)
        args, kernel, plain = (o, d, ts, dc, dw), fr.fused_backward, fr.fused_backward_plain
    else:
        fm, x, d, dsig, drgb = _point_case(cuda_device, dtype, 64 * 192)
        args, kernel, plain = (x, d, dsig, drgb), rm.points_backward, rm.points_backward_plain
    tiny, flipped = _tiny_first_layer(fm, 1.0), _tiny_first_layer(fm, -1.0)
    kw, kb = kernel(tiny, *args)
    pw, pb = plain(tiny, *args)
    torch.cuda.synchronize()
    # the first layer's weight and bias gradients: e^T g_a0 and sum g_a0
    assert pw[0].abs().max() > 0 and pb[0].abs().max() > 0
    assert _bwd_ok(_bwd_errors(kw + kb, pw + pb), BWD_TOL[dtype])
    fw, fb = plain(flipped, *args)
    assert not _bwd_ok(_bwd_errors([fw[0], fb[0]], [pw[0], pb[0]]), BWD_TOL[dtype])


@pytest.mark.cuda
def test_fused_pass_gradients_on_the_card(cuda_device):
    """``_FusedPass`` on the card gives the plain backward's gradients to the
    parameter tensors."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    params = init_nerf_mlp(g, device=cuda_device, gain=HE_GAIN)
    for leaf in fr.flatten_tree(params):
        leaf.requires_grad_(True)
    o, d, ts = _inputs(3, 50, 64, cuda_device)
    color, weights = fr.fused_render_pass(params, o, d, ts, compute_dtype=torch.bfloat16)
    (color.square().sum() + weights.sum()).backward()
    fm = fr.prepare_fused_mlp(params, torch.bfloat16)
    pw, pb = fr.fused_backward_plain(fm, o, d, ts, 2 * color.detach(), torch.ones_like(ts))
    want = fr.flatten_tree(rm.unflatten_mlp_grads(pw, pb))
    got = [t.grad for t in fr.flatten_tree(params)]
    assert _bwd_ok(_bwd_errors(got, want), BWD_TOL[torch.bfloat16])
    assert profiling.counter(fr.FWD_LAUNCHES) == 1 and profiling.counter(fr.BWD_LAUNCHES) == 1


# ------------------------------------------------ point-level MLP kernels

# P values: a multiple of neither tile (37*64 = 2368 is 18.5 bf16 tiles),
# a few tiles and a ragged rest, one point
# P not a multiple of the 128-point tile (nor of the 64 rows of one warpgroup)
POINT_SIZES = [37 * 64, 5 * 250, 1, 129, 300 * 128 + 65]
# the backward at the first three, at several slices of kernel B with a
# ragged last slice and a ragged last 64-point stage (3 * 4096 + 37), and at
# 4096 x 64 + 100
BWD_POINT_SIZES = [37 * 64, 5 * 250, 1, 3 * 4096 + 37, 4096 * 64 + 100]


def _points(seed, p, dev):
    """Positions / pi of samples in the orbit's range (|x| < 4) and unit
    directions, as nerf_mlp_kernel_apply hands them to the kernels."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-4.0, 4.0, size=(p, 3)) / np.pi).astype(np.float32)
    d = rng.normal(size=(p, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, d)]


def _point_case(dev, dtype, p, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=dev, gain=HE_GAIN), dtype)
    x, d = _points(seed + 5, p, dev)
    rng = np.random.default_rng(seed + 6)
    dsig = torch.from_numpy(rng.normal(size=(p, 1)).astype(np.float32)).to(dev)
    drgb = torch.from_numpy(rng.normal(size=(p, 3)).astype(np.float32)).to(dev)
    return fm, x, d, dsig, drgb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("p", POINT_SIZES)
def test_point_kernel_matches_plain(cuda_device, dtype, p):
    """The point forward kernel against ``points_forward_plain`` within
    POINT_TOL (same MLP, same rounding points, other sum order)."""
    fm, x, d, _, _ = _point_case(cuda_device, dtype, p)
    profiling.reset()
    ks, kr = rm.points_forward(fm, x, d)
    ps, pr = rm.points_forward_plain(fm, x, d)
    torch.cuda.synchronize()
    assert ks.shape == (p, 1) and kr.shape == (p, 3)
    _assert_close(ks, ps, POINT_TOL[dtype][0])
    _assert_close(kr, pr, POINT_TOL[dtype][1])
    assert profiling.counter(rm.FWD_LAUNCHES) == 1 and profiling.counter(fr.FWD_LAUNCHES) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("layer", [2, 5, 10])  # trunk[2], skip concat, direction part
def test_point_tolerance_rejects_a_faulty_layer(cuda_device, dtype, layer):
    fm, x, d, _, _ = _point_case(cuda_device, dtype, 4096)
    ps, pr = rm.points_forward_plain(fm, x, d)
    ws = list(fm.ws)
    ws[layer] = torch.zeros_like(ws[layer])
    bs, br = rm.points_forward_plain(fm._replace(ws=ws), x, d)
    pairs = [(bs, ps, POINT_TOL[dtype][0]), (br, pr, POINT_TOL[dtype][1])]
    for bad, good, tol in pairs[1:] if layer == 10 else pairs:  # sigma ignores d
        with pytest.raises(AssertionError):
            _assert_close(bad, good, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("p", BWD_POINT_SIZES)
def test_point_backward_kernel_matches_plain(cuda_device, dtype, p):
    """The point backward kernel against ``points_backward_plain`` per leaf,
    within the fused backward's bounds (BWD_TOL): the same reverse sweep and
    weight products; the bias sums of the fp32 gradients are formed per tile
    in the kernel and per column in the plain version."""
    fm, x, d, dsig, drgb = _point_case(cuda_device, dtype, p)
    profiling.reset()
    kw, kb = rm.points_backward(fm, x, d, dsig, drgb)
    pw, pb = rm.points_backward_plain(fm, x, d, dsig, drgb)
    torch.cuda.synchronize()
    assert [k.shape for k in kw + kb] == [q.shape for q in pw + pb]
    errs = _bwd_errors(kw + kb, pw + pb)
    print(f"point bwd {dtype} p={p}: worst max {max(e[0] for e in errs):.3e} "
          f"worst mean {max(e[1] for e in errs):.3e}")
    assert _bwd_ok(errs, _bwd_tol(dtype, p, "point")), errs
    assert profiling.counter(rm.BWD_LAUNCHES) == 1 and profiling.counter(fr.BWD_LAUNCHES) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_point_backward_kernel_is_deterministic(cuda_device, dtype):
    fm, x, d, dsig, drgb = _point_case(cuda_device, dtype, 300 * 192 + 5, seed=1)
    a = rm.points_backward(fm, x, d, dsig, drgb)
    b = rm.points_backward(fm, x, d, dsig, drgb)
    assert all(torch.equal(u, v) for u, v in zip(a[0] + a[1], b[0] + b[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_point_backward_bounds_reject_faults(cuda_device, dtype):
    """Plain backwards with one fault each (the skip concat's encoding term
    dropped, dsigma ignored) fail the bounds the kernel meets."""
    fm, x, d, dsig, drgb = _point_case(cuda_device, dtype, 64 * 192)
    good = rm.points_backward_plain(fm, x, d, dsig, drgb)
    ws = list(fm.ws)
    ws[5] = torch.zeros_like(ws[5])
    bad_skip = rm.points_backward_plain(fm._replace(ws=ws), x, d, dsig, drgb)
    bad_dsig = rm.points_backward_plain(fm, x, d, torch.zeros_like(dsig), drgb)
    for bad in (bad_skip, bad_dsig):
        assert not _bwd_ok(_bwd_errors(bad[0] + bad[1], good[0] + good[1]), BWD_TOL[dtype])


@pytest.mark.cuda
def test_point_kernels_reject_bad_inputs(cuda_device):
    fm, x, d, dsig, drgb = _point_case(cuda_device, torch.bfloat16, 64)
    profiling.reset()
    with pytest.raises(ValueError):
        rm.points_forward(fm, x.double(), d)
    with pytest.raises(ValueError):
        rm.points_forward(fm, x, d.t().contiguous().t())
    with pytest.raises(ValueError):
        rm.points_forward(fm, x, d[:10])
    with pytest.raises(ValueError):
        rm.points_forward(fm, x, d, 11, 4)  # 66 position channels > 64
    with pytest.raises(ValueError):
        rm.points_backward(fm, x, d, dsig[:10], drgb)
    with pytest.raises(ValueError):
        rm.points_backward(fm, x, d, dsig, drgb.t().contiguous().t())
    cpu = fr.prepare_fused_mlp(init_nerf_mlp(torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(ValueError):
        rm.points_forward(cpu, x, d)  # weights not packed on the card
    assert profiling.counter(rm.FWD_LAUNCHES) == 0 and profiling.counter(rm.BWD_LAUNCHES) == 0


@pytest.mark.cuda
def test_point_mlp_gradients_on_the_card(cuda_device):
    """``_PointsMLP`` on the card (through ``nerf_mlp_kernel_apply``) gives
    the plain backward's gradients to the parameter tensors."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    params = init_nerf_mlp(g, device=cuda_device, gain=HE_GAIN)
    for leaf in fr.flatten_tree(params):
        leaf.requires_grad_(True)
    x, d = _points(3, 50 * 64, cuda_device)
    samples = (x * np.pi).reshape(50, 64, 3)
    direc = d.reshape(50, 64, 3)[:, 0]
    profiling.reset()
    sig, rgb = rm.nerf_mlp_kernel_apply(params, samples, direc, compute_dtype=torch.bfloat16)
    (sig.square().sum() + rgb.sum()).backward()
    fm = fr.prepare_fused_mlp(params, torch.bfloat16)
    xp = (samples / np.pi).reshape(-1, 3)
    dp = (direc / torch.linalg.norm(direc, dim=-1, keepdim=True))[:, None].expand(
        50, 64, 3).reshape(-1, 3)
    pw, pb = rm.points_backward_plain(fm, xp, dp, 2 * sig.detach().reshape(-1, 1),
                                      torch.ones_like(rgb).reshape(-1, 3))
    want = fr.flatten_tree(rm.unflatten_mlp_grads(pw, pb))
    got = [t.grad for t in fr.flatten_tree(params)]
    assert _bwd_ok(_bwd_errors(got, want), BWD_TOL[torch.bfloat16])
    assert _counts(rm.FWD_LAUNCHES, rm.BWD_LAUNCHES, fr.FWD_LAUNCHES) == (1, 1, 0)


def _probe_inputs(seed, g, p, dev):
    """Words with about half of the bits set and ``p`` indices over every
    cell of a G^3 grid, int32 on ``dev``."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, size=g ** 3 // 32, dtype=np.uint32).view(np.int32)
    lin = rng.integers(0, g ** 3, size=p, dtype=np.int32)
    lin[: g ** 3 // 32] = np.arange(0, g ** 3, 32) + rng.integers(0, 32, size=g ** 3 // 32)
    return torch.from_numpy(words).to(dev), torch.from_numpy(lin).to(dev)


# the plain probe with one fault each; the kernel's bits must differ from
# every one of them
PROBE_FAULTS = {
    "lin & 15": lambda w, lin: (w[(lin >> 5).long()] >> (lin & 15)) & 1,
    "lin >> 4 as the word": lambda w, lin: (w[(lin >> 4).long() % w.numel()] >> (lin & 31)) & 1,
    "bits reversed": lambda w, lin: (w[(lin >> 5).long()] >> (31 - (lin & 31))) & 1,
}


@pytest.mark.cuda
@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("p", [262144, 262143, 5])
def test_probe_kernel_matches_plain(cuda_device, g, p):
    """Identical bits at G=64 and G=128, at the main path's 4096 x 64
    probes (every word probed), a ragged count and a tiny one."""
    words, lin = _probe_inputs(g + p, g, max(p, g ** 3 // 32), cuda_device)
    lin = lin[:p].contiguous() if p < lin.numel() else lin
    got = op.probe_bits(words, lin)
    want = op.probe_bits_plain(words, lin)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == lin.shape
    assert torch.equal(got, want)
    assert p < 1000 or 0.4 < got.float().mean().item() < 0.6  # half of the bits set
    assert profiling.counter(op.LAUNCHES) == 1


@pytest.mark.cuda
def test_probe_kernel_shapes_unaligned_and_out_of_range(cuda_device):
    """Any shape of ``lin``; a view starting 4 bytes into its storage (the
    kernel's scalar path); indices outside the table give 0."""
    words, lin = _probe_inputs(3, 16, 4097, cuda_device)
    shaped = lin[:4096].reshape(64, 64)
    assert torch.equal(op.probe_bits(words, shaped), op.probe_bits_plain(words, shaped))
    unaligned = lin[1:]
    assert unaligned.data_ptr() % 16 != 0
    assert torch.equal(op.probe_bits(words, unaligned), op.probe_bits_plain(words, unaligned))
    full = torch.full((4,), -1, dtype=torch.int32, device=cuda_device)
    bad = torch.tensor([-1, -33, 0, 127, 128, 4096, 2 ** 31 - 1], dtype=torch.int32,
                       device=cuda_device)
    assert op.probe_bits(full, bad).tolist() == [0, 0, 1, 1, 0, 0, 0]
    assert profiling.counter(op.LAUNCHES) == 3


@pytest.mark.cuda
def test_probe_kernel_differs_from_faulty_plain_versions(cuda_device):
    words, lin = _probe_inputs(5, 64, 4096 * 64, cuda_device)
    got = op.probe_bits(words, lin)
    for name, fault in PROBE_FAULTS.items():
        mismatches = int((fault(words, lin) != got).sum())
        assert mismatches > 1000, name


@pytest.mark.cuda
def test_probe_kernel_rejects_bad_inputs(cuda_device):
    words, lin = _probe_inputs(6, 16, 256, cuda_device)
    for bad_words, bad_lin in ((words.long(), lin), (words, lin.long()), (words.cpu(), lin),
                               (words, lin.reshape(16, 16).t())):
        with pytest.raises(ValueError):
            op.probe_bits(bad_words, bad_lin)
    assert profiling.counter(op.LAUNCHES) == 0


def _sampler_inputs(seed, n, s, g, jitter, dev, floor=0.25):
    """The sampler's inputs at B = 64: words with about half of the bits
    set; rays from a camera 7 units out toward the box (their first bins
    outside it, weight 0), a quarter of them tuned so one bin midpoint lies
    within a few ulp of a cell boundary (the cell then depends on every
    rounding), the last sixteenth wholly outside (the uniform fallback);
    eps = 0 on every eighth ray (u on the grid's edges, where a right-sided
    search differs); frac with jitter."""
    cfg = occ.OccupancyConfig(resolution=g, num_bins=64, floor=floor, in_bin_jitter=jitter)
    consts = osk.bin_constants(cfg, 64, 2.0, 6.0)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, size=g ** 3 // 32, dtype=np.uint32).view(np.int32)
    eye = rng.normal(size=(n, 3))
    eye = 7.0 * eye / np.linalg.norm(eye, axis=1, keepdims=True)
    d = -eye / 7.0 + rng.normal(size=(n, 3)) * 0.15
    o, d = eye.astype(np.float32), d.astype(np.float32)
    tuned = np.arange(0, n, 4)
    b = rng.integers(0, 64, size=tuned.size)
    axis = rng.integers(0, 3, size=tuned.size)
    f = np.float32
    mids = f(consts.near) + (np.arange(64, dtype=f) + f(0.5)) * f(consts.width)
    edge = rng.integers(1, g, size=tuned.size) / np.float64(consts.scale) - consts.bound
    o[tuned, axis] = (edge - np.float64(mids[b]) * d[tuned, axis]).astype(f)
    o[n - max(1, n // 16):] += 20.0
    eps = rng.random((n, 1)).astype(f)
    eps[::8] = 0.0
    frac = rng.random((n, s)).astype(f) if jitter else None
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa: E731
    return cfg, t(words), t(o), t(d), t(eps), t(frac)


def _fma_bin_cells(o_rays, d_rays, cfg, num_bins, near, far):
    """``bin_cells`` with ``o + mid * d`` rounded once, as an FMA would."""
    g = cfg.resolution
    width = (far - near) / num_bins
    mids = near + (torch.arange(num_bins, dtype=torch.float32, device=o_rays.device) + 0.5) * width
    pos = (o_rays.double()[:, None, :] + mids.double()[None, :, None]
           * d_rays.double()[:, None, :]).float()
    v = torch.floor((pos + cfg.bound) * (g / (2.0 * cfg.bound))).to(torch.int32)
    inside = torch.all((v >= 0) & (v < g), dim=-1)
    vc = torch.clamp(v, 0, g - 1)
    return ((vc[..., 0] * g + vc[..., 1]) * g + vc[..., 2]).contiguous(), inside


# the plain sampler with one fault each (module attribute, replacement);
# the kernel must differ from every one of them
SAMPLER_FAULTS = {
    "FMA-contracted cell positions": (occ, "bin_cells", _fma_bin_cells),
    "searchsorted right": (torch, "searchsorted",
                           lambda a, v, right=False, _f=torch.searchsorted: _f(a, v, right=True)),
    "no uniform fallback": (occ, "uniform_fallback", lambda w: w),
    "no sort": (torch, "sort", lambda t, dim: SimpleNamespace(values=t)),
    "bits reversed in the word": (
        op, "probe_bits_plain",
        lambda w, lin: ((w[(lin >> 5).long()] >> (31 - (lin & 31))) & 1).to(torch.int32)),
}


def _plain_sample(cfg, words, o, d, eps, frac, s):
    return occ.occupancy_sample_plain(words, o, d, eps, frac, cfg, s, 2.0, 6.0)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("n", [4096, 4095, 5])
def test_sampler_kernel_matches_plain(cuda_device, n, s, jitter, g):
    """Weights, ts and samples identical to the plain version on the card at
    floor 0.25 (every CDF prefix exact in float), in one launch."""
    cfg, words, o, d, eps, frac = _sampler_inputs(n + s + g, n, s, g, jitter, cuda_device)
    got_s, got_t, got_w = occ.occupancy_sample(words, o, d, eps, frac, cfg, s, 2.0, 6.0,
                                               with_weights=True)
    want_s, want_t, want_w = _plain_sample(cfg, words, o, d, eps, frac, s)
    torch.cuda.synchronize()
    assert profiling.counter(osk.LAUNCHES) == 1 and profiling.counter(op.LAUNCHES) == 0
    assert got_t.shape == (n, s, 1) and got_s.shape == (n, s, 3) and got_w.shape == (n, 64)
    assert torch.equal(got_w, want_w) and torch.equal(got_t, want_t)
    assert torch.equal(got_s, want_s)
    assert set(want_w.unique().tolist()) == {0.0, 0.25, 1.0}


def _bins(weights, eps, s):
    """Each sample's clamped bin, as the plain version finds it, on the
    weights' device."""
    cdf = torch.cumsum(weights, dim=1)
    cdf = cdf / (cdf[:, -1:] + 1e-10)
    u = torch.arange(s, dtype=torch.float32, device=weights.device)[None, :] / s + eps / s
    return torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous()),
                       max=weights.shape[1] - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("s", [16, 64])
def test_sampler_kernel_at_a_floor_not_exact_in_binary(cuda_device, s, jitter):
    """At floor 0.1 the kernel's CDF (the exact prefix sums, rounded once)
    is the CPU cumsum's: the kernel equals the plain version on the CPU bit
    for bit. The plain version on the card sums in float32, so some CDF
    values are an ulp apart and a u within that of an edge takes the next
    bin; the eps = 0 rays put u on exact fractions (s / S), where an exact
    CDF value often lies. The share of samples whose bin differs from the
    card's plain version is bounded: at most 5 in 1000 (chip_smoke.py's
    inputs on an H100: 7.2e-4 and 9.3e-4)."""
    cfg, words, o, d, eps, frac = _sampler_inputs(7 + s, 4096, s, 64, jitter, cuda_device,
                                                  floor=0.1)
    got_s, got_t, got_w = occ.occupancy_sample(words, o, d, eps, frac, cfg, s, 2.0, 6.0,
                                               with_weights=True)
    cpu = [None if a is None else a.cpu() for a in (words, o, d, eps, frac)]
    want_s, want_t, want_w = _plain_sample(cfg, *cpu, s)
    assert torch.equal(got_w.cpu(), want_w) and torch.equal(got_t.cpu(), want_t)
    assert torch.equal(got_s.cpu(), want_s)
    moved = (_bins(got_w, eps, s).cpu() != _bins(want_w, cpu[3], s)).float().mean().item()
    assert moved <= 5e-3, moved


@pytest.mark.cuda
def test_sampler_weights_and_hook_on_the_card(cuda_device):
    """``query_bin_weights`` on a CUDA tensor is one launch (the weights
    alone); the hook draws eps then frac from its generator and launches
    once, giving the plain version's samples on those draws."""
    cfg, words, o, d, _, _ = _sampler_inputs(3, 4096, 16, 64, True, cuda_device)
    got = occ.query_bin_weights(words, o, d, cfg, 64, 2.0, 6.0)
    assert profiling.counter(osk.LAUNCHES) == 1
    assert torch.equal(got, occ.query_bin_weights_plain(words, o, d, cfg, 64, 2.0, 6.0))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    samples, ts = occ.make_occupancy_sampler(words, cfg)(o, d, 16, 2.0, 6.0, generator=gen)
    assert profiling.counter(osk.LAUNCHES) == 2 and profiling.counter(op.LAUNCHES) == 0
    again = torch.Generator(device=cuda_device).manual_seed(5)
    eps = torch.rand((4096, 1), generator=again, device=cuda_device)
    frac = torch.rand((4096, 16), generator=again, device=cuda_device)
    want_s, want_t, _ = _plain_sample(cfg, words, o, d, eps, frac, 16)
    assert torch.equal(ts, want_t) and torch.equal(samples, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(SAMPLER_FAULTS))
def test_sampler_kernel_differs_from_faulty_plain_versions(cuda_device, monkeypatch, fault):
    cfg, words, o, d, eps, frac = _sampler_inputs(11, 4096, 16, 64, True, cuda_device)
    got_s, got_t, got_w = occ.occupancy_sample(words, o, d, eps, frac, cfg, 16, 2.0, 6.0,
                                               with_weights=True)
    module, name, faulty = SAMPLER_FAULTS[fault]
    monkeypatch.setattr(module, name, faulty)
    want_s, want_t, want_w = _plain_sample(cfg, words, o, d, eps, frac, 16)
    mismatches = int((got_t != want_t).sum()) + int((got_w != want_w).sum())
    assert mismatches > 0, fault


@pytest.mark.cuda
def test_sampler_kernel_rejects_bad_inputs(cuda_device):
    cfg, words, o, d, eps, frac = _sampler_inputs(2, 64, 16, 64, True, cuda_device)
    consts = osk.bin_constants(cfg, 64, 2.0, 6.0)
    bad = [dict(words=words.long()), dict(words=words.cpu()), dict(o=o.double()),
           dict(d=d.t().contiguous().t()), dict(eps=eps[:, 0]), dict(frac=frac[:, :8]),
           dict(consts=consts._replace(num_bins=257)), dict(s=257, frac=None)]
    for change in bad:
        a = dict(words=words, o=o, d=d, eps=eps, frac=frac, consts=consts, s=16)
        a.update(change)
        with pytest.raises(ValueError):
            osk.sample(a["words"], a["o"], a["d"], a["eps"], a["frac"], a["consts"], a["s"])
    assert profiling.counter(osk.LAUNCHES) == 0


# ------------------------------------------------- several steps per call

# one call's steps in the card's multi-step tests: a capture (after one
# eager warm-up step) and replays in the first call, replays only in the next
MULTI_STEPS = 4
# the cases of the multi-step tests: (NeRFConfig, TrainConfig) keywords. The
# crop ends at step 3 (one cropping epoch of 3 frames); under occupancy the
# grid is updated every 3 steps, between replays, and the warmup ends at 5
MULTI_CASES = {"fused": ({}, {}), "pallas": ({}, dict(kernel="pallas")),
               "xla": ({}, dict(kernel="xla")),
               "fast": (dict(coarse_samples=16, fine_samples=48),
                        dict(occupancy=True, occ_update_every=3, occ_warmup_steps=5))}


def _multi_setup(dev, case):
    """A 3-frame 64x64 procedural scene made on the card; full widths, bf16,
    1024 rays; the seeded init with density bias +0.5; the case's hooks."""
    from minimal_nerf_torch.data.procedural import make_procedural_scene
    from minimal_nerf_torch.models.nerf import NeRFConfig, init_nerf_network
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.config import TrainConfig

    nerf_kw, train_kw = MULTI_CASES[case]
    cfg = NeRFConfig(**nerf_kw)
    tcfg = TrainConfig(num_rays=1024, cropping_epochs=1, **train_kw)
    scene = make_procedural_scene((("train", 3),), height=64, width=64, gt_samples=64,
                                  scene="object", device=dev)[0]["train"]

    def state():
        params = init_nerf_network(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        for mlp in params.values():
            mlp["density"]["b"] += 0.5
        occ_cfg = tcfg.occupancy_config
        return [params, loop.adam_init(params),
                occ.init_grid(occ_cfg, dev) if occ_cfg is not None else None]

    return cfg, tcfg, scene, state, loop.kernel_hooks(tcfg.kernel, dev)


def _call(fn, st, scene, step):
    """One call of a step function on ``st = [params, opt_state, grid]`` (in
    place); returns its metrics."""
    params, opt_state, grid = st
    if grid is None:
        st[0], st[1], metrics = fn(params, opt_state, scene.images, scene.poses, step, 0)
    else:
        st[0], st[1], st[2], metrics = fn(params, opt_state, grid, scene.images, scene.poses,
                                          step, 0)
    return metrics


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_multi_step_replays_equal_eager_steps(cuda_device, case):
    """Two calls of ``make_multi_step`` (the first: one eager step, the
    capture, replays; the second: replays only, with the device's syncs made
    errors) against as many eager steps: parameters, Adam moments, grid and
    the last metrics bit for bit. Between the calls a validation through the
    same render hooks packs the weights eagerly; after the replays it must
    see the replayed weights (the hooks' caches key on the versions the
    replays advance), as a fresh hook does."""
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    cfg, tcfg, scene, state, (mlp_apply, render_fn) = _multi_setup(cuda_device, case)
    static, occ_cfg = loop.scene_static(scene), tcfg.occupancy_config
    step_fn = loop.make_train_step(cfg, tcfg, static, render_fn, cuda_device, mlp_apply,
                                   occ_cfg)
    eager = state()
    for step in range(2 * MULTI_STEPS):
        eager_metrics = _call(step_fn, eager, scene, step)

    multi_fn = loop.make_multi_step(cfg, tcfg, static, MULTI_STEPS, render_fn, cuda_device,
                                    mlp_apply, occ_cfg)
    eval_fn = loop.make_eval_step(cfg, tcfg, mlp_apply, render_fn, occ_cfg)
    batch = loop.sample_train_batch(0, scene.images, scene.poses, static, 256, 3, 0, 0,
                                    generator=torch.Generator(device=cuda_device).manual_seed(5))
    u = torch.Generator(device=cuda_device).manual_seed(6)
    rand = lambda *s: torch.rand(s, generator=u, device=cuda_device)  # noqa: E731
    uniforms = {"coarse": (rand(256, 1), rand(256, cfg.coarse_samples)) if occ_cfg
                else rand(256, cfg.coarse_samples), "eps": rand(256, 1),
                "jitter": rand(256, cfg.fine_samples, 1)}
    words = occ.pack_occupancy(eager[2], occ_cfg) if occ_cfg else None
    evaluate = lambda fn, params: fn(params, batch["origin"], batch["direc"],  # noqa: E731
                                     batch["rgb"], occ_words=words, uniforms=uniforms)

    multi = state()
    _call(multi_fn, multi, scene, 0)
    evaluate(eval_fn, multi[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        multi_metrics = _call(multi_fn, multi, scene, MULTI_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    assert multi[1]["count"] == eager[1]["count"] == 2 * MULTI_STEPS
    for a, b in zip(flatten_tree([eager[0], eager[1]["mu"], eager[1]["nu"], eager[2]]),
                    flatten_tree([multi[0], multi[1]["mu"], multi[1]["nu"], multi[2]])):
        assert (a is None and b is None) or torch.equal(a, b)
    assert eager_metrics.keys() == multi_metrics.keys()
    for k in eager_metrics:
        assert torch.equal(eager_metrics[k].cpu(), multi_metrics[k].cpu()), k
    fresh = loop.make_eval_step(cfg, tcfg, *loop.kernel_hooks(tcfg.kernel, cuda_device),
                                occ_cfg)
    again, want = evaluate(eval_fn, multi[0]), evaluate(fresh, multi[0])
    assert all(torch.equal(again[k], want[k]) for k in want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fused", "fast"])
def test_multi_step_replays_count_their_launches(cuda_device, case):
    """A first ``make_multi_step`` call of 20 steps (one eager step, the
    capture, 19 replays) counts 19 ``graph.replays`` and the launches of 21
    eager steps; a second call adds 20 replays and 20 steps' launches."""
    from minimal_nerf_torch.training import loop

    cfg, tcfg, scene, state, (mlp_apply, render_fn) = _multi_setup(cuda_device, case)
    static, occ_cfg = loop.scene_static(scene), tcfg.occupancy_config
    step_fn = loop.make_train_step(cfg, tcfg, static, render_fn, cuda_device, mlp_apply,
                                   occ_cfg)
    _call(step_fn, state(), scene, 10)
    per_step = profiling.counters()
    assert per_step and all(name.endswith(".launches") for name in per_step)
    multi_fn = loop.make_multi_step(cfg, tcfg, static, 20, render_fn, cuda_device, mlp_apply,
                                    occ_cfg)
    multi = state()
    for start, steps, replays in ((0, 21, 19), (20, 20, 20)):
        profiling.reset()
        _call(multi_fn, multi, scene, start)
        want = {name: steps * n for name, n in per_step.items()}
        assert profiling.counters() == dict(want, **{"graph.replays": replays})


@pytest.mark.cuda
def test_adam_apply_on_the_card_equals_the_update_on_python_floats(cuda_device):
    """The Adam update on device scalars equals, bit for bit, the one with
    the LR and bias corrections as Python floats (which torch applies to a
    CUDA tensor as products with their fp32 reciprocals)."""
    from minimal_nerf_torch.training import loop

    g = torch.Generator(device=cuda_device).manual_seed(0)
    shapes = [(256, 256), (63,), (3, 128)]
    params = [torch.randn(s, generator=g, device=cuda_device) for s in shapes]
    ref = [p.clone() for p in params]
    state = loop.adam_init(params)
    mu, nu = [torch.zeros_like(p) for p in ref], [torch.zeros_like(p) for p in ref]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    for count in range(1, 6):
        grads = [torch.randn(s, generator=g, device=cuda_device) * 1e-3 for s in shapes]
        lr = f32(5e-4) * f32(0.9) ** count
        state = loop.adam_update(params, grads, state, lr)
        bc1, bc2 = float(1 - f32(0.9) ** count), float(1 - f32(0.999) ** count)
        for p, gr, m, v in zip(ref, grads, mu, nu):
            m.copy_(0.1 * gr + 0.9 * m)
            v.copy_((1 - 0.999) * (gr * gr) + 0.999 * v)
            p.add_(-float(lr) * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8)))
        for a, b in zip(params, ref):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("context", ["--profile", "--debug-nans"])
def test_multi_step_under_the_train_cli_contexts(cuda_device, context, tmp_path):
    """A call of ``make_multi_step``, its capture included, inside the
    context ``train.py`` enters for ``--profile`` (a ``torch.profiler``
    trace) or ``--debug-nans`` (autograd's anomaly mode, which the capture
    turns off) gives the state of the same call outside it, bit for bit."""
    from minimal_nerf_torch.kernels.fused_raymarch import make_fused_render_fn
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    cfg, tcfg, scene, state, _ = _multi_setup(cuda_device, "fused")
    static = loop.scene_static(scene)
    make = lambda: loop.make_multi_step(cfg, tcfg, static, MULTI_STEPS,  # noqa: E731
                                        render_fn=make_fused_render_fn(), device=cuda_device)
    plain = state()
    _call(make(), plain, scene, 0)
    inside = state()
    with (profiling.trace(tmp_path) if context == "--profile" else profiling.debug_mode()):
        _call(make(), inside, scene, 0)
    for a, b in zip(flatten_tree([plain[0], plain[1]["mu"], plain[1]["nu"]]),
                    flatten_tree([inside[0], inside[1]["mu"], inside[1]["nu"]])):
        assert torch.equal(a, b)
    if context == "--profile":
        assert len(list(tmp_path.glob("trace-*.json"))) == 1


# ------------------------------------------- the single mode and path parity

# [train-pallas]'s gate in chip_smoke.py (PATH_GRAD_TOL): every leaf's
# relative L2 gap between the fused and the pallas path's bf16 gradients at
# shared parameters. H100 readings (4096 rays, 64+128): worst leaf 2.0e-3
# over 8 shared points, 2.5e-4 at the init. In fp32 the one scalar leaf
# coarse/density/b came to 3.5e-4 at the init (a sum over every point that
# nearly cancels there), every other leaf under 6e-5
PATH_GRAD_TOL = {torch.bfloat16: 1e-2, None: 1e-3}


@pytest.mark.cuda
def test_single_step_through_the_point_kernels_matches_plain(cuda_device):
    """One ``mode="single"`` step of ``--kernel pallas`` on the card (the
    point kernels under ``render_single``, 256 rays x 128 samples, bf16,
    full widths) against the same step on the CPU (plain versions), on
    shared He weights, rays and draws: the loss within 1e-3, every
    gradient within the backward's bf16 bounds, one launch of each kernel."""
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training import loop

    cfg, n = NeRFConfig(coarse_samples=128), 256
    params = init_nerf_mlp(torch.Generator(device=cuda_device).manual_seed(3),
                           device=cuda_device, gain=HE_GAIN)
    o, d, _ = _inputs(7, n, 1, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    batch = {"origin": o, "direc": d, "rgb": torch.rand((n, 3), generator=g, device=cuda_device)}
    uniforms = {"coarse": torch.rand((n, 128), generator=g, device=cuda_device)}
    to_cpu = lambda tree: map_params(lambda t: t.detach().cpu(), tree)  # noqa: E731
    out = []
    for dev, p, b, u in ((cuda_device, map_params(lambda t: t.detach().clone(), params), batch,
                          uniforms), ("cpu", to_cpu(params), to_cpu(batch), to_cpu(uniforms))):
        mlp_apply, render_fn = loop.kernel_hooks("pallas", dev, mode="single")
        assert render_fn is None
        metrics, grads = loop.loss_and_grads(p, cfg, b, torch.bfloat16, uniforms=u,
                                             mlp_apply=mlp_apply, mode="single")
        out.append((metrics["train_loss"].item(), fr.flatten_tree(to_cpu(grads))))
    (card_loss, card_g), (cpu_loss, cpu_g) = out
    assert _counts(rm.FWD_LAUNCHES, rm.BWD_LAUNCHES, fr.FWD_LAUNCHES, fr.BWD_LAUNCHES) == (
        1, 1, 0, 0)
    assert abs(card_loss - cpu_loss) <= 1e-3 * cpu_loss
    assert _bwd_ok(_bwd_errors(card_g, cpu_g), BWD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, None])
def test_fused_and_pallas_paths_agree_at_the_init(cuda_device, dtype):
    """ROADMAP Queue 3 fault 2, step 0: one train step's gradients through
    the fused kernels and through the point kernels at the same seeded init
    (full widths, 64+128, 1024 rays of a procedural scene, the step's own
    draws): every leaf's relative L2 gap within ``PATH_GRAD_TOL``; a
    gradient taken one Adam step late (the packing a stale cache would
    give) fails the bf16 bound."""
    from minimal_nerf_torch.data.procedural import make_procedural_scene
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.nerf import NeRFConfig, init_nerf_network
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import unflatten_tree
    from minimal_nerf_torch.training.config import TrainConfig

    cfg = NeRFConfig()
    tcfg = TrainConfig(num_rays=1024, precision="bf16" if dtype else "fp32")
    scene = make_procedural_scene((("train", 3),), height=64, width=64, gt_samples=64,
                                  scene="object", device=cuda_device)[0]["train"]
    profiling.reset()
    static = loop.scene_static(scene)
    init = init_nerf_network(torch.Generator(device=cuda_device).manual_seed(0), cfg,
                             device=cuda_device)
    inp = loop.inputs_on_device([loop.draw_step_inputs(cfg, tcfg, static, 0, 0, 0,
                                                       cuda_device)], cuda_device)[0]
    batch = loop.ray_batch_from_arrays(inp["frame"], tcfg.num_rays, static.height, static.width,
                                       static.focal, scene.images, scene.poses,
                                       coords=(inp["xs"], inp["ys"]))

    def grads(kernel, params):
        mlp_apply, render_fn = loop.kernel_hooks(kernel, cuda_device)
        _, g = loop.loss_and_grads(map_params(lambda t: t.detach().clone(), params), cfg,
                                   batch, tcfg.compute_dtype, render_fn,
                                   uniforms=inp["uniforms"], mlp_apply=mlp_apply)
        return fr.flatten_tree(g)

    def gap(a, b):
        return max((torch.linalg.norm(x - y) / torch.linalg.norm(x)).item()
                   for x, y in zip(a, b))

    fused = grads("fused", init)
    assert gap(fused, grads("pallas", init)) <= PATH_GRAD_TOL[dtype]
    assert _counts(fr.FWD_LAUNCHES, fr.BWD_LAUNCHES, rm.FWD_LAUNCHES, rm.BWD_LAUNCHES) == (
        2, 2, 2, 2)
    if dtype is not None:
        moved = map_params(lambda t: t.detach().clone(), init)
        loop.adam_update(moved, unflatten_tree(init, fused), loop.adam_init(moved), 5e-4)
        assert gap(fused, grads("pallas", moved)) > PATH_GRAD_TOL[dtype]
