"""The port's point-level MLP pass (``--kernel pallas``) against the JAX
kernels ``_nerf_mlp_kernel`` / ``_nerf_mlp_bwd_kernel`` in interpret mode,
and the plain render around it against JAX ``render_rays`` with the Pallas
MLP hook.

On the CPU the wrappers run the plain PyTorch versions; the CUDA kernels are
held against those plain versions by ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py`` on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimal_nerf_torch.kernels import fused_raymarch as t_fused
from minimal_nerf_torch.kernels import raymarch as t_rm
from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops.encoding import positional_encoding
from minimal_nerf_torch.training.checkpoint import flatten_tree
from minimal_nerf_tpu.kernels import raymarch as j_rm
from minimal_nerf_tpu.models import mlp as j_mlp
from minimal_nerf_tpu.models import nerf as j_nerf

TILE = 64  # the JAX kernels' tile in interpret mode (tests/test_kernels.py)
# fp32 forward, at position_dim 4: JAX's own bound for its kernel against
# the plain MLP (tests/test_kernels.py:34). Both sides round nowhere; only
# the order of fp32 sums differs (measured <= 1.2e-6 absolute). At 10
# octaves XLA's and torch's fp32 sin/cos differ by a few ulp at angles up to
# 512*pi, so fp32 is held at 4 octaves.
FWD_FP32_TOL = dict(rtol=2e-5, atol=1e-6)
# bf16 forward, default dims: both sides round x, d, the encodings and every
# matmul operand to bf16 at the same points; only a different fp32 sum order
# could move a value across a bf16 rounding boundary (relative step 2^-8).
# Measured <= 1.2e-7 absolute over 3 seeds; the bound keeps ~80x of margin
# and sits far below the effect of dropping a rounding point, which the
# test asserts.
FWD_BF16_TOL = dict(rtol=1e-4, atol=1e-5)
# Gradients per leaf, relative to the leaf's max |g| (as
# tests/test_torch_fused_raymarch.py). fp32 at 4 octaves: sum orders only,
# measured <= 5.4e-6 over 4 seeds. bf16 at 10 octaves: the same rounding
# points on both sides, measured <= 5.1e-7, and once 3.4e-4 where a bf16
# rounding of an activation flipped; a backward that sums the ROUNDED
# gradients into the biases (the fused backward's rounding points) is off
# by >= 2.1e-3 on the biases, which the bf16 test asserts fails the bound.
BWD_FP32_RTOL = 5e-5
BWD_BF16_RTOL = 1e-3
HE_GAIN = np.sqrt(6.0)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _he(jp):
    """A JAX params tree as numpy arrays with He-uniform weights (bound
    sqrt(6/fan_in)): the outputs depend on the input."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, np.float32) * (HE_GAIN if path[-1].key == "w" else 1.0),
        jax.device_get(jp))


def _mlp(seed, pd, dd):
    jp = _he(j_mlp.init_nerf_mlp(jax.random.PRNGKey(seed), position_dim=pd, direction_dim=dd,
                                 width=64, rgb_width=32))
    return jp, t_mlp.params_from_jax(jp, "cpu")


def _dims(precision):
    return ((4, 2), None, None) if precision == "fp32" else ((10, 4), jnp.bfloat16,
                                                               torch.bfloat16)


def _samples(seed, n, s):
    rng = np.random.default_rng(seed)
    samples = rng.uniform(-3.0, 3.0, size=(n, s, 3)).astype(np.float32)
    direc = rng.normal(size=(n, 3)).astype(np.float32)
    return samples, direc


def _leaf_errors(ref, got):
    return [float(np.abs(np.asarray(a) - np.asarray(b)).max()
                  / (np.abs(np.asarray(a)).max() + 1e-12)) for a, b in zip(ref, got)]


@pytest.fixture(autouse=True)
def _reset_launches():
    t_rm.launches = t_rm.bwd_launches = 0
    yield
    assert t_rm.launches == 0 and t_rm.bwd_launches == 0  # CPU tensors never launch


def _jax_apply(jp, samples, direc, pd, dd, jdtype):
    return j_rm.nerf_mlp_pallas_apply(jax.tree_util.tree_map(jnp.asarray, jp),
                                      jnp.asarray(samples), jnp.asarray(direc), pd, dd,
                                      compute_dtype=jdtype, tile=TILE, interpret=True)


@pytest.mark.parametrize("n,s", [(8, 16), (5, 7)])  # P = 128 and 35 (no whole tile)
def test_point_forward_fp32_matches_jax(n, s):
    jp, tp = _mlp(0, 4, 2)
    samples, direc = _samples(1, n, s)
    js, jrgb = _jax_apply(jp, samples, direc, 4, 2, None)
    ts, trgb = t_rm.nerf_mlp_kernel_apply(tp, T(samples), T(direc), 4, 2)
    assert ts.shape == (n, s, 1) and trgb.shape == (n, s, 3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **FWD_FP32_TOL)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), **FWD_FP32_TOL)


def test_point_forward_bf16_matches_jax(monkeypatch):
    jp, tp = _mlp(1, 10, 4)
    samples, direc = _samples(2, 5, 7)
    js, jrgb = _jax_apply(jp, samples, direc, 10, 4, jnp.bfloat16)
    ts, trgb = t_rm.nerf_mlp_kernel_apply(tp, T(samples), T(direc), 10, 4, torch.bfloat16)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **FWD_BF16_TOL)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), **FWD_BF16_TOL)
    # the bound separates the precisions: the outputs spread far wider than
    # it, and a pass without the bf16 rounding points fails it, be it the
    # fp32 pass or one that encodes x and d unrounded
    assert np.asarray(js).std() > 1e3 * FWD_BF16_TOL["atol"]
    assert np.asarray(jrgb).std() > 1e3 * FWD_BF16_TOL["atol"]
    f32 = t_rm.nerf_mlp_kernel_apply(tp, T(samples), T(direc), 10, 4)
    monkeypatch.setattr(t_fused, "_encode", lambda x, dim, dtype: t_mlp.round_to(
        positional_encoding(x, dim), dtype))
    unrounded_x = t_rm.nerf_mlp_kernel_apply(tp, T(samples), T(direc), 10, 4, torch.bfloat16)
    for sig, rgb in (f32, unrounded_x):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(sig.numpy(), np.asarray(js), **FWD_BF16_TOL)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **FWD_BF16_TOL)


def _bwd_case(seed, p, pd, dd):
    jp, tp = _mlp(seed, pd, dd)
    rng = np.random.default_rng(seed + 1)
    x = (rng.uniform(-3.0, 3.0, size=(p, 3)) / np.pi).astype(np.float32)
    d = rng.normal(size=(p, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dsig = rng.normal(size=(p, 1)).astype(np.float32)
    drgb = rng.normal(size=(p, 3)).astype(np.float32)
    return jp, tp, (x, d, dsig, drgb)


def _jax_backward(jp, x, d, dsig, drgb, pd, dd, jdtype):
    """``_pallas_points_backward`` on the points padded to whole tiles as
    ``nerf_mlp_pallas_apply`` pads them (zero cotangents on the padding)."""
    pad = (-x.shape[0]) % TILE
    zpad = lambda a, fill=0.0: np.concatenate(  # noqa: E731
        [a, np.full((pad, a.shape[1]), fill, np.float32)])
    ws_bs = j_rm.flatten_mlp_params(jax.tree_util.tree_map(jnp.asarray, jp), jdtype)
    gws, gbs = j_rm._pallas_points_backward(
        ws_bs, *map(jnp.asarray, (zpad(x), zpad(d, 1.0), zpad(dsig), zpad(drgb))), pd, dd,
        compute_dtype=jdtype, tile=TILE, interpret=True)
    return list(gws) + list(gbs)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_point_backward_matches_jax(monkeypatch, precision):
    (pd, dd), jdtype, tdtype = _dims(precision)
    rtol = BWD_FP32_RTOL if precision == "fp32" else BWD_BF16_RTOL
    jp, tp, (x, d, dsig, drgb) = _bwd_case(3, 150, pd, dd)
    ref = _jax_backward(jp, x, d, dsig, drgb, pd, dd, jdtype)
    fm = t_fused.prepare_fused_mlp(tp, tdtype)
    args = (fm, T(x), T(d), T(dsig), T(drgb), pd, dd)
    gws, gbs = t_rm.points_backward(*args)
    assert [tuple(g.shape) for g in gws + gbs] == [tuple(np.shape(r)) for r in ref]
    assert min(np.abs(np.asarray(r)).max() for r in ref) > 1e-2  # every leaf has signal
    assert max(_leaf_errors(ref, gws + gbs)) < rtol
    if precision == "bf16":
        # the fused backward's rounding points (bias sums of the rounded
        # gradients) are told apart from the point kernel's
        monkeypatch.setattr(t_rm, "_bias_sum", lambda g: torch.sum(
            t_mlp.round_to(g, torch.bfloat16), dim=0, keepdim=True))
        gws, gbs = t_rm.points_backward(*args)
        assert max(_leaf_errors(ref[12:], gbs)) > rtol


def test_point_backward_equals_autograd_of_plain_forward():
    """fp32: the hand-derived backward equals autograd through the plain
    forward (same torch ops; bound 1e-5 of the leaf's max)."""
    _, tp, (x, d, dsig, drgb) = _bwd_case(4, 70, 10, 4)
    fm = t_fused.prepare_fused_mlp(tp)
    ws = [w.clone().requires_grad_() for w in fm.ws]
    bs = [b.clone().requires_grad_() for b in fm.bs]
    sig, rgb = t_rm.points_forward_plain(fm._replace(ws=ws, bs=bs), T(x), T(d))
    ref = torch.autograd.grad((sig * T(dsig)).sum() + (rgb * T(drgb)).sum(), ws + bs)
    gws, gbs = t_rm.points_backward_plain(fm, T(x), T(d), T(dsig), T(drgb))
    assert max(_leaf_errors([r.numpy() for r in ref], gws + gbs)) < 1e-5


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_point_apply_grad_matches_jax(precision):
    """``jax.grad`` through ``nerf_mlp_pallas_apply_diff`` against autograd
    through ``nerf_mlp_kernel_apply`` (tests/test_kernels_vjp.py:28-57)."""
    (pd, dd), jdtype, tdtype = _dims(precision)
    jp, tp = _mlp(5, pd, dd)
    samples, direc = _samples(6, 6, 9)
    rng = np.random.default_rng(7)
    t_sig = rng.uniform(size=(6, 9, 1)).astype(np.float32)
    t_rgb = rng.uniform(size=(6, 9, 3)).astype(np.float32)

    def j_loss(p):
        sig, rgb = j_rm.nerf_mlp_pallas_apply_diff(p, jnp.asarray(samples), jnp.asarray(direc),
                                                   pd, dd, compute_dtype=jdtype, tile=TILE,
                                                   interpret=True)
        return jnp.mean((sig - t_sig) ** 2) + jnp.mean((rgb - t_rgb) ** 2)

    j_l, j_g = jax.value_and_grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, jp))
    for leaf in flatten_tree(tp):
        leaf.requires_grad_()
    sig, rgb = t_rm.nerf_mlp_kernel_apply(tp, T(samples), T(direc), pd, dd, tdtype)
    loss = ((sig - T(t_sig)) ** 2).mean() + ((rgb - T(t_rgb)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_l), rtol=1e-5)
    got = [t.grad.numpy() for t in flatten_tree(tp)]
    rtol = BWD_FP32_RTOL if precision == "fp32" else BWD_BF16_RTOL
    assert max(_leaf_errors(flatten_tree(jax.device_get(j_g)), got)) < rtol


def _jax_draws(key, n, cfg):
    """The uniforms JAX ``render_rays`` draws from ``key``."""
    k_coarse, k_cdf = jax.random.split(key)
    k_eps, k_jit = jax.random.split(k_cdf)
    u = lambda k, shape: T(jax.random.uniform(k, shape, dtype=jnp.float32))  # noqa: E731
    return {"coarse": u(k_coarse, (n, cfg.coarse_samples)), "eps": u(k_eps, (n, 1)),
            "jitter": u(k_jit, (n, cfg.fine_samples, 1))}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_render_rays_with_point_hook_matches_jax(precision):
    """The plain render around the point MLP hook, with the density stats,
    against JAX ``render_rays`` with ``make_pallas_mlp_apply``."""
    (pd, dd), jdtype, tdtype = _dims(precision)
    jcfg = j_nerf.NeRFConfig(position_dim=pd, direction_dim=dd, coarse_samples=8,
                             fine_samples=8)
    tcfg = t_nerf.NeRFConfig(**jcfg.to_dict())
    # seed 13: both MLPs give some zero and some positive densities here
    keys = jax.random.split(jax.random.PRNGKey(13))
    jp = {k: _he(j_mlp.init_nerf_mlp(key, pd, dd, width=64, rgb_width=32))
          for k, key in zip(("coarse", "fine"), keys)}
    rng = np.random.default_rng(9)
    o = (rng.normal(size=(8, 3)) * 0.3).astype(np.float32)
    d = (rng.normal(size=(8, 3)) - [0.0, 0.0, 2.0]).astype(np.float32)
    key = jax.random.PRNGKey(10)
    ref = j_nerf.render_rays(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, jnp.asarray(o),
                             jnp.asarray(d), key, compute_dtype=jdtype,
                             mlp_apply=j_rm.make_pallas_mlp_apply(tile=TILE, interpret=True),
                             return_stats=True)
    out = t_nerf.render_rays(t_mlp.params_from_jax(jp, "cpu"), tcfg, T(o), T(d),
                             compute_dtype=tdtype, mlp_apply=t_rm.make_mlp_kernel_apply(),
                             uniforms=_jax_draws(key, 8, jcfg), return_stats=True)
    assert set(out) == set(ref)
    # colors: the forward bounds above; the stats sum 64 / 128 points'
    # squared densities and count the non-zero ones
    tol = FWD_FP32_TOL if precision == "fp32" else FWD_BF16_TOL
    for k in ("coarse_rgb_rays", "fine_rgb_rays"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **tol)
    for name in ("coarse", "fine"):
        np.testing.assert_allclose(float(out[f"{name}_density_sumsq"]),
                                   float(ref[f"{name}_density_sumsq"]), rtol=1e-5)
        assert float(out[f"{name}_density_non_zeros"]) == float(
            ref[f"{name}_density_non_zeros"]) > 0


def test_mlp_hook_packs_once_per_parameter_state(monkeypatch):
    """The hook packs each MLP once per state of its parameters: the coarse
    and fine MLPs alternate without repacking, and an in-place update of a
    leaf repacks that MLP only."""
    cfg = t_nerf.NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=4, fine_samples=4)
    params = t_nerf.init_nerf_network(torch.Generator().manual_seed(0), cfg, device="cpu")
    for mlp in params.values():
        mlp["density"]["b"] += 0.5  # densities above 0, so the colors show
    packed = []
    orig = t_fused.prepare_fused_mlp
    monkeypatch.setattr(t_fused, "prepare_fused_mlp",
                        lambda p, dtype=None: packed.append(id(p)) or orig(p, dtype))
    hook = t_rm.make_mlp_kernel_apply()
    o, d = torch.zeros(3, 3), torch.tensor([[0.0, 0.0, -1.0]] * 3)
    draws = {"coarse": torch.full((3, 4), 0.5), "eps": torch.full((3, 1), 0.5),
             "jitter": torch.full((3, 4, 1), 0.5)}
    render = lambda: t_nerf.render_rays(params, cfg, o + 4.0, d, mlp_apply=hook,  # noqa: E731
                                        uniforms=draws)["fine_rgb_rays"]
    first = render()
    assert torch.equal(render(), first)
    assert packed == [id(params["coarse"]), id(params["fine"])]
    with torch.no_grad():
        params["fine"]["rgb"][1]["b"] += 1.0
    after = render()
    assert packed[2:] == [id(params["fine"])] and not torch.equal(after, first)
    fresh = t_nerf.render_rays(params, cfg, o + 4.0, d, mlp_apply=t_rm.nerf_mlp_kernel_apply,
                               uniforms=draws)["fine_rgb_rays"]
    assert torch.equal(after, fresh)


def test_flatten_round_trip_and_unsupported_device():
    _, tp = _mlp(0, 4, 2)
    ws, bs = t_rm.flatten_mlp_params(tp)
    back = t_rm.unflatten_mlp_grads(ws, bs)
    for a, b in zip(flatten_tree(back), flatten_tree(tp)):
        assert torch.equal(a, b)
    fm = t_fused.prepare_fused_mlp(tp)
    x = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError):
        t_rm.points_forward(fm, x, x, 4, 2)
    with pytest.raises(ValueError):
        t_rm.points_backward(fm, x, x, torch.zeros(4, 1, device="meta"),
                             torch.zeros(4, 3, device="meta"), 4, 2)
