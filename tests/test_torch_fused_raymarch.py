"""The port's fused ray-march pass against the JAX kernel (interpret mode),
and the whole render slice against JAX ``render_rays_fused``.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel is
held against that plain version by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimal_nerf_torch.kernels import fused_raymarch as t_fused
from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops.encoding import positional_encoding
from minimal_nerf_torch.utils import profiling
from minimal_nerf_tpu.kernels import fused_raymarch as j_fused
from minimal_nerf_tpu.models import mlp as j_mlp
from minimal_nerf_tpu.models import nerf as j_nerf

# fp32: both sides compute the same rounding points in fp32; only the order
# of the matmul/scan sums differs (tolerance of tests/test_fused_raymarch.py)
FP32_TOL = dict(rtol=3e-5, atol=1e-6)
# bf16: both sides round x, the encodings and every activation to bf16 at
# the same points; only a different fp32 summation order could move a
# pre-activation across a bf16 rounding boundary (relative step 2^-8). At
# these sizes the two agree to <= 2.5e-6 absolute; the bound keeps 4x of
# margin above that and stays 1e3x below the effect of dropping any one
# bf16 rounding point, which the bf16 test asserts.
BF16_TOL = dict(rtol=1e-4, atol=1e-5)
# He-uniform weights (bound sqrt(6/fan_in)): the activations keep their
# scale through the ReLU layers, so colors and weights depend on the input
# and a wrong layer or rounding point shows in the outputs. (The fp32 tests
# keep the nn.Linear-style init: with He weights the highest encoding
# frequencies turn fp32 rounding of x into differences above FP32_TOL.)
HE_GAIN = np.sqrt(6.0)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _scaled(jp, gain):
    """A JAX params tree as numpy arrays, weights scaled by ``gain``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, np.float32) * (gain if path[-1].key == "w" else 1.0),
        jax.device_get(jp))


def _mlp(seed=0, width=64, rgb_width=32, gain=1.0):
    jp = _scaled(j_mlp.init_nerf_mlp(jax.random.PRNGKey(seed), width=width,
                                     rgb_width=rgb_width), gain)
    return jp, t_mlp.params_from_jax(jp, "cpu")


def _inputs(seed, n, s):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = (rng.normal(size=(n, 3)) - [0.0, 0.0, 2.0]).astype(np.float32)
    ts = np.sort(rng.uniform(2.0, 6.0, size=(n, s)), axis=1).astype(np.float32)
    return o, d, ts


@pytest.fixture(autouse=True)
def _reset_launches():
    profiling.reset()
    yield


@pytest.mark.parametrize("n,s", [(8, 16), (10, 7)])
def test_plain_pass_fp32_matches_jax(n, s):
    jp, tp = _mlp()
    o, d, ts = _inputs(1, n, s)
    jc, jw = j_fused.fused_render_pass(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts),
                                       ray_tile=8, interpret=True)
    tc, tw = t_fused.fused_render_pass(tp, T(o), T(d), T(ts))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **FP32_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **FP32_TOL)
    assert profiling.counter(t_fused.FWD_LAUNCHES) == 0  # CPU tensors never launch the kernel


def test_plain_pass_bf16_matches_jax(monkeypatch):
    jp, tp = _mlp(seed=2, gain=HE_GAIN)
    o, d, ts = _inputs(3, 8, 16)
    jc, jw = j_fused.fused_render_pass(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts),
                                       compute_dtype=jnp.bfloat16, ray_tile=8, interpret=True)
    tc, tw = t_fused.fused_render_pass(tp, T(o), T(d), T(ts), compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **BF16_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **BF16_TOL)
    # the tolerance separates the precisions: the outputs spread far wider
    # than it, and a pass without the bf16 rounding points fails it, be it
    # the fp32 pass or one that encodes x unrounded (as nerf_mlp_apply does)
    assert np.asarray(jc).std() > 1e3 * BF16_TOL["atol"]
    assert np.asarray(jw).std() > 1e3 * BF16_TOL["atol"]
    tc32, tw32 = t_fused.fused_render_pass(tp, T(o), T(d), T(ts))
    monkeypatch.setattr(t_fused, "_encode", lambda x, dim, dtype: t_mlp.round_to(
        positional_encoding(x, dim), dtype))
    tcx, twx = t_fused.fused_render_pass(tp, T(o), T(d), T(ts), compute_dtype=torch.bfloat16)
    for c, w in ((tc32, tw32), (tcx, twx)):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), **BF16_TOL)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(w.numpy(), np.asarray(jw), **BF16_TOL)


def test_plain_pass_nondefault_encoding_dims():
    jp = _scaled(j_mlp.init_nerf_mlp(jax.random.PRNGKey(7), position_dim=6, direction_dim=2,
                                     width=32, rgb_width=32), HE_GAIN)
    tp = t_mlp.params_from_jax(jp, "cpu")
    o, d, ts = _inputs(8, 8, 12)
    jc, jw = j_fused.fused_render_pass(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts),
                                       position_dim=6, direction_dim=2, ray_tile=8,
                                       interpret=True)
    tc, tw = t_fused.fused_render_pass(tp, T(o), T(d), T(ts), position_dim=6, direction_dim=2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **FP32_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **FP32_TOL)


def _jax_draws(key, n, cfg):
    """The uniforms JAX ``render_rays[_fused]`` draws from ``key``
    (``nerf.py:109``, ``rendering.py:57,170-192``)."""
    k_coarse, k_cdf = jax.random.split(key)
    k_eps, k_jit = jax.random.split(k_cdf)
    u = lambda k, shape: T(jax.random.uniform(k, shape, dtype=jnp.float32))  # noqa: E731
    return {"coarse": u(k_coarse, (n, cfg.coarse_samples)), "eps": u(k_eps, (n, 1)),
            "jitter": u(k_jit, (n, cfg.fine_samples, 1))}


def _network(cfg, seed=4):
    k_c, k_f = jax.random.split(jax.random.PRNGKey(seed))
    jp = {"coarse": j_mlp.init_nerf_mlp(k_c, cfg.position_dim, cfg.direction_dim,
                                        width=64, rgb_width=32),
          "fine": j_mlp.init_nerf_mlp(k_f, cfg.position_dim, cfg.direction_dim,
                                      width=64, rgb_width=32)}
    return jp, t_mlp.params_from_jax(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("fine_sampling", ["reference", "linterp"])
def test_render_slice_matches_jax_render_rays_fused(fine_sampling):
    jcfg = j_nerf.NeRFConfig(coarse_samples=8, fine_samples=8, fine_sampling=fine_sampling)
    tcfg = t_nerf.NeRFConfig(**jcfg.to_dict())
    jp, tp = _network(jcfg)
    o, d, _ = _inputs(9, 8, 1)
    key = jax.random.PRNGKey(11)
    ref = j_fused.render_rays_fused(jp, jcfg, jnp.asarray(o), jnp.asarray(d), key,
                                    ray_tile=8, interpret=True)
    out = t_fused.render_rays_fused(tp, tcfg, T(o), T(d), uniforms=_jax_draws(key, 8, jcfg))
    for k in ("coarse_rgb_rays", "fine_rgb_rays"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5)
    # the port's plain hierarchical render agrees with its fused slice
    plain = t_nerf.render_rays(tp, tcfg, T(o), T(d), uniforms=_jax_draws(key, 8, jcfg))
    for k in ("coarse_rgb_rays", "fine_rgb_rays"):
        np.testing.assert_allclose(plain[k].numpy(), out[k].numpy(), rtol=1e-4, atol=1e-5)
    assert profiling.counter(t_fused.FWD_LAUNCHES) == 0


def test_render_fn_hook_caches_prepared_params():
    cfg = t_nerf.NeRFConfig(coarse_samples=4, fine_samples=4)
    _, tp = _network(cfg)
    o, d, _ = _inputs(1, 5, 1)
    fn = t_fused.make_fused_render_fn()
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    a = fn(tp, cfg, T(o), T(d), g1)["fine_rgb_rays"]
    b = fn(tp, cfg, T(o), T(d), g2)["fine_rgb_rays"]
    assert torch.equal(a, b) and a.shape == (5, 3)


def test_mma_packing_layout():
    """The packed bf16 weights hold, for lane (g, t) of n-tile j and k-step
    kk, the mma.sync B fragment W[kk*16 + r*8 + t*2 + e, j*8 + g]."""
    k, n = 40, 16
    w = torch.arange(k * n, dtype=torch.float32).reshape(k, n).to(torch.bfloat16)
    packed = t_fused._pack_mma(w, 48)
    assert packed.shape == (n // 8, 48 // 16, 8, 4, 2, 2)
    flat = packed.reshape(n // 8, 3, 32, 4)
    for j in range(n // 8):
        for kk in range(3):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for r in range(2):
                    for e in range(2):
                        kidx = kk * 16 + r * 8 + t * 2 + e
                        want = w[kidx, j * 8 + g] if kidx < k else 0
                        assert flat[j, kk, lane, r * 2 + e] == want


def test_kmajor_packing_layout():
    """The bf16 forwards' matrices: element (n, k) of the packed ``W^T`` is
    ``W[k, n]``, the padded columns are zero; at full width each matrix has
    the shape its tensor map is encoded for, and the backward's
    ``_pack_mma`` layout of the same weights is unchanged."""
    k, n = 40, 16
    w = torch.arange(k * n, dtype=torch.float32).reshape(k, n).to(torch.bfloat16)
    packed = t_fused._pack_kmajor(w, 64)
    assert packed.shape == (n, 64) and packed.is_contiguous()
    for nn in range(n):
        for kk in range(64):
            assert packed[nn, kk] == (w[kk, nn] if kk < k else 0)

    from minimal_nerf_torch.kernels.raymarch import flatten_mlp_params

    _, tp = _mlp(width=256, rgb_width=128)
    ws, bs = flatten_mlp_params(tp, torch.bfloat16)
    fwd = t_fused._forward_operands(ws)
    # T0, T1, T2, T3, F0H, F0E, F1, F2, R0H, R0D as W^T [N, Kp]
    assert [tuple(m.shape) for m in fwd] == (
        [(256, 64)] + [(256, 256)] * 4 + [(256, 64)] + [(256, 256)] * 2
        + [(128, 256), (128, 64)])
    for m, i in zip(fwd, t_fused.FWD_MATRICES):
        kk = ws[i].shape[0]
        assert m.dtype == torch.bfloat16 and m.is_contiguous()
        assert torch.equal(m[:, :kk], ws[i].t()) and not m[:, kk:].any()
    kws, _, _ = t_fused._kernel_operands(ws, bs, torch.bfloat16)
    for i in (1, 5, 10):
        assert torch.equal(kws[i], t_fused._pack_mma(ws[i], {5: 64, 10: 32}.get(i, 256)))


def test_unsupported_device_raises():
    _, tp = _mlp()
    fm = t_fused.prepare_fused_mlp(tp)
    o, d, ts = _inputs(1, 4, 4)
    with pytest.raises(ValueError):
        t_fused.fused_forward(fm, T(o).to("meta"), T(d).to("meta"), T(ts).to("meta"))


# ---------------------------------------------------------------- backward

# Gradients are compared per leaf relative to the leaf's max |g|, as JAX's own
# tests do (tests/test_fused_raymarch.py:84-87).
# fp32, at position_dim 4 / direction_dim 2: both sides run the same math
# with no rounding point; the sum orders differ (<= 1e-5 measured). At the
# default 10 octaves XLA's and torch's fp32 sin at angles up to 512*pi differ
# by a few ulp, which the He weights amplify to ~2e-3 in the trunk grads.
BWD_FP32_RTOL = 5e-5
# bf16, default dims: the encodings and every activation are rounded to bf16
# on both sides, so they agree to <= 1.5e-4 (measured over 4 seeds); a pass
# that skips the bf16 rounding of the gradient activations (``gact``) is off
# by >= 4.6e-3, which the test asserts fails the bound.
BWD_BF16_RTOL = 1e-3


def _leaf_errors(ref, got):
    return [float(np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(np.asarray(a)).max()
                                                                  + 1e-12))
            for a, b in zip(ref, got)]


def _jax_backward(jp, o, d, ts, dc, dw, dtype, pd, dd):
    from minimal_nerf_tpu.kernels.raymarch import flatten_mlp_params

    ws, bs = flatten_mlp_params(jax.tree_util.tree_map(jnp.asarray, jp), dtype)
    gws, gbs = j_fused._fused_backward(
        (ws, bs), *map(jnp.asarray, (o, d, ts, dc, dw)), position_dim=pd, direction_dim=dd,
        compute_dtype=dtype, ray_tile=8, interpret=True)
    return list(gws) + list(gbs)


def _bwd_case(seed, n, s, pd, dd, with_dweights):
    jp = _scaled(j_mlp.init_nerf_mlp(jax.random.PRNGKey(seed), position_dim=pd,
                                     direction_dim=dd, width=64, rgb_width=32), HE_GAIN)
    o, d, ts = _inputs(seed + 1, n, s)
    rng = np.random.default_rng(seed + 2)
    dc = rng.normal(size=(n, 3)).astype(np.float32)
    dw = (rng.normal(size=(n, s)) if with_dweights else np.zeros((n, s))).astype(np.float32)
    return jp, (o, d, ts, dc, dw)


@pytest.mark.parametrize("with_dweights", [False, True])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plain_backward_matches_jax(monkeypatch, precision, with_dweights):
    pd, dd = (4, 2) if precision == "fp32" else (10, 4)
    jdtype, tdtype = (None, None) if precision == "fp32" else (jnp.bfloat16, torch.bfloat16)
    rtol = BWD_FP32_RTOL if precision == "fp32" else BWD_BF16_RTOL
    jp, (o, d, ts, dc, dw) = _bwd_case(0, 8, 16, pd, dd, with_dweights)
    ref = _jax_backward(jp, o, d, ts, dc, dw, jdtype, pd, dd)
    fm = t_fused.prepare_fused_mlp(t_mlp.params_from_jax(jp, "cpu"), tdtype)
    args = (fm, T(o), T(d), T(ts), T(dc), T(dw) if with_dweights else None, pd, dd)
    gws, gbs = t_fused.fused_backward(*args)
    assert [tuple(g.shape) for g in gws + gbs] == [tuple(np.shape(r)) for r in ref]
    assert min(np.abs(np.asarray(r)).max() for r in ref) > 1e-2  # every leaf has signal
    assert max(_leaf_errors(ref, gws + gbs)) < rtol
    assert profiling.counter(t_fused.BWD_LAUNCHES) == 0
    if precision == "bf16":
        monkeypatch.setattr(t_fused, "_grad_act", lambda v, mask, dtype: v * mask)
        gws, gbs = t_fused.fused_backward(*args)
        assert max(_leaf_errors(ref, gws + gbs)) > rtol


def test_plain_backward_matches_autograd():
    """fp32: the hand-derived backward equals autograd through the plain
    forward (same torch ops; measured <= 7e-7 relative to the leaf max)."""
    jp, (o, d, ts, dc, dw) = _bwd_case(3, 8, 16, 10, 4, True)
    fm = t_fused.prepare_fused_mlp(t_mlp.params_from_jax(jp, "cpu"))
    ws = [w.clone().requires_grad_() for w in fm.ws]
    bs = [b.clone().requires_grad_() for b in fm.bs]
    color, weights = t_fused.fused_forward_plain(fm._replace(ws=ws, bs=bs), T(o), T(d), T(ts))
    ref = torch.autograd.grad((color * T(dc)).sum() + (weights * T(dw)).sum(), ws + bs)
    gws, gbs = t_fused.fused_backward_plain(fm, T(o), T(d), T(ts), T(dc), T(dw))
    assert max(_leaf_errors([r.numpy() for r in ref], gws + gbs)) < 1e-5


def test_plain_backward_faults_fail_the_bound(monkeypatch):
    """An inclusive suffix sum, or a dropped skip-concat encoding term,
    moves the gradients far beyond the 1e-5 that separates the plain
    backward from autograd."""
    jp, (o, d, ts, dc, dw) = _bwd_case(3, 8, 16, 10, 4, True)
    fm = t_fused.prepare_fused_mlp(t_mlp.params_from_jax(jp, "cpu"))
    args = (T(o), T(d), T(ts), T(dc), T(dw))
    good = t_fused.fused_backward_plain(fm, *args)
    ws = list(fm.ws)
    ws[5] = torch.zeros_like(ws[5])
    bad_skip = t_fused.fused_backward_plain(fm._replace(ws=ws), *args)
    orig = t_fused._suffix_sum
    monkeypatch.setattr(t_fused, "_suffix_sum", lambda x: orig(x) + x)
    bad_suffix = t_fused.fused_backward_plain(fm, *args)
    for bad in (bad_skip, bad_suffix):
        assert max(_leaf_errors(good[0] + good[1], bad[0] + bad[1])) > 1e-2


def _grad_case(fine_sampling="reference"):
    jcfg = j_nerf.NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=8,
                             fine_samples=8, fine_sampling=fine_sampling)
    k_c, k_f = jax.random.split(jax.random.PRNGKey(5))
    jp = {k: _scaled(j_mlp.init_nerf_mlp(key, 4, 2, width=64, rgb_width=32), HE_GAIN)
          for k, key in (("coarse", k_c), ("fine", k_f))}
    return jcfg, t_nerf.NeRFConfig(**jcfg.to_dict()), jp


def test_render_rays_fused_grad_matches_jax():
    """Gradients of the hierarchical loss through both fused passes, shared
    draws (mirrors tests/test_fused_raymarch.py:109-137), fp32."""
    jcfg, tcfg, jp = _grad_case()
    o, d, _ = _inputs(9, 8, 1)
    rgb = np.full((8, 3), 0.5, np.float32)
    key = jax.random.PRNGKey(11)

    def loss(p):
        out = j_fused.render_rays_fused(p, jcfg, jnp.asarray(o), jnp.asarray(d), key,
                                        ray_tile=8, interpret=True)
        return (jnp.mean((out["fine_rgb_rays"] - rgb) ** 2)
                + jnp.mean((out["coarse_rgb_rays"] - rgb) ** 2))

    ref = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, jp))
    tp = t_mlp.params_from_jax(jp, "cpu")
    for leaf in t_fused.flatten_tree(tp):
        leaf.requires_grad_()
    out = t_fused.render_rays_fused(tp, tcfg, T(o), T(d), uniforms=_jax_draws(key, 8, jcfg))
    torch.stack([((out[k] - T(rgb)) ** 2).mean()
                 for k in ("fine_rgb_rays", "coarse_rgb_rays")]).sum().backward()
    got = [t.grad.numpy() for t in t_fused.flatten_tree(tp)]
    assert max(_leaf_errors(t_fused.flatten_tree(jax.device_get(ref)), got)) < BWD_FP32_RTOL


def test_render_fn_cache_follows_in_place_updates():
    """The hook's packed weights follow an optimizer's in-place update."""
    cfg = t_nerf.NeRFConfig(coarse_samples=4, fine_samples=4)
    _, tp = _network(cfg)
    o, d, _ = _inputs(1, 5, 1)
    fn = t_fused.make_fused_render_fn()

    def draws():
        return {"coarse": torch.full((5, 4), 0.5), "eps": torch.full((5, 1), 0.5),
                "jitter": torch.full((5, 4, 1), 0.5)}

    before = fn(tp, cfg, T(o), T(d), uniforms=draws())["fine_rgb_rays"]
    with torch.no_grad():
        for mlp in tp.values():
            mlp["rgb"][1]["b"] += 1.0
    after = fn(tp, cfg, T(o), T(d), uniforms=draws())["fine_rgb_rays"]
    fresh = t_fused.render_rays_fused(tp, cfg, T(o), T(d), uniforms=draws())["fine_rgb_rays"]
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh)
