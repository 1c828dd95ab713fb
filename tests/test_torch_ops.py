"""The port's encoding, MLP, rendering and camera math against the JAX
package, on shared inputs and shared draws (numpy arrays fed to both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.ops import cameras as t_cam
from minimal_nerf_torch.ops import encoding as t_enc
from minimal_nerf_torch.ops import rendering as t_r
from minimal_nerf_tpu.models import mlp as j_mlp
from minimal_nerf_tpu.ops import cameras as j_cam
from minimal_nerf_tpu.ops import encoding as j_enc
from minimal_nerf_tpu.ops import rendering as j_r

# fp32 on both sides; only the order of sums differs (rtol/atol of
# tests/test_fused_raymarch.py)
RTOL, ATOL = 3e-5, 1e-6


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _rays(rng, n):
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d = (rng.normal(size=(n, 3)) - [0.0, 0.0, 2.0]).astype(np.float32)
    return o, d


# ------------------------------------------------------------------ encoding


def test_encoding_goldens():
    enc = t_enc.positional_encoding(torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]), dim=1)
    expected = np.array([[1.0, 1.0, 1.0, 0.0, 0.0, 0.0], [-1.0, -1.0, -1.0, 0.0, 0.0, 0.0]])
    np.testing.assert_allclose(enc.numpy(), expected, atol=1e-6)
    assert t_enc.positional_encoding(torch.rand(4, 5, 3), dim=10).shape == (4, 5, 60)
    np.testing.assert_allclose(
        t_enc.normalize_coordinates(torch.tensor([np.pi, -np.pi, 0.0])).numpy(),
        [1.0, -1.0, 0.0], atol=1e-7)


@pytest.mark.parametrize("dim", [1, 4, 10])
def test_encoding_matches_jax(rng, dim):
    x = rng.uniform(-1, 1, size=(7, 5, 3)).astype(np.float32)
    close(t_enc.positional_encoding(T(x), dim), j_enc.positional_encoding(jnp.asarray(x), dim),
          rtol=1e-5, atol=2e-6)


# ----------------------------------------------------------------------- MLP


def _mlp_pair(width=64, rgb_width=32, seed=0):
    jp = j_mlp.init_nerf_mlp(jax.random.PRNGKey(seed), width=width, rgb_width=rgb_width)
    return jp, t_mlp.params_from_jax(jax.device_get(jp), "cpu")


def test_mlp_apply_fp32_matches_jax(rng):
    jp, tp = _mlp_pair()
    o, d = _rays(rng, 6)
    samples = (o[:, None] + rng.uniform(2, 6, size=(6, 9, 1)) * d[:, None]).astype(np.float32)
    jd, jrgb = j_mlp.nerf_mlp_apply(jp, jnp.asarray(samples), jnp.asarray(d))
    td, trgb = t_mlp.nerf_mlp_apply(tp, T(samples), T(d))
    close(td, jd)
    close(trgb, jrgb)


def test_params_roundtrip_and_init():
    jp, tp = _mlp_pair()
    back = t_mlp.params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jp)),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    g = torch.Generator().manual_seed(1)
    p = t_mlp.init_nerf_mlp(g, width=64, rgb_width=32, device="cpu")
    shapes = t_mlp.nerf_mlp_shapes(width=64, rgb_width=32)
    for leaf, shape in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(
            shapes, is_leaf=lambda s: isinstance(s, tuple))):
        assert tuple(leaf.shape) == shape
    bound = 1 / np.sqrt(60)
    w = p["trunk"][0]["w"]
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    # gain scales the weights' bound (He init at sqrt(6)), not the biases'
    he = t_mlp.init_nerf_mlp(torch.Generator().manual_seed(1), width=64, rgb_width=32,
                             device="cpu", gain=np.sqrt(6))
    torch.testing.assert_close(he["trunk"][0]["w"], w * np.sqrt(6))
    torch.testing.assert_close(he["trunk"][0]["b"], p["trunk"][0]["b"])


# ----------------------------------------------------------------- rendering


def test_coarse_samples_on_shared_draws(rng):
    o, d = _rays(rng, 5)
    key = jax.random.PRNGKey(3)
    j_samples, j_ts = j_r.generate_coarse_samples(key, jnp.asarray(o), jnp.asarray(d), 12)
    u = np.asarray(jax.random.uniform(key, (5, 12), dtype=jnp.float32))
    t_samples, t_ts = t_r.generate_coarse_samples(T(o), T(d), 12, uniforms=T(u))
    close(t_ts, j_ts)
    close(t_samples, j_samples)


def test_deltas_weights_color(rng):
    ts = np.sort(rng.uniform(2, 6, size=(4, 10, 1)), axis=1).astype(np.float32)
    sigma = rng.uniform(0, 3, size=(4, 10, 1)).astype(np.float32)
    rgb = rng.uniform(size=(4, 10, 3)).astype(np.float32)
    jd = j_r.generate_deltas(jnp.asarray(ts))
    td = t_r.generate_deltas(T(ts))
    close(td, jd)
    jw = j_r.calculate_unnormalized_weights(jnp.asarray(sigma), jd)
    tw = t_r.calculate_unnormalized_weights(T(sigma), td)
    close(tw, jw)
    close(t_r.estimate_ray_color(tw, T(rgb)), j_r.estimate_ray_color(jw, jnp.asarray(rgb)))
    # golden from the reference tests: uniform density 1, unit deltas
    w = t_r.calculate_unnormalized_weights(torch.ones(1, 3, 1), torch.ones(1, 3, 1))
    e = np.exp(-1.0)
    np.testing.assert_allclose(w[0, :, 0].numpy(), [1 - e, (1 - e) * e, (1 - e) * e * e],
                               rtol=1e-6)


def _coarse(rng, n=6, c=10):
    o, d = _rays(rng, n)
    ts = np.sort(rng.uniform(2, 6, size=(n, c, 1)), axis=1).astype(np.float32)
    w = rng.uniform(0, 1, size=(n, c, 1)).astype(np.float32)
    w[0] = 0.0  # an all-zero ray exercises the 1e-10 CDF guard
    return o, d, ts, w


def test_inverse_transform_sampling_on_shared_draws(rng):
    o, d, ts, w = _coarse(rng)
    key = jax.random.PRNGKey(5)
    _, j_fine = j_r.inverse_transform_sampling(
        key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(w), jnp.asarray(ts), 16)
    k_eps, k_jit = jax.random.split(key)
    eps = np.asarray(jax.random.uniform(k_eps, (6, 1), dtype=jnp.float32))
    jit = np.asarray(jax.random.uniform(k_jit, (6, 16, 1), dtype=jnp.float32))
    t_samples, t_fine = t_r.inverse_transform_sampling(
        T(o), T(d), T(w), T(ts), 16, uniforms=(T(eps), T(jit)))
    close(t_fine, j_fine)
    assert torch.isfinite(t_samples).all()
    _, j_all = j_r.union_and_sort_ts(jnp.asarray(o), jnp.asarray(d), j_fine, jnp.asarray(ts))
    _, t_all = t_r.union_and_sort_ts(T(o), T(d), t_fine, T(ts))
    close(t_all, j_all)


def test_linterp_and_merge_on_shared_draws(rng):
    o, d, ts, w = _coarse(rng)
    key = jax.random.PRNGKey(6)
    _, j_fine = j_r.inverse_transform_sampling_linterp(
        key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(w), jnp.asarray(ts), 16)
    eps = np.asarray(jax.random.uniform(jax.random.split(key)[0], (6, 1), dtype=jnp.float32))
    _, t_fine = t_r.inverse_transform_sampling_linterp(
        T(o), T(d), T(w), T(ts), 16, uniforms=T(eps))
    close(t_fine, j_fine, atol=1e-5)
    assert (t_fine[:, 1:] >= t_fine[:, :-1]).all()
    _, j_all = j_r.merge_sorted_ts(jnp.asarray(o), jnp.asarray(d), j_fine, jnp.asarray(ts))
    _, t_all = t_r.merge_sorted_ts(T(o), T(d), T(np.asarray(j_fine)), T(ts))
    close(t_all, j_all)


def test_uniform_shape_is_checked(rng):
    o, d = _rays(rng, 3)
    with pytest.raises(ValueError):
        t_r.generate_coarse_samples(T(o), T(d), 4, uniforms=torch.zeros(3, 5))


# ------------------------------------------------------------------- cameras


def test_cameras_match_jax():
    assert t_cam.focal_from_angle(800, 0.69) == j_cam.focal_from_angle(800, 0.69)
    np.testing.assert_array_equal(t_cam.pose_spherical(30.0, -30.0, 4.0),
                                  j_cam.pose_spherical(30.0, -30.0, 4.0))
    poses = t_cam.spherical_poses(5)
    np.testing.assert_array_equal(poses, j_cam.spherical_poses(5))
    focal = t_cam.focal_from_angle(12, 0.7)
    to, td = t_cam.get_rays(10, 12, focal, poses[1], device="cpu")
    jo, jd = j_cam.get_rays(10, 12, focal, poses[1])
    close(to, jo)
    close(td, jd)
    xs = np.array([0.0, 3.0, 11.0], np.float32)
    ys = np.array([9.0, 2.0, 0.0], np.float32)
    to, td = t_cam.rays_for_pixels(T(xs), T(ys), 10, 12, focal, poses[2])
    jo, jd = j_cam.rays_for_pixels(jnp.asarray(xs), jnp.asarray(ys), 10, 12, focal, poses[2])
    close(to, jo)
    close(td, jd)
    close(t_cam.pixel_dirs(T(xs), T(ys), 10, 12, focal),
          j_cam.pixel_dirs(jnp.asarray(xs), jnp.asarray(ys), 10, 12, focal))
