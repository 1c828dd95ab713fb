"""Volume-rendering math: stratified sampling, transmittance weights,
alpha compositing and inverse-CDF hierarchical sampling.

Counterpart of ``minimal_nerf_tpu/ops/rendering.py`` with the same draws and
the same math. Every sampling function takes either a ``torch.Generator`` or
pre-drawn uniforms in ``[0, 1)``, so tests can replay the JAX draws:

- ``generate_coarse_samples``: ``uniforms [N, S]``, the per-sample jitter
  (``rendering.py:57``);
- ``inverse_transform_sampling``: ``(eps [N, 1], jitter [N, S, 1])``, one
  shared CDF offset per ray and the in-bin jitter (``rendering.py:170-192``);
- ``inverse_transform_sampling_linterp``: ``eps [N, 1]`` only.

Bins are found with ``torch.searchsorted(cdf, u, right=False)`` and read with
``torch.gather`` where the JAX package uses ``compare_all`` and one-hot
selects (a TPU workaround for its missing gather unit).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_uniform(shape, like: torch.Tensor, generator: Optional[torch.Generator],
                 given: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniforms in ``[0, 1)`` of ``shape``: ``given`` if passed, else drawn
    from ``generator`` on ``like``'s device."""
    if given is not None:
        given = torch.as_tensor(given, dtype=like.dtype, device=like.device)
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"uniforms of shape {tuple(given.shape)}, "
                             f"expected {tuple(shape)}")
        return given
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def generate_coarse_samples(
    o_rays: torch.Tensor,
    d_rays: torch.Tensor,
    num_samples: int,
    near: float = 2.0,
    far: float = 6.0,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified samples of ``o + t * d`` on ``[near, far]``.

    Returns ``samples [N, S, 3]`` and ``ts [N, S, 1]`` (monotone along S).
    """
    n = o_rays.shape[0]
    step = (far - near) / num_samples
    base = near + step * torch.arange(num_samples, dtype=o_rays.dtype,
                                      device=o_rays.device)
    jitter = draw_uniform((n, num_samples), o_rays, generator, uniforms) * step
    ts = (base[None, :] + jitter)[..., None]
    samples = o_rays[:, None, :] + ts * d_rays[:, None, :]
    return samples, ts


def generate_deltas(ts: torch.Tensor) -> torch.Tensor:
    """``delta_i = t_{i+1} - t_i`` for ``ts [N, S, 1]``; the last is 1e10."""
    terminal = torch.full((ts.shape[0], 1, 1), 1e10, dtype=ts.dtype, device=ts.device)
    return torch.cat([ts[:, 1:, :] - ts[:, :-1, :], terminal], dim=1)


def calculate_unnormalized_weights(density: torch.Tensor,
                                   deltas: torch.Tensor) -> torch.Tensor:
    """``w_i = T_i (1 - exp(-sigma_i d_i))`` with ``T_i`` the exponential of
    the exclusive prefix sum of ``-sigma * delta`` (all ``[N, S, 1]``)."""
    neg = -density * deltas
    shifted = torch.cat([torch.zeros_like(neg[:, :1]), neg[:, :-1]], dim=1)
    transmittance = torch.exp(torch.cumsum(shifted, dim=1))
    return (1.0 - torch.exp(neg)) * transmittance


def estimate_ray_color(weights: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """``sum_i w_i * rgb_i`` -> ``[N, 3]`` (no normalization)."""
    return torch.sum(weights * rgb, dim=1)


def _cdf_grid(weights, num_samples, generator, eps_u):
    """Normalized CDF ``[N, C]``, low-variance grid ``u [N, S]`` and the
    left-searchsorted bin indices ``[N, S]``."""
    n = weights.shape[0]
    cdf = torch.cumsum(weights[..., 0], dim=1)
    cdf = cdf / (cdf[:, -1:] + 1e-10)
    eps = draw_uniform((n, 1), cdf, generator, eps_u) / num_samples
    grid = torch.arange(num_samples, dtype=cdf.dtype, device=cdf.device) / num_samples
    u = (grid[None, :] + eps).contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=False)
    return cdf, u, idx


def _bounds(ts: torch.Tensor, near: float, far: float) -> torch.Tensor:
    n = ts.shape[0]
    lo = torch.full((n, 1), near, dtype=ts.dtype, device=ts.device)
    hi = torch.full((n, 1), far, dtype=ts.dtype, device=ts.device)
    return torch.cat([lo, ts[..., 0], hi], dim=1)  # [N, C+2]


def inverse_transform_sampling(
    o_rays: torch.Tensor,
    d_rays: torch.Tensor,
    weights: torch.Tensor,
    ts: torch.Tensor,
    num_samples: int,
    near: float = 2.0,
    far: float = 6.0,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine samples from the coarse weights ``[N, C, 1]`` at times ``ts``.

    ``uniforms = (eps [N, 1], jitter [N, S, 1])`` replaces the draws.
    Returns ``fine_samples [N, S, 3]``, ``fine_ts [N, S, 1]`` (not sorted).
    """
    eps_u, jit_u = uniforms if uniforms is not None else (None, None)
    n = ts.shape[0]
    _, _, idx = _cdf_grid(weights, num_samples, generator, eps_u)
    bounds = _bounds(ts, near, far)
    lower = torch.gather(bounds, 1, idx)[..., None]
    upper = torch.gather(bounds, 1, idx + 1)[..., None]
    jitter = draw_uniform((n, num_samples, 1), ts, generator, jit_u)
    fine_ts = lower + (upper - lower) * jitter
    return o_rays[:, None, :] + fine_ts * d_rays[:, None, :], fine_ts


def inverse_transform_sampling_linterp(
    o_rays: torch.Tensor,
    d_rays: torch.Tensor,
    weights: torch.Tensor,
    ts: torch.Tensor,
    num_samples: int,
    near: float = 2.0,
    far: float = 6.0,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-CDF sampling with linear interpolation inside the bin.

    ``uniforms`` is the shared ``eps [N, 1]``. The returned ``fine_ts
    [N, S, 1]`` is sorted along S.
    """
    n = ts.shape[0]
    cdf, u, idx = _cdf_grid(weights, num_samples, generator, uniforms)
    bounds = _bounds(ts, near, far)
    cdf_bounds = torch.cat(
        [torch.zeros((n, 1), dtype=cdf.dtype, device=cdf.device), cdf,
         torch.ones((n, 1), dtype=cdf.dtype, device=cdf.device)], dim=1)
    t_lo, t_hi = torch.gather(bounds, 1, idx), torch.gather(bounds, 1, idx + 1)
    c_lo, c_hi = torch.gather(cdf_bounds, 1, idx), torch.gather(cdf_bounds, 1, idx + 1)
    denom = torch.where(c_hi - c_lo < 1e-10, torch.ones_like(c_hi), c_hi - c_lo)
    frac = torch.clamp((u - c_lo) / denom, 0.0, 1.0)
    fine_ts = (t_lo + (t_hi - t_lo) * frac)[..., None]
    return o_rays[:, None, :] + fine_ts * d_rays[:, None, :], fine_ts


def merge_sorted_ts(o_rays, d_rays, fine_ts, coarse_ts):
    """Merge two per-ray sorted ts arrays ``[N, Sf, 1]``, ``[N, Sc, 1]``.

    Each element's merged slot is its own index plus its rank in the other
    array (fine elements first on ties). Returns ``samples``, ``ts
    [N, Sf+Sc, 1]``.
    """
    f = fine_ts[..., 0].contiguous()
    c = coarse_ts[..., 0].contiguous()
    n, sf = f.shape
    sc = c.shape[1]
    pos_f = torch.arange(sf, device=f.device)[None, :] + torch.searchsorted(c, f, right=False)
    pos_c = torch.arange(sc, device=c.device)[None, :] + torch.searchsorted(f, c, right=True)
    merged = torch.zeros((n, sf + sc), dtype=f.dtype, device=f.device)
    merged.scatter_(1, pos_f, f)
    merged.scatter_(1, pos_c, c)
    all_ts = merged[..., None]
    return o_rays[:, None, :] + all_ts * d_rays[:, None, :], all_ts


def union_and_sort_ts(o_rays, d_rays, fine_ts, coarse_ts):
    """Sorted union of fine and coarse times, positions recomputed.

    Returns ``samples [N, Sf+Sc, 3]``, ``ts [N, Sf+Sc, 1]``.
    """
    all_ts = torch.sort(torch.cat([fine_ts, coarse_ts], dim=1), dim=1).values
    return o_rays[:, None, :] + all_ts * d_rays[:, None, :], all_ts
