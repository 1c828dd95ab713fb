"""The hierarchical NeRF (coarse + fine) and its plain render function.

Counterpart of ``minimal_nerf_tpu/models/nerf.py``: two independent MLPs, a
stratified coarse pass, inverse-CDF fine sampling, the sorted 64+128 union
and transmittance compositing for both passes.

Draws: ``render_rays`` takes a ``torch.Generator`` or a dict of pre-drawn
uniforms ``{"coarse": [N, Sc], "eps": [N, 1], "jitter": [N, Sf, 1]}`` (the
JAX order of ``nerf.py:109`` and ``rendering.py:57,170-192``; ``"jitter"``
is unused under ``fine_sampling="linterp"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from minimal_nerf_torch.models.mlp import init_nerf_mlp, nerf_mlp_apply
from minimal_nerf_torch.ops import rendering

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Hyperparameters of the hierarchical NeRF (same fields as the JAX one)."""

    position_dim: int = 10
    direction_dim: int = 4
    coarse_samples: int = 64
    fine_samples: int = 128
    near: float = 2.0
    far: float = 6.0
    # "reference": uniform jitter inside the selected coarse bin + sort of the
    # union; "linterp": linear inverse-CDF interpolation + sorted merge
    fine_sampling: str = "reference"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NeRFConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def init_nerf_network(generator: torch.Generator, config: NeRFConfig,
                      device="cuda", gain: float = 1.0) -> Params:
    """Independent coarse and fine MLPs drawn in turn from ``generator``."""
    return {
        name: init_nerf_mlp(generator, config.position_dim, config.direction_dim,
                            device=device, gain=gain)
        for name in ("coarse", "fine")
    }


def fine_times(config: NeRFConfig, o_rays, d_rays, coarse_weights, coarse_ts,
               generator=None, uniforms=None) -> torch.Tensor:
    """The sorted union ``[N, Sc+Sf, 1]`` of coarse and inverse-CDF fine times."""
    uniforms = uniforms or {}
    w, cts = coarse_weights.detach(), coarse_ts.detach()
    if config.fine_sampling == "linterp":
        _, fts = rendering.inverse_transform_sampling_linterp(
            o_rays, d_rays, w, cts, config.fine_samples, config.near, config.far,
            generator=generator, uniforms=uniforms.get("eps"),
        )
        _, all_ts = rendering.merge_sorted_ts(o_rays, d_rays, fts, cts)
    else:
        pre = (uniforms["eps"], uniforms["jitter"]) if "eps" in uniforms else None
        _, fts = rendering.inverse_transform_sampling(
            o_rays, d_rays, w, cts, config.fine_samples, config.near, config.far,
            generator=generator, uniforms=pre,
        )
        _, all_ts = rendering.union_and_sort_ts(o_rays, d_rays, fts, cts)
    return all_ts


def render_rays(
    params: Params,
    config: NeRFConfig,
    o_rays: torch.Tensor,
    d_rays: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    compute_dtype=None,
    mlp_apply=None,
    coarse_sampler=None,
    uniforms: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Hierarchical volume render of a ray batch (the plain path).

    ``mlp_apply`` overrides the MLP (signature of ``nerf_mlp_apply``);
    ``coarse_sampler`` overrides coarse placement (signature of
    ``rendering.generate_coarse_samples``). Returns ``fine_rgb_rays [N, 3]``
    and ``coarse_rgb_rays [N, 3]``.
    """
    apply_fn = mlp_apply or nerf_mlp_apply
    sample_coarse = coarse_sampler or rendering.generate_coarse_samples
    uniforms = uniforms or {}

    def composite(mlp, samples, ts):
        density, rgb = apply_fn(mlp, samples, d_rays, config.position_dim,
                                config.direction_dim, compute_dtype=compute_dtype)
        weights = rendering.calculate_unnormalized_weights(
            density, rendering.generate_deltas(ts))
        return rendering.estimate_ray_color(weights, rgb), weights

    coarse_samples, coarse_ts = sample_coarse(
        o_rays, d_rays, config.coarse_samples, config.near, config.far,
        generator=generator, uniforms=uniforms.get("coarse"),
    )
    coarse_rgb, coarse_weights = composite(params["coarse"], coarse_samples, coarse_ts)
    all_ts = fine_times(config, o_rays, d_rays, coarse_weights, coarse_ts,
                        generator, uniforms)
    all_samples = o_rays[:, None, :] + all_ts * d_rays[:, None, :]
    fine_rgb, _ = composite(params["fine"], all_samples, all_ts)
    return {"fine_rgb_rays": fine_rgb, "coarse_rgb_rays": coarse_rgb}
