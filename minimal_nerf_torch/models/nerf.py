"""The hierarchical NeRF (coarse + fine) and its plain render function, the
coarse-only render of ``mode="single"``, and the reference-shaped wrappers.

Counterpart of ``minimal_nerf_tpu/models/nerf.py``: two independent MLPs, a
stratified coarse pass, inverse-CDF fine sampling, the sorted 64+128 union
and transmittance compositing for both passes (``render_rays``); one MLP
over stratified samples (``render_single``); ``SingleNeRF`` and
``NeRFNetwork``, config-plus-params wrappers around the two.

Draws: ``render_rays`` takes a ``torch.Generator`` or a dict of pre-drawn
uniforms ``{"coarse": [N, Sc], "eps": [N, 1], "jitter": [N, Sf, 1]}`` (the
JAX order of ``nerf.py:109`` and ``rendering.py:57,170-192``; ``"jitter"``
is unused under ``fine_sampling="linterp"``); ``render_single`` a generator
or ``{"coarse": [N, S]}``; ``draw_render_uniforms`` draws a render's
uniforms ahead, in its order (the train step's draws, a sharded render
chunk's).
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


def draw_render_uniforms(config: NeRFConfig, n: int, generator: torch.Generator, device,
                         occupancy_cfg=None, mode: str = "full") -> Dict[str, Any]:
    """The uniforms a render of ``n`` rays draws from ``generator``, in the
    order it draws them: ``"coarse"`` ``[n, Sc]`` (under an occupancy
    config the sampler's ``(eps [n, 1], frac [n, Sc] or None)``,
    ``ops.occupancy.make_occupancy_sampler``), then the fine ``"eps" [n,
    1]`` and, with ``fine_sampling="reference"``, ``"jitter" [n, Sf, 1]``;
    under ``mode="single"`` (``render_single``) only ``"coarse"``. A render
    given these as ``uniforms`` equals the render drawing from the same
    generator state, bit for bit."""
    rand = lambda *shape: torch.rand(shape, generator=generator, dtype=torch.float32,  # noqa: E731
                                     device=device)
    sc = config.coarse_samples
    if occupancy_cfg is not None:
        coarse = (rand(n, 1), rand(n, sc) if occupancy_cfg.in_bin_jitter else None)
    else:
        coarse = rand(n, sc)
    uniforms = {"coarse": coarse}
    if mode != "single":
        uniforms["eps"] = rand(n, 1)
        if config.fine_sampling != "linterp":
            uniforms["jitter"] = rand(n, config.fine_samples, 1)
    return uniforms


def map_uniforms(fn, uniforms: Dict[str, Any]) -> Dict[str, Any]:
    """``fn`` applied to every tensor of ``draw_render_uniforms``'s dict."""
    def one(u):
        if isinstance(u, tuple):
            return tuple(None if t is None else fn(t) for t in u)
        return fn(u)

    return {k: one(v) for k, v in uniforms.items()}


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
    return_stats: bool = False,
) -> Dict[str, torch.Tensor]:
    """Hierarchical volume render of a ray batch (the plain path).

    ``mlp_apply`` overrides the MLP (signature of ``nerf_mlp_apply``, e.g.
    the point kernels' ``make_mlp_kernel_apply()``); ``coarse_sampler``
    overrides coarse placement (signature of
    ``rendering.generate_coarse_samples``). Returns ``fine_rgb_rays [N, 3]``
    and ``coarse_rgb_rays [N, 3]``; with ``return_stats`` also the
    reference's density diagnostics from the detached densities,
    ``{coarse,fine}_density_sumsq`` (the caller takes the square root) and
    ``{coarse,fine}_density_non_zeros``.
    """
    apply_fn = mlp_apply or nerf_mlp_apply
    sample_coarse = coarse_sampler or rendering.generate_coarse_samples
    uniforms = uniforms or {}

    out = {}

    def composite(name, mlp, samples, ts):
        density, rgb = apply_fn(mlp, samples, d_rays, config.position_dim,
                                config.direction_dim, compute_dtype=compute_dtype)
        if return_stats:
            d32 = density.detach().float()
            out[f"{name}_density_sumsq"] = torch.sum(d32 * d32)
            out[f"{name}_density_non_zeros"] = torch.sum(d32 != 0).float()
        weights = rendering.calculate_unnormalized_weights(
            density, rendering.generate_deltas(ts))
        return rendering.estimate_ray_color(weights, rgb), weights

    coarse_samples, coarse_ts = sample_coarse(
        o_rays, d_rays, config.coarse_samples, config.near, config.far,
        generator=generator, uniforms=uniforms.get("coarse"),
    )
    coarse_rgb, coarse_weights = composite("coarse", params["coarse"], coarse_samples,
                                           coarse_ts)
    all_ts = fine_times(config, o_rays, d_rays, coarse_weights, coarse_ts,
                        generator, uniforms)
    all_samples = o_rays[:, None, :] + all_ts * d_rays[:, None, :]
    fine_rgb, _ = composite("fine", params["fine"], all_samples, all_ts)
    return dict(out, fine_rgb_rays=fine_rgb, coarse_rgb_rays=coarse_rgb)


def render_single(params: Params, config: NeRFConfig, o_rays: torch.Tensor,
                  d_rays: torch.Tensor, generator: Optional[torch.Generator] = None,
                  num_samples: Optional[int] = None, compute_dtype=None, mlp_apply=None,
                  uniforms: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Coarse-only render of one MLP ``params`` (JAX ``render_single``,
    reference ``SingleNeRF.forward``).

    ``num_samples`` stratified samples per ray (default
    ``config.coarse_samples``), drawn from ``generator`` or taken from
    ``uniforms["coarse"] [N, S]``; ``mlp_apply`` overrides the MLP (the
    point kernels' ``make_mlp_kernel_apply()`` under ``--kernel pallas``).
    Returns ``pred_rgbs [N, 3]``, ``density [N, S, 1]``, ``ts``,
    ``samples`` and ``deltas``.
    """
    apply_fn = mlp_apply or nerf_mlp_apply
    s = num_samples if num_samples is not None else config.coarse_samples
    samples, ts = rendering.generate_coarse_samples(
        o_rays, d_rays, s, config.near, config.far, generator=generator,
        uniforms=(uniforms or {}).get("coarse"))
    density, rgb = apply_fn(params, samples, d_rays, config.position_dim, config.direction_dim,
                            compute_dtype=compute_dtype)
    deltas = rendering.generate_deltas(ts)
    weights = rendering.calculate_unnormalized_weights(density, deltas)
    return {"pred_rgbs": rendering.estimate_ray_color(weights, rgb), "density": density,
            "ts": ts, "samples": samples, "deltas": deltas}


def _call_generator(seed: int, call: int, device) -> torch.Generator:
    """The draws of a wrapper's ``call``-th forward without a generator
    (JAX folds the call count into the wrapper's key)."""
    from minimal_nerf_torch.views import chunk_generator

    return chunk_generator(seed, call, device)


class SingleNeRF:
    """Coarse-only NeRF wrapper (JAX ``SingleNeRF``, reference
    ``nerf_model.py:208-305``): a ``NeRFConfig``, one MLP's params and
    ``forward(o_rays, d_rays) -> render_single(...)``. Without params the
    MLP is drawn from a generator seeded from ``(seed, 1)`` on ``device``;
    a forward without a generator draws from ``(seed, call count)``.
    Training goes through ``Trainer(mode="single")``."""

    def __init__(self, position_dim: int = 10, direction_dim: int = 4, num_samples: int = 128,
                 near: float = 2.0, far: float = 6.0, params: Optional[Params] = None,
                 seed: int = 0, compute_dtype=None, device="cuda"):
        from minimal_nerf_torch import resolve_device

        self.config = NeRFConfig(position_dim=position_dim, direction_dim=direction_dim,
                                 coarse_samples=num_samples, near=near, far=far)
        self.num_samples = num_samples
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.seed, self._call_count = seed, 0
        self.params = params if params is not None else init_nerf_mlp(
            _call_generator(seed, 1, self.device), position_dim, direction_dim,
            device=self.device)

    def forward(self, o_rays, d_rays, generator: Optional[torch.Generator] = None,
                uniforms=None):
        if generator is None and uniforms is None:
            generator = _call_generator(self.seed, self._call_count, self.device)
            self._call_count += 1
        return render_single(self.params, self.config, o_rays, d_rays, generator,
                             num_samples=self.num_samples, compute_dtype=self.compute_dtype,
                             uniforms=uniforms)

    __call__ = forward


class NeRFNetwork:
    """Coarse + fine NeRF wrapper (JAX ``NeRFNetwork``, reference
    ``nerf_model.py:89-132``): a ``NeRFConfig``, the two MLPs' params and
    ``forward(o_rays, d_rays) -> {"fine_rgb_rays", "coarse_rgb_rays"}``
    through ``render_rays``. Params and draws as ``SingleNeRF``'s."""

    def __init__(self, position_dim: int = 10, direction_dim: int = 4, coarse_samples: int = 64,
                 fine_samples: int = 128, near: float = 2.0, far: float = 6.0,
                 params: Optional[Params] = None, seed: int = 0, compute_dtype=None,
                 device="cuda"):
        from minimal_nerf_torch import resolve_device

        self.config = NeRFConfig(position_dim=position_dim, direction_dim=direction_dim,
                                 coarse_samples=coarse_samples, fine_samples=fine_samples,
                                 near=near, far=far)
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.seed, self._call_count = seed, 0
        self.params = params if params is not None else init_nerf_network(
            _call_generator(seed, 1, self.device), self.config, device=self.device)

    def forward(self, o_rays, d_rays, generator: Optional[torch.Generator] = None,
                uniforms=None):
        if generator is None and uniforms is None:
            generator = _call_generator(self.seed, self._call_count, self.device)
            self._call_count += 1
        out = render_rays(self.params, self.config, o_rays, d_rays, generator,
                          compute_dtype=self.compute_dtype, uniforms=uniforms)
        return {k: out[k] for k in ("fine_rgb_rays", "coarse_rgb_rays")}

    __call__ = forward
