"""Occupancy-grid guided coarse sampling.

Counterpart of ``minimal_nerf_tpu/ops/occupancy.py``: a dense ``G^3`` grid of
density EMAs kept from the live model, thresholded into a bit-packed
occupancy mask that moves the coarse samples into occupied space (the sample
count per ray stays fixed; the grid changes where the samples land).

- **Words are int32.** The JAX package packs 32 cells into a ``uint32``
  word; PyTorch has no shifts on ``uint32``, so the port keeps the same bit
  pattern in ``int32`` (bit ``i & 31`` of word ``i >> 5`` is cell ``i``). An
  arithmetic right shift followed by ``& 1`` reads any bit, bit 31 included;
  ``words.numpy().view(np.uint32)`` gives the JAX words.
- **The sampler.** The coarse-sampler hook (``make_occupancy_sampler``)
  draws ``eps`` and, with in-bin jitter, ``frac``, then calls
  ``occupancy_sample``: on a CUDA tensor one launch of the hand-written
  kernel ``kernels/occupancy_sampler.py`` (cells, probe, weights, inverse
  CDF, in-bin placement, sort, samples), on a CPU tensor its plain version
  ``occupancy_sample_plain`` (``query_bin_weights_plain`` then
  ``occupancy_coarse_samples``, the JAX functions' math); any other device
  raises. ``query_bin_weights`` takes the kernel's weights output on the
  card. The standalone probe ``kernels/occupancy_probe.probe_bits`` (the
  counterpart of the JAX ``probe_bits_pallas``) stays; the plain versions
  read the bits through its plain version. The JAX package's
  ``probe_method`` names (``"auto"``, ``"gather"``, ``"onehot"``,
  ``"pallas"``) stay accepted config values, since checkpoints carry them,
  but pick nothing here: they choose among lowerings of the same bits on
  the TPU (``"onehot"`` works around its missing gather unit).
- **Draws.** ``occupancy_coarse_samples`` takes a ``torch.Generator`` or the
  pre-drawn ``(eps [N, 1], frac [N, S])``; ``update_grid_ema`` the jitter
  ``[G^3, 3]``, in ``[0, 1)`` as ``jax.random.uniform`` gives them, so tests
  can replay the JAX draws. Bins are found with ``torch.searchsorted(...,
  right=False)`` (JAX's ``side="left"``) and read with ``torch.gather`` where
  the JAX package uses one-hot selects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from minimal_nerf_torch.kernels import occupancy_probe, occupancy_sampler
from minimal_nerf_torch.models.mlp import nerf_mlp_apply
from minimal_nerf_torch.ops.rendering import draw_uniform
from minimal_nerf_torch.training.checkpoint import flatten_tree
from minimal_nerf_torch.utils import profiling

Params = Dict[str, Any]

PROBE_METHODS = ("auto", "gather", "onehot", "pallas")


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    """Occupancy-grid hyperparameters (the JAX fields and defaults; see
    ``minimal_nerf_tpu/ops/occupancy.py::OccupancyConfig`` for why each
    default was chosen).

    ``resolution`` cells per axis (``G^3`` divisible by 32); the grid covers
    ``[-bound, bound]^3``; a cell is occupied above ``max(threshold,
    rel_threshold * mean(ema))``; the EMA decays by ``decay`` per update,
    every ``update_every`` steps; every cell counts as occupied for the first
    ``warmup_steps``; ``num_bins`` uniform ray bins are probed; unoccupied
    in-bounds bins weigh ``floor`` (occupied 1, outside the box 0);
    ``in_bin_jitter`` draws each sample's place in its bin; ``grid_source``
    picks the net(s) whose density feeds the EMA; ``probe_method`` is kept
    for checkpoints and picks nothing in the port (module docstring).
    """

    resolution: int = 64
    bound: float = 3.2
    threshold: float = 1e-2
    rel_threshold: float = 1e-2
    decay: float = 0.9
    update_every: int = 16
    warmup_steps: int = 256
    num_bins: int = 64
    floor: float = 0.25
    in_bin_jitter: bool = True
    grid_source: str = "coarse"
    probe_method: str = "auto"

    _GRID_SOURCES = ("both", "coarse", "fine")

    def __post_init__(self):
        if (self.resolution ** 3) % 32:
            raise ValueError(f"resolution^3 must be divisible by 32, got {self.resolution}")
        if self.grid_source not in self._GRID_SOURCES:
            raise ValueError(f"unknown grid_source {self.grid_source!r}")
        if self.probe_method not in PROBE_METHODS:
            raise ValueError(f"unknown probe_method {self.probe_method!r}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OccupancyConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def init_grid(cfg: OccupancyConfig, device="cuda") -> torch.Tensor:
    """Fresh density-EMA grid: ``[G, G, G]`` float32 zeros."""
    g = cfg.resolution
    return torch.zeros((g, g, g), dtype=torch.float32, device=device)


def effective_threshold(ema: torch.Tensor, cfg: OccupancyConfig) -> torch.Tensor:
    """The density cutoff for "occupied": ``max(threshold, rel * mean(ema))``."""
    thr = torch.full((), cfg.threshold, dtype=torch.float32, device=ema.device)
    if cfg.rel_threshold <= 0:
        return thr
    return torch.maximum(thr, cfg.rel_threshold * torch.mean(ema))


def occupancy_mask(ema: torch.Tensor, cfg: OccupancyConfig, force_all=False) -> torch.Tensor:
    """``[G, G, G]`` bool: cell above the effective threshold, or every cell
    when ``force_all`` (warmup; a bool, or a bool tensor on the grid's
    device). No host value is read: the train step packs its grid inside a
    captured CUDA graph."""
    return (ema > effective_threshold(ema, cfg)) | force_all


def pack_occupancy(ema: torch.Tensor, cfg: OccupancyConfig, force_all=False) -> torch.Tensor:
    """The occupancy mask packed into ``[G^3 // 32]`` int32 words: bit
    ``i & 31`` of word ``i >> 5`` is cell ``i`` (C-order linear index
    ``(x * G + y) * G + z``), the JAX ``uint32`` words' bit pattern."""
    bits = occupancy_mask(ema, cfg, force_all).reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=ema.device)
    words = torch.sum(bits << shifts, dim=1)  # in [0, 2^32): wrap bit 31 to the sign
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def bin_cells(o_rays: torch.Tensor, d_rays: torch.Tensor, cfg: OccupancyConfig,
              num_bins: int, near: float, far: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid cell of each ray bin's midpoint ``o + t_mid * d`` (``t`` in
    units of ``|d|``): its linear index ``[N, B]`` int32 (clipped into the
    grid) and whether it lies inside the grid's box ``[N, B]`` bool."""
    g = cfg.resolution
    width = (far - near) / num_bins
    mids = near + (torch.arange(num_bins, dtype=o_rays.dtype, device=o_rays.device) + 0.5) * width
    pos = o_rays[:, None, :] + mids[None, :, None] * d_rays[:, None, :]  # [N, B, 3]
    scale = g / (2.0 * cfg.bound)
    v = torch.floor((pos + cfg.bound) * scale).to(torch.int32)
    in_bounds = torch.all((v >= 0) & (v < g), dim=-1)
    vc = torch.clamp(v, 0, g - 1)
    return ((vc[..., 0] * g + vc[..., 1]) * g + vc[..., 2]).contiguous(), in_bounds


def uniform_fallback(weights: torch.Tensor) -> torch.Tensor:
    """``weights [N, B]`` with every row that has no positive sum replaced
    by ones."""
    return torch.where(torch.sum(weights, dim=1, keepdim=True) > 0, weights,
                       torch.ones_like(weights))


def query_bin_weights_plain(occ_words: torch.Tensor, o_rays: torch.Tensor,
                            d_rays: torch.Tensor, cfg: OccupancyConfig, num_bins: int,
                            near: float, far: float) -> torch.Tensor:
    """``query_bin_weights`` in plain PyTorch on any device: ``bin_cells``,
    the plain probe, the weights and the uniform fallback."""
    lin, in_bounds = bin_cells(o_rays, d_rays, cfg, num_bins, near, far)
    occ = (occupancy_probe.probe_bits_plain(occ_words, lin) != 0) & in_bounds
    weights = torch.where(occ, 1.0, torch.where(in_bounds, cfg.floor, 0.0)).float()
    return uniform_fallback(weights)


def query_bin_weights(occ_words: torch.Tensor, o_rays: torch.Tensor, d_rays: torch.Tensor,
                      cfg: OccupancyConfig, num_bins: int, near: float, far: float,
                      ) -> torch.Tensor:
    """Per-ray occupancy weights ``[N, B]`` (float32) over ``num_bins``
    uniform bins of ``[near, far]``, probed at each bin's midpoint
    (``bin_cells``): occupied bins weigh 1, unoccupied in-bounds bins
    ``cfg.floor``, bins outside the grid's box 0; a ray with no positive
    weight falls back to uniform weights.

    CUDA tensors go through one launch of the sampler kernel (its weights
    alone), CPU tensors through ``query_bin_weights_plain``; any other
    device raises."""
    if o_rays.device.type == "cuda":
        consts = occupancy_sampler.bin_constants(cfg, num_bins, near, far)
        return occupancy_sampler.sample(occ_words, o_rays, d_rays, None, None, consts, 0,
                                        with_weights=True)[2]
    if o_rays.device.type == "cpu":
        occupancy_sampler.check_inputs(occ_words, o_rays, d_rays, None, None, cfg.resolution, 0)
        return query_bin_weights_plain(occ_words, o_rays, d_rays, cfg, num_bins, near, far)
    raise ValueError(f"no occupancy sampler implementation for device {o_rays.device}")


def occupancy_coarse_samples(o_rays: torch.Tensor, d_rays: torch.Tensor,
                             bin_weights: torch.Tensor, num_samples: int, near: float,
                             far: float, in_bin_jitter: bool = False,
                             generator: Optional[torch.Generator] = None,
                             uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified samples from a per-ray piecewise-constant bin distribution.

    Bins are picked by the inverse CDF of ``bin_weights`` at the grid
    ``arange(S) / S + eps`` (one ``eps ~ U(0, 1/S)`` per ray); inside its bin
    a sample lies at the exact CDF inverse, or with ``in_bin_jitter`` at an
    independent uniform ``frac`` (the times re-sorted after). ``uniforms =
    (eps [N, 1], frac [N, S])`` replaces the draws (``frac`` is read only
    with ``in_bin_jitter``). Returns ``samples [N, S, 3]``, ``ts [N, S, 1]``
    sorted along S.
    """
    eps_u, frac_u = uniforms if uniforms is not None else (None, None)
    n, b = bin_weights.shape
    dtype, dev = o_rays.dtype, o_rays.device
    width = (far - near) / b

    # an all-zero row falls back to uniform (query_bin_weights already
    # guarantees this; the function stays total)
    bw = uniform_fallback(bin_weights.to(dtype))
    cdf = torch.cumsum(bw, dim=1)
    cdf = cdf / (cdf[:, -1:] + 1e-10)

    eps = draw_uniform((n, 1), o_rays, generator, eps_u) / num_samples
    grid = torch.arange(num_samples, dtype=dtype, device=dev) / num_samples
    u = (grid[None, :] + eps).contiguous()  # [N, S], increasing, < 1
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u, right=False), max=b - 1)

    if in_bin_jitter:
        frac = draw_uniform((n, num_samples), o_rays, generator, frac_u)
    else:
        cdf_bounds = torch.cat([torch.zeros((n, 1), dtype=dtype, device=dev), cdf], dim=1)
        lo, hi = torch.gather(cdf_bounds, 1, idx), torch.gather(cdf_bounds, 1, idx + 1)
        denom = torch.where(hi - lo < 1e-10, torch.ones_like(hi), hi - lo)
        frac = torch.clamp((u - lo) / denom, 0.0, 1.0)

    ts = near + (idx.to(dtype) + frac) * width
    if in_bin_jitter:
        ts = torch.sort(ts, dim=1).values
    ts = ts[..., None]
    return o_rays[:, None, :] + ts * d_rays[:, None, :], ts


def occupancy_sample_plain(occ_words: torch.Tensor, o_rays: torch.Tensor,
                           d_rays: torch.Tensor, eps: torch.Tensor,
                           frac: Optional[torch.Tensor], cfg: OccupancyConfig,
                           num_samples: int, near: float, far: float,
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sampler kernel, on any device:
    ``query_bin_weights_plain`` over ``cfg.num_bins`` bins, then
    ``occupancy_coarse_samples`` on the draws ``eps [N, 1]`` and ``frac [N,
    S]`` (read only with ``cfg.in_bin_jitter``). Returns ``(samples [N, S,
    3], ts [N, S, 1], weights [N, B])``."""
    weights = query_bin_weights_plain(occ_words, o_rays, d_rays, cfg, cfg.num_bins, near, far)
    samples, ts = occupancy_coarse_samples(o_rays, d_rays, weights, num_samples, near, far,
                                           in_bin_jitter=cfg.in_bin_jitter,
                                           uniforms=(eps, frac))
    return samples, ts, weights


def occupancy_sample(occ_words: torch.Tensor, o_rays: torch.Tensor, d_rays: torch.Tensor,
                     eps: torch.Tensor, frac: Optional[torch.Tensor], cfg: OccupancyConfig,
                     num_samples: int, near: float, far: float, with_weights: bool = False,
                     ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The occupancy coarse samples of rays ``o, d [N, 3]`` on the draws
    ``eps [N, 1]`` and, exactly when ``cfg.in_bin_jitter``, ``frac [N, S]``:
    ``(samples [N, S, 3], ts [N, S, 1], weights [N, B] if with_weights else
    None)``. CUDA tensors go through one launch of the sampler kernel, CPU
    tensors through ``occupancy_sample_plain``; any other device raises."""
    if (frac is not None) != cfg.in_bin_jitter:
        raise ValueError(f"frac is drawn exactly with in-bin jitter (in_bin_jitter="
                         f"{cfg.in_bin_jitter}, frac {'given' if frac is not None else 'None'})")
    if o_rays.device.type == "cuda":
        consts = occupancy_sampler.bin_constants(cfg, cfg.num_bins, near, far)
        return occupancy_sampler.sample(occ_words, o_rays, d_rays, eps, frac, consts,
                                        num_samples, with_weights)
    if o_rays.device.type == "cpu":
        occupancy_sampler.check_inputs(occ_words, o_rays, d_rays, eps, frac, cfg.resolution,
                                       num_samples)
        samples, ts, weights = occupancy_sample_plain(occ_words, o_rays, d_rays, eps, frac,
                                                      cfg, num_samples, near, far)
        return samples, ts, weights if with_weights else None
    raise ValueError(f"no occupancy sampler implementation for device {o_rays.device}")


def make_occupancy_sampler(occ_words: torch.Tensor, cfg: OccupancyConfig) -> Callable:
    """A ``coarse_sampler`` hook (signature of
    ``rendering.generate_coarse_samples``) concentrating the coarse samples
    in the occupied bins of the packed grid ``occ_words``: it draws ``eps
    [N, 1]`` and then, with in-bin jitter, ``frac [N, S]`` from
    ``generator`` (or takes ``uniforms = (eps, frac)``), and calls
    ``occupancy_sample`` on the rays made contiguous (a batch's origins are
    its camera's position expanded, ``ops.cameras.rays_for_pixels``), in the
    span ``nerf.occupancy.sample``."""
    def sampler(o_rays, d_rays, num_samples, near, far, generator=None, uniforms=None):
        with profiling.span("nerf.occupancy.sample"):
            eps_u, frac_u = uniforms if uniforms is not None else (None, None)
            o_rays, d_rays = o_rays.contiguous(), d_rays.contiguous()
            n = o_rays.shape[0]
            eps = draw_uniform((n, 1), o_rays, generator, eps_u)
            frac = (draw_uniform((n, num_samples), o_rays, generator, frac_u)
                    if cfg.in_bin_jitter else None)
            samples, ts, _ = occupancy_sample(occ_words, o_rays, d_rays, eps, frac, cfg,
                                              num_samples, near, far)
        return samples, ts

    return sampler


@torch.no_grad()
def update_grid_ema(ema: torch.Tensor, params: Params, position_dim: int, direction_dim: int,
                    cfg: OccupancyConfig, generator: Optional[torch.Generator] = None,
                    compute_dtype=None, jitter: Optional[torch.Tensor] = None,
                    density_fn: Optional[Callable] = None) -> torch.Tensor:
    """One EMA update, ``max(decay * ema, sigma)``: the density of the net(s)
    of ``cfg.grid_source`` (max over both for ``"both"``) at one jittered
    point per cell, through the plain ``nerf_mlp_apply`` whatever kernel
    trains the model; or, for a model of one field, ``density_fn(pts [G^3,
    3]) -> [G^3]`` (``models.ngp.NGPField.density``), whatever the grid
    source. ``jitter [G^3, 3]`` replaces the draws. Returns a new ``[G, G,
    G]`` tensor; no gradient.
    """
    g = cfg.resolution
    total = g ** 3
    cell = 2.0 * cfg.bound / g
    dev = ema.device
    centers = -cfg.bound + (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) * cell
    xx, yy, zz = torch.meshgrid(centers, centers, centers, indexing="ij")
    pts = torch.stack([xx, yy, zz], dim=-1).reshape(total, 3)
    u = draw_uniform((total, 3), ema, generator, jitter)
    pts = pts + (u - 0.5) * cell
    if density_fn is not None:
        return torch.maximum(ema * cfg.decay, density_fn(pts).float().reshape(g, g, g))
    pts = pts[:, None, :]  # [G^3, 1, 3]: one point per "ray"
    # density does not depend on the direction (its head reads the trunk
    # before the direction features join); any unit direction serves
    dirs = torch.zeros((total, 3), dtype=torch.float32, device=dev)
    dirs[:, 2] = -1.0
    nets = ("coarse", "fine") if cfg.grid_source == "both" else (cfg.grid_source,)
    sigma = None
    for name in nets:
        density, _ = nerf_mlp_apply(params[name], pts, dirs, position_dim, direction_dim,
                                    compute_dtype=compute_dtype)
        density = density[..., 0].float()
        sigma = density if sigma is None else torch.maximum(sigma, density)
    return torch.maximum(ema * cfg.decay, sigma.reshape(g, g, g))


def bake_grid(params: Params, position_dim: int, direction_dim: int, cfg: OccupancyConfig,
              generator: Optional[torch.Generator] = None, compute_dtype=None,
              passes: int = 4, jitters=None, density_fn: Optional[Callable] = None
              ) -> torch.Tensor:
    """An occupancy grid baked from a trained model with no grid history:
    the max over ``passes`` independently jittered density probes per cell
    (no decay), on the parameters' device. ``jitters``, one ``[G^3, 3]`` per
    pass, replaces the draws; ``density_fn`` is ``update_grid_ema``'s."""
    bake_cfg = dataclasses.replace(cfg, decay=1.0)
    ema = init_grid(cfg, flatten_tree(params)[0].device)
    for i in range(passes):
        ema = update_grid_ema(ema, params, position_dim, direction_dim, bake_cfg, generator,
                              compute_dtype, jitter=None if jitters is None else jitters[i],
                              density_fn=density_fn)
    return ema
