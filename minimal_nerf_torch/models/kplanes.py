"""K-Planes' hybrid field for a static scene (Fridovich-Keil, Meanti,
Warburg, Recht, Kanazawa, K-Planes: Explicit Radiance Fields in Space,
Time, and Appearance, CVPR 2023, sec. 3-4; the authors' ``KPlaneField`` and
``interpolate_ms_features`` at ``configs/final/NeRF/nerf_hybrid.py``'s
sizes).

One field serves both render passes (``models.nerf.render_rays`` on
``{"coarse": params, "fine": params}``): the parameter tree is
``{"planes": [[3, N_s, N_s, C]] * S, "density": [w0, w1], "color": [w0,
w1, w2]}``, the planes channel-last (``kernels.kplane_sample``: scale
``s``'s plane ``c`` is K-Planes' ``[1, C, N_s, N_s]`` grid permuted to
``[N_s, N_s, C]``), the MLPs without biases (tiny-cuda-nn's fully fused
MLPs have none).

- A point of the box ``[-bound, bound]^3`` samples the planes
  (``kernels.kplane_sample``): per scale the product of its three planes'
  bilinear values, the scales' ``C`` features concatenated, ``S C`` in all
  (128); a point outside the box reads the border;
- the density MLP (ReLU hidden layer, linear output) maps them to
  ``geo_features + 1`` values: the first ``geo_features`` are the geometry
  features ``g``, the last the density's pre-activation ``h`` (the authors'
  ``split([geo_feat_dim, 1])``), density ``trunc_exp(h)``: ``exp(h)``, its
  gradient taken at ``min(h, 15)``;
- the color MLP reads ``[SH(d), g]`` (the unit view direction's spherical
  harmonics of ``sh_degree``, 16 at degree 4, as Instant-NGP's field):
  ReLU hidden layers, a sigmoid color.

Matmul inputs are rounded to the compute dtype with fp32 sums
(``models.ngp.mlp``); the planes, the features and their gradients stay
fp32. The sampling goes through the CUDA kernels on a card unless the
field is built for the plain path (``--kernel xla``); CPU tensors and that
path take autograd through ``kplane_sample.sample_plain``.

Training (``KPlanesField.adam_options``): Adam with ``b2 = 0.999``, ``eps
= 1e-15``, one learning rate on every leaf; K-Planes' total variation on
every plane of every scale (``tv_weight``; ``training.loop.adam_apply``'s
``tv``, its gradient added to the planes' gradients).

Spans (``utils.profiling``): ``nerf.kplanes.sample`` (the box mapping and
the sampling kernels), ``nerf.kplanes.mlp`` (both MLPs, SH and
``trunc_exp``); the TV term's gradient is ``nerf.kplanes.tv``
(``training.loop.adam_apply``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from minimal_nerf_torch.kernels import kplane_sample as kp
from minimal_nerf_torch.models.mlp import map_params
from minimal_nerf_torch.models.ngp import mlp
from minimal_nerf_torch.ops.encoding import sh_encode
from minimal_nerf_torch.utils import profiling

Params = Dict[str, Any]

FIELD = "kplanes"  # the field's name in a checkpoint's header and on the command line
TRUNC_EXP_MAX = 15.0  # trunc_exp's gradient is exp(min(h, 15))


@dataclasses.dataclass(frozen=True)
class KPlanesConfig:
    """The field's sizes (``nerf_hybrid.py``: ``resolution`` 64 at
    ``multiscale_res`` 1, 2, 4, 8, ``output_coordinate_dim`` 32,
    ``geo_feat_dim`` 15, the density MLP 128 -> 64 -> 16 and the color MLP
    (16 + 15) -> 64 -> 64 -> 3 of tiny-cuda-nn, SH of degree 4; the
    synthetic scenes' box 1.3) and its TV weight (``plane_tv_weight``)."""

    base_resolution: int = 64
    multiscale: Tuple[int, ...] = (1, 2, 4, 8)
    features: int = 32
    density_width: int = 64
    geo_features: int = 15
    color_width: int = 64
    color_layers: int = 2
    sh_degree: int = 4
    bound: float = 1.3
    tv_weight: float = 1e-4

    def to_dict(self) -> Dict[str, Any]:
        return dict(dataclasses.asdict(self), multiscale=list(self.multiscale))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KPlanesConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "multiscale" in kw:
            kw["multiscale"] = tuple(kw["multiscale"])
        return cls(**kw)

    @property
    def resolutions(self) -> Tuple[int, ...]:
        return tuple(self.base_resolution * m for m in self.multiscale)


def param_shapes(cfg: KPlanesConfig) -> Params:
    """The parameter tree with each leaf's shape: per scale the planes ``[3,
    N_s, N_s, C]``, each MLP weight ``[in, out]``."""
    feats, sh = len(cfg.multiscale) * cfg.features, cfg.sh_degree ** 2
    dw, geo, cw = cfg.density_width, cfg.geo_features, cfg.color_width
    return {"planes": [(3, r, r, cfg.features) for r in cfg.resolutions],
            "density": [(feats, dw), (dw, geo + 1)],
            "color": [(sh + geo, cw)] + [(cw, cw)] * (cfg.color_layers - 1) + [(cw, 3)]}


def init_kplanes(generator: torch.Generator, cfg: KPlanesConfig, device="cuda") -> Params:
    """K-Planes' initialization of the planes, ``U(0.1, 0.5)``
    (``init_grid_param``), then each MLP weight ``U(+-sqrt(6 / in))`` (He
    uniform), drawn in turn from ``generator``."""
    def uniform(shape, lo, hi):
        u = torch.rand(*shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        return (u * (hi - lo) + lo).to(device)

    shapes = param_shapes(cfg)
    he = lambda s: uniform(s, -math.sqrt(6.0 / s[0]), math.sqrt(6.0 / s[0]))  # noqa: E731
    return {"planes": [uniform(s, 0.1, 0.5) for s in shapes["planes"]],
            "density": [he(s) for s in shapes["density"]],
            "color": [he(s) for s in shapes["color"]]}


class TruncExp(torch.autograd.Function):
    """``exp(h)``, its gradient ``g exp(min(h, 15))`` (torch-ngp's
    ``trunc_exp``, which K-Planes' density takes)."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return torch.exp(h)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(h, max=TRUNC_EXP_MAX))


def trunc_exp(h: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(h)


class KPlanesField:
    """The field as the train step, the grid's update, the checkpoint and
    the render chunk see it (``minimal_nerf_torch.fields``); ``kernels``
    picks the CUDA kernels for CUDA tensors, or the plain sampling
    everywhere (``--kernel xla``)."""

    name = FIELD
    adam = {"b1": 0.9, "b2": 0.999, "eps": 1e-15}
    # nerf_hybrid.py's lr 0.01, decayed by the repo's per-epoch schedule to a
    # tenth over 300 epochs (its 30,000 steps of a Blender scene's 100
    # frames; K-Planes: a 512-step warmup, then a cosine to 0)
    lr = {"start_lr": 1e-2, "end_lr": 1e-3, "lr_decay_epochs": 300}
    mode, data_parallel = "full", False

    def __init__(self, cfg: KPlanesConfig = KPlanesConfig(), kernels: bool = True):
        self.cfg, self.kernels = cfg, kernels

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        return init_kplanes(generator, self.cfg, device)

    def shapes(self) -> Params:
        return param_shapes(self.cfg)

    def header(self) -> Dict[str, Any]:
        """What a checkpoint's header ``extra`` holds of the field."""
        return {"field": FIELD, FIELD: self.cfg.to_dict()}

    def features(self, params: Params, pts: torch.Tensor) -> torch.Tensor:
        """The planes' features ``[P, S C]`` at points ``pts [P, 3]``."""
        with profiling.span("nerf.kplanes.sample"):
            if self.kernels and pts.is_cuda:
                return kp.kplane_sample(pts, params["planes"], self.cfg.bound)
            return kp.sample_plain(pts.contiguous(), params["planes"], self.cfg.bound)

    def density(self, params: Params, pts: torch.Tensor, compute_dtype=None,
                grid_source=None) -> torch.Tensor:
        """The density ``[P]`` at points ``pts [P, 3]`` from the planes and
        the density MLP alone (the grid's update; one field serves every
        ``grid_source``)."""
        feats = self.features(params, pts)
        with profiling.span("nerf.kplanes.mlp"):
            h = mlp(params["density"], feats, compute_dtype)
            return trunc_exp(h[:, self.cfg.geo_features])

    def apply(self, params: Params, samples: torch.Tensor, direc: torch.Tensor,
              position_dim=None, direction_dim=None, compute_dtype=None):
        """The render hook (``models.mlp.nerf_mlp_apply``'s signature; the
        encoding sizes are unused): ``samples [N, S, 3]``, directions ``[N,
        3]`` -> density ``[N, S, 1]``, rgb ``[N, S, 3]``."""
        lead, geo = samples.shape[:-1], self.cfg.geo_features
        feats = self.features(params, samples.reshape(-1, 3))
        with profiling.span("nerf.kplanes.mlp"):
            h = mlp(params["density"], feats, compute_dtype)
            sh = sh_encode(direc / torch.linalg.norm(direc, dim=-1, keepdim=True),
                           self.cfg.sh_degree)
            sh = sh[:, None, :].expand(*lead, sh.shape[-1]).reshape(-1, sh.shape[-1])
            rgb = torch.sigmoid(mlp(params["color"], torch.cat([sh, h[:, :geo]], dim=-1),
                                    compute_dtype))
            sigma = trunc_exp(h[:, geo])
        return sigma.reshape(*lead, 1), rgb.reshape(*lead, 3)

    def hooks(self):
        """``(mlp_apply, render_fn)`` of the train step, the validation and
        the render chunk: this field in both passes of the plain render."""
        from minimal_nerf_torch.models.nerf import render_rays

        def render_fn(params, *args, **kwargs):
            return render_rays({"coarse": params, "fine": params}, *args, **kwargs)

        return self.apply, render_fn

    def adam_options(self, params: Params) -> Dict[str, Any]:
        """``training.loop.adam_apply``'s keywords for this field: its
        ``b1``, ``b2``, ``eps``; the TV weight on every plane."""
        zero = lambda _: 0.0  # noqa: E731
        return dict(self.adam,
                    tv={"planes": [self.cfg.tv_weight] * len(params["planes"]),
                        "density": map_params(zero, params["density"]),
                        "color": map_params(zero, params["color"])})
