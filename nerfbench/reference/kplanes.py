"""Plain PyTorch reference of K-Planes' hybrid field for a static scene
(Fridovich-Keil, Meanti, Warburg, Recht, Kanazawa, K-Planes: Explicit
Radiance Fields in Space, Time, and Appearance, CVPR 2023,
arXiv:2301.10241, sec. 3-4; the authors' ``KPlaneField``,
``interpolate_ms_features`` and ``compute_plane_tv`` at
``configs/final/NeRF/nerf_hybrid.py``'s sizes), as a
``reference.nerf.Field``.

Written from the paper, the authors' code as published and the
configuration file (``configs/<name>.json``, its ``kplanes`` group),
independent of the package under test: it imports neither it nor JAX. The
draws, the sampling, the sorted union, the compositing, the loss and the
train steps are ``reference/nerf.py``'s, the spherical harmonics and the
bias-free MLP ``reference/ngp.py``'s, as they are; this file gives the field
and its optimizer:

- the box ``[-bound, bound]^3`` (the synthetic scenes' ``aabb``); a point
  maps to ``xhat = (x - a0) * 2 / (a1 - a0) - 1``;
- per scale ``N_s = base_resolution * m`` (``multiscale``), three planes
  over the axis pairs ``(0, 1)``, ``(0, 2)``, ``(1, 2)``, each ``[1, C,
  N_s, N_s]`` sampled with ``F.grid_sample`` (bilinear,
  ``align_corners=True``, ``padding_mode="border"``: the authors'
  ``grid_sample_wrapper``) at ``(xhat_w, xhat_h)``; the scale's feature the
  product of its three planes' values, the scales' concatenated. The
  parameter tree stores each scale's planes channel-last ``[3, N_s, N_s,
  C]``; the one transpose ``planes[s].permute(0, 3, 1, 2)`` gives K-Planes'
  three ``[1, C, N_s, N_s]`` grids as one batch;
- the density MLP (``features * scales -> density_width -> geo_features +
  1``, ReLU, no biases): the first ``geo_features`` outputs are the geometry
  features ``g``, the last ``h``, density ``trunc_exp(h)`` (``exp(h)``, its
  gradient ``exp(min(h, 15))``);
- the color MLP on ``[SH(d), g]`` (``d`` the unit view direction, SH of
  degree 4): ``-> color_width -> color_width -> 3``, ReLU, no biases, a
  sigmoid;
- the optimizer: Adam, ``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-15``, one
  learning rate on every leaf; ``tv_weight * sum of compute_plane_tv`` over
  every plane of every scale (the authors' ``PlaneTV``) entering through its
  gradient, taken by autograd and added to each plane's gradient.

In float32 with TF32 off (the caller's ``reference.nerf.exact_float32``).
``Numerics`` set the MLPs' matmul inputs (``"fp32"``, or the control's
``"fp8"``, ``reference.nerf.matmul``) and a rounding of the planes'
features (the control's ``"bf16"``).

Departures from K-Planes, each as the configuration's ``assumed`` states:

- the sampling of the repo's fast recipe: a 64^3 occupancy grid and 16 + 48
  hierarchical samples through the same field in both passes, in place of
  K-Planes' two proposal fields, its 256 + 128 proposal samples and 48
  final samples, and its histogram and distortion losses; the loss the
  repo's summed coarse and fine MSE;
- the learning rate under the repo's per-epoch schedule (K-Planes: a
  512-step warmup, then a cosine over 30,000 steps);
- the program's bf16 matmul inputs for the MLPs (K-Planes: fp16 autocast
  and fp16 tiny-cuda-nn MLPs), which the check holds to this fp32
  reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from nerfbench.reference import nerf as R
from nerfbench.reference import ngp as RN

PLANE_AXES = ((0, 1), (0, 2), (1, 2))  # (w, h): grid_sample's x, y


@dataclasses.dataclass(frozen=True)
class Numerics:
    matmul: str = "fp32"            # "fp32" or "fp8"
    features: Optional[str] = None  # rounding of the planes' features: None or "bf16"


def features(planes, x: torch.Tensor, k: Dict[str, Any]) -> torch.Tensor:
    """``[P, S C]``: the scales' plane products at points ``x [P, 3]``
    through ``grid_sample`` on K-Planes' layout, a scale's three ``[1, C, N,
    N]`` planes as one batch of 3."""
    bound = k["bound"]
    xhat = (x - (-bound)) * (2.0 / (2.0 * bound)) - 1.0
    coords = torch.stack([torch.stack([xhat[:, aw], xhat[:, ah]], dim=-1)
                          for aw, ah in PLANE_AXES]).view(3, -1, 1, 2)
    out = []
    for scale in planes:
        grids = scale.permute(0, 3, 1, 2)                                  # [3, C, N, N]
        v = F.grid_sample(grids, coords, mode="bilinear", align_corners=True,
                          padding_mode="border")[..., 0]                   # [3, C, P]
        out.append((v[0] * v[1] * v[2]).t())
    return torch.cat(out, dim=1)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return torch.exp(h)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        return g * torch.exp(h.clamp(max=15.0))


def trunc_exp(h: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(h)


def compute_plane_tv(t: torch.Tensor) -> torch.Tensor:
    """The authors' ``compute_plane_tv`` of a grid ``[B, C, H, W]``."""
    batch, c, h, w = t.shape
    count_h, count_w = batch * c * (h - 1) * w, batch * c * h * (w - 1)
    h_tv = torch.square(t[..., 1:, :] - t[..., :h - 1, :]).sum()
    w_tv = torch.square(t[..., :, 1:] - t[..., :, :w - 1]).sum()
    return 2 * (h_tv / count_h + w_tv / count_w)


def plane_tv(planes) -> torch.Tensor:
    """``PlaneTV``'s sum over every plane ``[N, N, C]`` of ``planes``, each
    on K-Planes' layout."""
    return sum(compute_plane_tv(plane.permute(2, 0, 1)[None]) for plane in planes)


@dataclasses.dataclass(frozen=True)
class KPlanesAdam(R.Adam):
    """K-Planes' Adam over ``reference.nerf.leaves``' order: ``tv_weight``
    times the gradient of ``compute_plane_tv`` (autograd) added to the
    gradient of each leaf marked in ``planes``."""
    planes: tuple = ()
    tv_weight: float = 0.0

    @torch.no_grad()
    def apply(self, ps, mu, nu, lr, count: int) -> None:
        for p, is_plane in zip(ps, self.planes):
            if is_plane and self.tv_weight:
                with torch.enable_grad():
                    qs = [plane.detach().requires_grad_(True) for plane in p]
                    tv = torch.autograd.grad(self.tv_weight * plane_tv(qs), qs)
                for grad, t in zip(p.grad, tv):
                    grad.add_(t)
        super().apply(ps, mu, nu, lr, count)


def adam(k: Dict[str, Any]) -> KPlanesAdam:
    """The field's Adam on its tree; sorted, the leaves are the color MLP's
    weights, the density MLP's, then the planes scale by scale."""
    leaves = 1 + k["color_layers"] + 2
    return KPlanesAdam(b1=0.9, b2=0.999, eps=1e-15,
                       planes=(False,) * leaves + (True,) * len(k["multiscale"]),
                       tv_weight=k["tv_weight"])


def _round(x: torch.Tensor, how: Optional[str]) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if how == "bf16" else x


def kplanes_field(cfg: Dict) -> R.Field:
    """The field of ``cfg["kplanes"]``, the same in both passes."""
    k = cfg["kplanes"]
    geo = k["geo_features"]

    def point(params, which, x, d, num: Numerics):
        lead = x.shape[:-1]
        f = _round(features(params["planes"], x.reshape(-1, 3), k), num.features)
        h = RN.mlp(params["density"], f, num.matmul)
        dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        sh = RN.spherical_harmonics(dn)[:, None, :].expand(*lead, 16).reshape(-1, 16)
        rgb = torch.sigmoid(RN.mlp(params["color"], torch.cat([sh, h[:, :geo]], dim=-1),
                                   num.matmul))
        return trunc_exp(h[:, geo]).reshape(lead), rgb.reshape(*lead, 3)

    def density(params, x, num: Numerics):
        f = _round(features(params["planes"], x, k), num.features)
        return trunc_exp(RN.mlp(params["density"], f, num.matmul)[:, geo])

    return R.Field(samples=k, point=point, density=density, adam=adam(k))


def reference_numerics(cfg: Dict) -> Numerics:
    """fp32 matmuls and features: the check holds the program's bf16 matmul
    inputs (the configuration's precision) to fp32."""
    return Numerics("fp32", None)


def control_numerics(cfg: Dict) -> Numerics:
    """The control, one step below the configuration's bf16: fp8 matmul
    inputs (e4m3, e5m2 for gradients) and the planes' features rounded to
    bf16."""
    return Numerics("fp8", "bf16")
