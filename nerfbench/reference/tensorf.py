"""Plain PyTorch reference of TensoRF's VM field (Chen, Xu, Geiger, Yu, Su,
TensoRF: Tensorial Radiance Fields, ECCV 2022, arXiv:2203.09517, sec. 3-4;
the authors' ``TensorVMSplit`` and ``MLPRender_Fea`` at
``configs/lego.txt``'s sizes), as a ``reference.nerf.Field``.

Written from the paper, the authors' code as published and the
configuration file (``configs/<name>.json``, its ``tensorf`` group),
independent of the package under test: it imports neither it nor JAX. The
draws, the sampling, the sorted union, the compositing, the loss and the
train steps are ``reference/nerf.py``'s, as they are; this file gives the
field and its optimizer:

- the box ``[-bound, bound]^3`` (the Blender ``aabb``); a point maps to
  ``xhat = (x - lo) * 2 / (hi - lo) - 1`` in ``[-1, 1]``;
- three modes with plane axes ``(0, 1)``, ``(0, 2)``, ``(1, 2)`` and line
  axes ``2``, ``1``, ``0``; each plane ``[1, R, N, N]`` and line ``[1, R,
  N, 1]`` sampled with ``F.grid_sample`` (bilinear, ``align_corners=True``):
  the plane at ``(xhat_w, xhat_h)``, the line at ``(0, xhat_l)``. The
  parameter tree stores them channel-last, ``planes [3, N, N, R]`` and
  ``lines [3, N, R]``; the one transpose ``planes[m].permute(2, 0, 1)``
  (``lines[m].permute(1, 0)``) gives TensoRF's layout;
- density: ``f = sum over modes and components of plane x line``,
  ``sigma = distance_scale * softplus(f + density_shift)`` (``25
  softplus(f - 10)``) inside the box, 0 outside, where no gradient reaches
  the factors;
- color: the 144 appearance products (mode-major) through ``basis_mat``
  (144 -> 27, no bias), then ``[a, d, PE(a, 2), PE(d, 2)]`` (``d`` the unit
  view direction; ``PE`` the sines then the cosines of ``v_c 2^f``, index
  ``c F + f``) through 150 -> 128 -> 128 -> 3 with biases and ReLU, a
  sigmoid; the products 0 outside the box;
- the optimizer: Adam, ``b1 = 0.9``, ``b2 = 0.99``, ``eps = 1e-8``; the
  factors at the schedule's learning rate, ``basis`` and the MLP at
  ``basis_lr_scale`` of it; ``w sign(p) / numel`` (``L1_reg_weight *
  density_L1()``'s gradient, ``numel`` one mode's plane or line) added to
  each density factor's gradient, ``w`` ``l1_initial`` before the update
  ``l1_switch`` (counted from 0) and ``l1_rest`` from it.

In float32 with TF32 off (the caller's ``reference.nerf.exact_float32``).
``Numerics`` set the basis and MLP matmul inputs (``"fp32"``, or the
control's ``"fp8"``, ``reference.nerf.matmul``) and a rounding of the
factors' products and of ``f`` (the control's ``"bf16"``).

Departures from TensoRF, each as the configuration's ``assumed`` states:

- the sampling of the repo's fast recipe: a 64^3 occupancy grid and 16 + 48
  hierarchical samples through the same field in both passes, in place of
  TensoRF's alpha mask, its box shrink and its fixed-step march; the loss
  the repo's summed coarse and fine MSE;
- the color computed at every point (TensoRF skips points of weight under
  1e-4);
- the factors at their final 300^3 from the start (TensoRF upsamples from
  128^3 over steps 2,000-7,000);
- the learning rates under the repo's per-epoch schedule (TensoRF decays
  every step);
- the program's bf16 matmul inputs for the basis and the MLP, which the
  check holds to this fp32 reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from nerfbench.reference import nerf as R

PLANE_AXES = ((0, 1), (0, 2), (1, 2))  # (w, h): grid_sample's x, y
LINE_AXES = (2, 1, 0)


@dataclasses.dataclass(frozen=True)
class Numerics:
    matmul: str = "fp32"            # "fp32" or "fp8"
    features: Optional[str] = None  # rounding of the products and of f: None or "bf16"


def _round(x: torch.Tensor, how: Optional[str]) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if how == "bf16" else x


def sample(params, x: torch.Tensor, t: Dict[str, Any], with_app: bool = True):
    """``(inside [P], f [P], prods [P, 3 R_c] or None)`` at points ``x [P,
    3]`` through ``grid_sample`` on TensoRF's layout."""
    bound = t["bound"]
    inside = ((x >= -bound) & (x <= bound)).all(dim=-1)
    xhat = (x - (-bound)) * (2.0 / (2.0 * bound)) - 1.0

    def factor(planes, lines, m):
        aw, ah = PLANE_AXES[m]
        plane = planes[m].permute(2, 0, 1)[None]            # [1, R, N, N]
        line = lines[m].permute(1, 0)[None, :, :, None]     # [1, R, N, 1]
        gp = torch.stack([xhat[:, aw], xhat[:, ah]], dim=-1).view(1, -1, 1, 2)
        gl = torch.stack([torch.zeros_like(xhat[:, 0]), xhat[:, LINE_AXES[m]]],
                         dim=-1).view(1, -1, 1, 2)
        pv = F.grid_sample(plane, gp, mode="bilinear", align_corners=True)[0, :, :, 0]
        lv = F.grid_sample(line, gl, mode="bilinear", align_corners=True)[0, :, :, 0]
        return (pv * lv).t()                                 # [P, R]

    f = sum(factor(params["density_planes"], params["density_lines"], m).sum(dim=1)
            for m in range(3))
    if not with_app:
        return inside, f, None
    prods = torch.cat([factor(params["app_planes"], params["app_lines"], m)
                       for m in range(3)], dim=1)
    return inside, f, torch.where(inside[:, None], prods, 0.0)


def frequencies(v: torch.Tensor, freqs: int) -> torch.Tensor:
    """TensoRF's ``positional_encoding``: sines then cosines of ``v_c 2^f``
    at index ``c freqs + f``."""
    bands = 2.0 ** torch.arange(freqs, dtype=torch.float32, device=v.device)
    pts = (v[..., None] * bands).reshape(*v.shape[:-1], freqs * v.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def _sigma(inside, f, t):
    sig = t["distance_scale"] * F.softplus(f + t["density_shift"])
    return torch.where(inside, sig, 0.0)


@dataclasses.dataclass(frozen=True)
class TensoRFAdam(R.Adam):
    """TensoRF's Adam over ``reference.nerf.leaves``' order: the learning
    rate scaled by ``scales[i]`` on leaf ``i``; ``w l1[i] sign(p)`` added
    to its gradient, ``w`` ``l1_weights[0]`` before the update
    ``l1_switch`` and ``l1_weights[1]`` from it."""
    scales: Tuple[float, ...] = ()
    l1: Tuple[float, ...] = ()
    l1_weights: Tuple[float, float] = (0.0, 0.0)
    l1_switch: int = 0

    @torch.no_grad()
    def apply(self, ps, mu, nu, lr, count: int) -> None:
        dev = lr.device
        bc1 = (1 - torch.tensor(self.b1) ** (count + 1)).to(dev)
        bc2 = (1 - torch.tensor(self.b2) ** (count + 1)).to(dev)
        w = self.l1_weights[0] if count < self.l1_switch else self.l1_weights[1]
        for p, m, v, scale, l1 in zip(ps, mu, nu, self.scales, self.l1):
            g = p.grad
            if l1:
                g = g + w * l1 * torch.sign(p)
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(lr * scale * (m / bc1) / (torch.sqrt(v / bc2) + self.eps))
            p.grad = None


def adam(t: Dict[str, Any]) -> TensoRFAdam:
    """The field's Adam on its tree; sorted, the leaves are ``app_lines``,
    ``app_planes``, ``basis``, ``density_lines``, ``density_planes``, then
    the MLP's ``b``, ``w`` of each layer."""
    n, rd, s = t["resolution"], t["density_components"], t["basis_lr_scale"]
    scales = (1.0, 1.0, s, 1.0, 1.0) + (s,) * 6
    l1 = (0.0, 0.0, 0.0, 1.0 / (n * rd), 1.0 / (n * n * rd)) + (0.0,) * 6
    return TensoRFAdam(b1=0.9, b2=0.99, eps=1e-8, scales=scales, l1=l1,
                       l1_weights=(t["l1_initial"], t["l1_rest"]), l1_switch=t["l1_switch"])


def tensorf_field(cfg: Dict) -> R.Field:
    """The field of ``cfg["tensorf"]``, the same in both passes."""
    t = cfg["tensorf"]

    def point(params, which, x, d, num: Numerics):
        lead = x.shape[:-1]
        inside, f, prods = sample(params, x.reshape(-1, 3), t)
        f, prods = _round(f, num.features), _round(prods, num.features)
        a = R.matmul(prods, params["basis"], num.matmul)
        dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        dn = dn[:, None, :].expand(*lead, 3).reshape(-1, 3)
        h = torch.cat([a, dn, frequencies(a, t["feature_pe"]), frequencies(dn, t["view_pe"])],
                      dim=-1)
        mlp = params["mlp"]
        for layer in mlp[:-1]:
            h = torch.relu(R.matmul(h, layer["w"], num.matmul) + layer["b"])
        rgb = torch.sigmoid(R.matmul(h, mlp[-1]["w"], num.matmul) + mlp[-1]["b"])
        return _sigma(inside, f, t).reshape(lead), rgb.reshape(*lead, 3)

    def density(params, x, num: Numerics):
        inside, f, _ = sample(params, x, t, with_app=False)
        return _sigma(inside, _round(f, num.features), t)

    return R.Field(samples=t, point=point, density=density, adam=adam(t))


def reference_numerics(cfg: Dict) -> Numerics:
    """fp32 matmuls and products: the check holds the program's bf16 matmul
    inputs (the configuration's precision) to fp32."""
    return Numerics("fp32", None)


def control_numerics(cfg: Dict) -> Numerics:
    """The control, one step below the configuration's bf16: fp8 matmul
    inputs (e4m3, e5m2 for gradients), the factors' products and ``f``
    rounded to bf16."""
    return Numerics("fp8", "bf16")
