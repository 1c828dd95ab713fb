"""Camera math: pinhole ray generation and spherical poses.

Counterpart of ``minimal_nerf_tpu/ops/cameras.py``, the NDC projection of
front-facing scenes included (``convert_to_ndc_rays``). Directions are intentionally NOT normalized: sample times are
measured in units of ``||d||``, as in the reference (``dataloader.py:36-43``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def focal_from_angle(width: float, camera_angle_x: float) -> float:
    """Focal length in pixels from the horizontal field of view."""
    return 0.5 * width / math.tan(0.5 * camera_angle_x)


def pixel_dirs(xs: torch.Tensor, ys: torch.Tensor, height: int, width: int,
               focal) -> torch.Tensor:
    """Camera-frame directions ``[(x-W/2)/f, -(y-H/2)/f, -1]`` -> ``[..., 3]``."""
    xs = torch.as_tensor(xs, dtype=torch.float32)
    ys = torch.as_tensor(ys, dtype=torch.float32, device=xs.device)
    return torch.stack(
        [(xs - width * 0.5) / focal, -(ys - height * 0.5) / focal,
         -torch.ones_like(xs)],
        dim=-1,
    )


def get_rays(height: int, width: int, focal, c2w,
             device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for every pixel: ``rays_o [H, W, 3]``, ``rays_d [H, W, 3]``."""
    c2w = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=device)
    i, j = torch.meshgrid(
        torch.arange(width, dtype=torch.float32, device=device),
        torch.arange(height, dtype=torch.float32, device=device),
        indexing="xy",
    )
    dirs = pixel_dirs(i, j, height, width, focal)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def rays_for_pixels(xs, ys, height: int, width: int, focal,
                    c2w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for pixel coordinates ``xs, ys [N]`` -> ``rays_o, rays_d [N, 3]``."""
    xs = torch.as_tensor(xs, dtype=torch.float32)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=xs.device)
    dirs = pixel_dirs(xs, ys, height, width, focal)
    rays_d = torch.sum(dirs[..., None, :] * c2w[..., :3, :3], dim=-1)
    rays_o = c2w[..., :3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def _trans_t(t: float) -> np.ndarray:
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """``[4, 4]`` camera-to-world pose on a sphere (reference
    ``nerf_helpers.py:279-284``)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ c2w


def spherical_poses(num_poses: int = 40, phi_deg: float = -30.0,
                    radius: float = 4.0) -> np.ndarray:
    """The reference's 360-degree orbit: ``[num_poses, 4, 4]`` poses at the
    azimuths ``linspace(-180, 180, num_poses + 1)[:-1]``."""
    angles = np.linspace(-180.0, 180.0, num_poses + 1)[:-1]
    return np.stack([pose_spherical(a, phi_deg, radius) for a in angles])


def convert_to_ndc_rays(o_rays: torch.Tensor, d_rays: torch.Tensor, focal, width: int,
                        height: int, near: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC ray projection for FRONT-FACING scenes (JAX ``convert_to_ndc_rays``,
    reference ``dataloader.py:45-76``): rays ``[..., 3]`` moved to the near
    plane, then projected; returns ``o_ndc``, ``d_ndc [..., 3]`` with
    ``d_ndc`` of unit length. No path of the Blender-synthetic scenes calls
    it; it keeps the reference's public surface."""
    t_near = -(near + o_rays[..., 2]) / d_rays[..., 2]
    o_rays = o_rays + t_near[..., None] * d_rays
    ox, oy, oz = o_rays[..., 0], o_rays[..., 1], o_rays[..., 2]
    dx, dy, dz = d_rays[..., 0], d_rays[..., 1], d_rays[..., 2]
    o_ndc = torch.stack([-1.0 * focal / (width / 2) * (ox / oz),
                         -1.0 * focal / (height / 2) * (oy / oz),
                         1.0 + (2 * near) / oz], dim=-1)
    d_ndc = torch.stack([-1.0 * focal / (width / 2) * ((dx / dz) - (ox / oz)),
                         -1.0 * focal / (height / 2) * ((dy / dz) - (oy / oz)),
                         (-2.0 * near) / oz], dim=-1)
    return o_ndc, d_ndc / torch.linalg.norm(d_ndc, dim=-1, keepdim=True)
