"""The inputs of every cell, made from ``--seed`` on the device.

One general generator for the traffic files beside it (``<traffic>.json``):
the training scene, the weights, the occupancy grid, the served poses and
their frame seeds. The same seed gives the same inputs; every piece comes
from a generator of its own (``subseed``), made in a few large calls in the
type it is served in. Copies, not imports, of what the package had for
this (``bench_scene``'s random uint8 frames; the render CLI's orbit poses,
``ops/cameras.py::pose_spherical``; ``init_linear``'s uniform init with a
gain and ``chip_smoke.py``'s +0.5 density bias).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

SCENE, WEIGHTS, GRID, POSES = 1, 2, 3, 4


def subseed(seed: int, tag: int) -> int:
    """A 63-bit seed for the generator of one piece of a cell's inputs."""
    state = np.random.SeedSequence([int(seed), tag]).generate_state(2, np.uint32)
    return ((int(state[0]) << 32) | int(state[1])) >> 1


def focal_from_angle(width: int, camera_angle_x: float) -> float:
    return 0.5 * width / math.tan(0.5 * camera_angle_x)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """``[4, 4]`` camera-to-world pose on a sphere around the origin,
    looking at it (the Blender scenes' orbit convention)."""
    ph, th = phi_deg / 180.0 * np.pi, theta_deg / 180.0 * np.pi
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rot_phi = np.array([[1, 0, 0, 0], [0, np.cos(ph), -np.sin(ph), 0],
                        [0, np.sin(ph), np.cos(ph), 0], [0, 0, 0, 1]], dtype=np.float32)
    rot_theta = np.array([[np.cos(th), 0, -np.sin(th), 0], [0, 1, 0, 0],
                          [np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]], dtype=np.float32)
    c2w = rot_theta @ (rot_phi @ trans)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32)
    return flip @ c2w


def orbit_poses(seed: int, count: int, traffic: Dict[str, Any], device) -> torch.Tensor:
    """``count`` poses on the orbit of ``traffic`` (``radius``,
    ``phi_deg``), their azimuths uniform in ``[-180, 180)``."""
    rng = np.random.default_rng(subseed(seed, POSES))
    thetas = rng.uniform(-180.0, 180.0, count)
    poses = np.stack([pose_spherical(t, traffic["phi_deg"], traffic["radius"]) for t in thetas])
    return torch.from_numpy(poses).to(device)


def frame_seeds(seed: int, count: int) -> List[int]:
    """The render draws' seed of each request."""
    rng = np.random.default_rng(subseed(seed, POSES + 100))
    return [int(s) for s in rng.integers(0, 2 ** 62, count)]


def scene(seed: int, traffic: Dict[str, Any], device):
    """``(images uint8 [F, H, W, 3], poses [F, 4, 4], focal)``: random
    frames, as many as the traffic's ``frames``, each from a pose of the
    orbit."""
    f, h, w = traffic["frames"], traffic["height"], traffic["width"]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, SCENE))
    images = torch.randint(0, 256, (f, h, w, 3), generator=gen, dtype=torch.uint8,
                           device=device)
    return images, orbit_poses(seed, f, traffic, device), focal_from_angle(
        w, traffic["camera_angle_x"])


def mlp_shapes(nerf: Dict[str, Any]) -> Dict[str, Any]:
    """The parameter tree of one MLP with each leaf's ``(in, out)`` or
    ``(out,)`` shape: ``{"w": [in, out], "b": [out]}`` per layer. The
    trunk's ``trunk_layers`` ReLU layers read the position encoding first;
    the ``feature_layers`` read it again beside the trunk's output (the
    skip), the last of them linear."""
    pe, de = 6 * nerf["position_dim"], 6 * nerf["direction_dim"]
    h, r = nerf["width"], nerf["rgb_width"]
    lin = lambda i, o: {"w": (i, o), "b": (o,)}  # noqa: E731
    return {"trunk": [lin(pe, h)] + [lin(h, h)] * (nerf["trunk_layers"] - 1),
            "feature": [lin(h + pe, h)] + [lin(h, h)] * (nerf["feature_layers"] - 1),
            "density": lin(h, 1),
            "rgb": [lin(h + de, r), lin(r, 3)]}


def weights(seed: int, nerf: Dict[str, Any], spec: Dict[str, Any], device) -> Dict[str, Any]:
    """The coarse and fine MLPs, fp32: every weight ``U(+-gain/sqrt(in))``,
    every bias ``U(+-1/sqrt(in))``, plus ``density_bias`` on the density
    head's bias, all from one draw of the generator."""
    shapes = mlp_shapes(nerf)
    layers = []

    def collect(tree):
        if isinstance(tree, dict) and "w" in tree:
            layers.append(tree)
        elif isinstance(tree, dict):
            for k in ("trunk", "feature", "density", "rgb"):
                collect(tree[k])
        else:
            for t in tree:
                collect(t)

    collect(shapes)
    total = 2 * sum(math.prod(s["w"]) + math.prod(s["b"]) for s in layers)
    gen = torch.Generator(device=device).manual_seed(subseed(seed, WEIGHTS))
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    pos = [0]

    def take(shape, scale):
        n = math.prod(shape)
        out = (u[pos[0]:pos[0] + n] * scale).reshape(shape).clone()
        pos[0] += n
        return out

    def build(tree):
        if isinstance(tree, dict) and "w" in tree:
            bound = 1.0 / math.sqrt(tree["w"][0])
            return {"w": take(tree["w"], spec["gain"] * bound), "b": take(tree["b"], bound)}
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return [build(t) for t in tree]

    params = {name: build(shapes) for name in ("coarse", "fine")}
    for mlp in params.values():
        mlp["density"]["b"] += spec["density_bias"]
    return params


def grid(seed: int, occupancy: Dict[str, Any], spec: Dict[str, Any], device) -> torch.Tensor:
    """A density grid ``[G, G, G]`` over the occupancy box: ``density``
    inside a seeded object (the union of ``spheres`` balls, centers within
    ``center_extent`` of the origin, radii in ``radius_range``), 0 outside."""
    rng = np.random.default_rng(subseed(seed, GRID))
    k = spec["spheres"]
    centers = torch.tensor(rng.uniform(-spec["center_extent"], spec["center_extent"], (k, 3)),
                           dtype=torch.float32, device=device)
    radii = torch.tensor(rng.uniform(*spec["radius_range"], k), dtype=torch.float32,
                         device=device)
    g, bound = occupancy["resolution"], occupancy["bound"]
    c = -bound + (torch.arange(g, dtype=torch.float32, device=device) + 0.5) * (2.0 * bound / g)
    pts = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), dim=-1)
    dist = torch.linalg.norm(pts[..., None, :] - centers, dim=-1)
    inside = torch.any(dist < radii, dim=-1)
    return torch.where(inside, spec["density"], 0.0).float()
