"""Procedural analytic scenes: self-contained ground truth for training.

Counterpart of ``minimal_nerf_tpu/data/procedural.py`` (the ``field``,
``object``, ``thin`` and ``shell`` archetypes), with ``save_scene_tree`` to
write a Blender-style PNG tree and a command line to make one::

    python -m minimal_nerf_torch.data.procedural --out DIR [--scene object]

A scene is soft
colored spheres inside the ``[-1.5, 1.5]^3`` box, rendered with the same
transmittance compositing the model learns (``ops.rendering``) at a high
sample count, from poses on the reference's spherical orbit. The sphere
parameters come from ``np.random.default_rng(key)`` as in JAX, so both
packages build the same field; the integration jitter comes from a
``torch.Generator`` or from given uniforms.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from minimal_nerf_torch.data.synthetic import SyntheticScene
from minimal_nerf_torch.ops import cameras, rendering


@dataclasses.dataclass(frozen=True)
class SphereField:
    """K soft spheres: centers ``[K, 3]``, radii ``[K]``, colors ``[K, 3]``,
    peak densities ``[K]`` (float32 numpy arrays)."""

    centers: np.ndarray
    radii: np.ndarray
    colors: np.ndarray
    densities: np.ndarray

    @classmethod
    def random(cls, key: int = 0, num_spheres: int = 6) -> "SphereField":
        """Large spheres spread through the box."""
        rng = np.random.default_rng(key)
        return cls(
            centers=rng.uniform(-1.0, 1.0, (num_spheres, 3)).astype(np.float32),
            radii=rng.uniform(0.25, 0.6, num_spheres).astype(np.float32),
            colors=rng.uniform(0.1, 1.0, (num_spheres, 3)).astype(np.float32),
            densities=rng.uniform(20.0, 60.0, num_spheres).astype(np.float32),
        )

    @classmethod
    def random_object(cls, key: int = 0, num_spheres: int = 48) -> "SphereField":
        """A compact object: many small spheres inside a ~0.75-radius ball,
        the rest of the frustum empty (the Blender scenes' profile)."""
        rng = np.random.default_rng(key)
        dirs = rng.normal(size=(num_spheres, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-9
        r = 0.75 * rng.random(num_spheres) ** (1 / 3)  # uniform in the ball
        return cls(
            centers=(dirs * r[:, None]).astype(np.float32),
            radii=rng.uniform(0.06, 0.22, num_spheres).astype(np.float32),
            colors=rng.uniform(0.1, 1.0, (num_spheres, 3)).astype(np.float32),
            densities=rng.uniform(40.0, 120.0, num_spheres).astype(np.float32),
        )

    @classmethod
    def random_thin(cls, key: int = 0, num_branches: int = 6,
                    steps_per_branch: int = 36) -> "SphereField":
        """Thin branching structure (ficus/mic analogue): tiny beads along
        random-walk branches growing up from a trunk, sub-percent occupied
        volume inside the unit ball."""
        rng = np.random.default_rng(key)
        centers = [np.linspace([0.0, -0.85, 0.0], [0.0, -0.1, 0.0], 10)]
        for _ in range(num_branches):
            pos = np.array([0.0, rng.uniform(-0.3, 0.1), 0.0])
            step = rng.normal(size=3)
            step[1] = abs(step[1])  # grow upward
            step /= np.linalg.norm(step) + 1e-9
            pts = []
            for _ in range(steps_per_branch):
                step += 0.22 * rng.normal(size=3)
                step[1] = abs(step[1]) * 0.6 + 0.15
                step /= np.linalg.norm(step) + 1e-9
                pos = pos + 0.06 * step
                r = np.linalg.norm(pos)
                if r > 0.92:  # keep inside the unit ball
                    pos = pos * (0.92 / r)
                pts.append(pos.copy())
            centers.append(np.stack(pts))
        centers = np.concatenate(centers).astype(np.float32)
        k = centers.shape[0]
        return cls(
            centers=centers,
            radii=rng.uniform(0.015, 0.04, k).astype(np.float32),
            colors=rng.uniform(0.15, 1.0, (k, 3)).astype(np.float32),
            densities=rng.uniform(160.0, 320.0, k).astype(np.float32),
        )

    @classmethod
    def random_shell(cls, key: int = 0, num_spheres: int = 110) -> "SphereField":
        """Hollow shell (ship-hull/materials analogue): beads on an
        ellipsoid's surface, empty inside and outside."""
        rng = np.random.default_rng(key)
        dirs = rng.normal(size=(num_spheres, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-9
        axes = np.array([0.85, 0.45, 0.65])
        return cls(
            centers=(dirs * axes).astype(np.float32),
            radii=rng.uniform(0.05, 0.12, num_spheres).astype(np.float32),
            colors=rng.uniform(0.1, 1.0, (num_spheres, 3)).astype(np.float32),
            densities=rng.uniform(50.0, 140.0, num_spheres).astype(np.float32),
        )

    def field(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Analytic ``(density [..., 1], rgb [..., 3])`` at points ``[..., 3]``:
        ``sigma_k * sigmoid((r_k - |x - c_k|) / 0.02)`` summed over spheres,
        colors weighted by each sphere's density."""
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=pts.device)  # noqa: E731
        d2 = torch.sum((pts[..., None, :] - t(self.centers)) ** 2, dim=-1)  # [..., K]
        dist = torch.sqrt(d2 + 1e-12)
        sigma_k = torch.sigmoid((t(self.radii) - dist) / 0.02) * t(self.densities)
        sigma = torch.sum(sigma_k, dim=-1, keepdim=True)
        rgb = (sigma_k @ t(self.colors)) / (sigma + 1e-9)
        return sigma, torch.clamp(rgb, 0.0, 1.0)


# the --scene archetypes
SCENES = {"field": SphereField.random, "object": SphereField.random_object,
          "thin": SphereField.random_thin, "shell": SphereField.random_shell}


def render_analytic_view(field: SphereField, pose, height: int, width: int, focal: float,
                         num_samples: int = 256, near: float = 2.0, far: float = 6.0,
                         chunk: int = 16384, generator: Optional[torch.Generator] = None,
                         uniforms: Optional[torch.Tensor] = None,
                         device="cuda") -> torch.Tensor:
    """Ground-truth render of one view by dense stratified integration:
    ``[H, W, 3]`` uint8 on ``device`` (black background). ``uniforms
    [H*W, num_samples]`` replaces the jitter draws."""
    o, d = cameras.get_rays(height, width, focal, pose, device=device)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    out = []
    for i in range(0, o.shape[0], chunk):
        samples, ts = rendering.generate_coarse_samples(
            o[i: i + chunk], d[i: i + chunk], num_samples, near, far, generator=generator,
            uniforms=None if uniforms is None else uniforms[i: i + chunk])
        sigma, rgb = field.field(samples)
        weights = rendering.calculate_unnormalized_weights(sigma, rendering.generate_deltas(ts))
        out.append(rendering.estimate_ray_color(weights, rgb))
    im = torch.cat(out).reshape(height, width, 3)
    return (torch.clamp(im, 0.0, 1.0) * 255.0).to(torch.uint8)


def make_procedural_scene(split_frames=(("train", 20), ("val", 2), ("test", 4)),
                          height: int = 100, width: int = 100,
                          camera_angle_x: float = 0.6911112070083618,
                          field: Optional[SphereField] = None, seed: int = 0,
                          gt_samples: int = 256, scene: str = "field", chunk: int = 16384,
                          device="cuda"):
    """In-memory ``SyntheticScene``s for each split, on ``device``.

    Poses follow the spherical orbit with split-specific azimuth offsets and
    a slight elevation wobble, as in JAX. ``scene`` is a key of ``SCENES``.
    The jitter is drawn from a generator seeded with ``seed``.
    Returns ``(dict split -> SyntheticScene, field)``.
    """
    if field is None:
        field = SCENES[scene](seed)
    focal = cameras.focal_from_angle(width, camera_angle_x)
    gen = torch.Generator(device=device).manual_seed(seed)
    offsets = {"train": 0.0, "val": 3.1, "test": 7.3}
    scenes = {}
    for si, (split, n_frames) in enumerate(split_frames):
        images, poses = [], []
        for i in range(n_frames):
            theta = -180.0 + (360.0 / n_frames) * i + offsets.get(split, 0.0)
            phi = -30.0 + 10.0 * np.sin(2.1 * i + si)
            pose = cameras.pose_spherical(theta, phi, 4.0)
            images.append(render_analytic_view(field, pose, height, width, focal,
                                               num_samples=gt_samples, chunk=chunk,
                                               generator=gen, device=device))
            poses.append(pose)
        scenes[split] = SyntheticScene(
            images=torch.stack(images),
            poses=torch.as_tensor(np.stack(poses), dtype=torch.float32, device=device),
            focal=focal, camera_angle_x=camera_angle_x, split=split, base_dir="<procedural>")
    return scenes, field


def save_scene_tree(scenes, out_dir) -> Path:
    """Write ``transforms_{split}.json`` and ``{split}/r_{i}.png`` for each
    split of ``scenes`` (split -> ``SyntheticScene``), with the JSON keys
    and relative paths of the JAX package's writer, so that either package
    loads the other's tree (``SyntheticScene.load``)."""
    from minimal_nerf_torch.utils import imageio as mio

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for split, scene in scenes.items():
        (out / split).mkdir(exist_ok=True)
        images, poses = scene.images.cpu().numpy(), scene.poses.cpu().numpy()
        frames = []
        for i in range(scene.num_frames):
            mio.imwrite(out / split / f"r_{i}.png", images[i])
            frames.append({"file_path": f"./{split}/r_{i}", "rotation": 0.0,
                           "transform_matrix": np.asarray(poses[i]).tolist()})
        with open(out / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": scene.camera_angle_x, "frames": frames}, f)
    return out


def main(argv=None) -> Path:
    import argparse

    parser = argparse.ArgumentParser(description="Generate a procedural scene tree")
    parser.add_argument("--out", required=True)
    parser.add_argument("--size", type=int, default=100, help="image H=W")
    parser.add_argument("--train-frames", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gt-samples", type=int, default=256,
                        help="integration samples/ray for the ground-truth render "
                             "(lower for quick fixtures)")
    parser.add_argument("--chunk", type=int, default=65536,
                        help="rays per ground-truth render chunk (lower on the CPU)")
    parser.add_argument("--scene", choices=list(SCENES), default="field",
                        help="'object' = compact Blender-like cluster; 'thin' = branching "
                             "beads; 'shell' = hollow ellipsoid shell")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render the ground truth on (default cuda)")
    args = parser.parse_args(argv)
    from minimal_nerf_torch import resolve_device

    scenes, _ = make_procedural_scene(
        split_frames=(("train", args.train_frames), ("val", 2), ("test", 4)),
        height=args.size, width=args.size, seed=args.seed, scene=args.scene,
        gt_samples=args.gt_samples, chunk=args.chunk, device=resolve_device(args.device))
    out = save_scene_tree(scenes, args.out)
    print(f"wrote procedural scene to {out}")
    return out


if __name__ == "__main__":
    main()
