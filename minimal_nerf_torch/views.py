"""View reconstruction and 360-degree view synthesis.

Counterpart of ``minimal_nerf_tpu/views.py``. A view is swept in ray chunks
by a plain Python loop (PyTorch runs eagerly, so there is nothing to trace);
chunk ``i`` of a frame draws its samples from a ``torch.Generator`` seeded
from ``(frame seed, i)``, so a frame renders the same whatever else runs.
A ``render_chunk`` is ``(o [C, 3], d [C, 3], generator) -> rgb [C, 3]``.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from minimal_nerf_torch.models.nerf import NeRFConfig, render_rays
from minimal_nerf_torch.ops import cameras

# Blender-synthetic default horizontal FoV (reference nerf_helpers.py:163)
DEFAULT_CAM_ANGLE_X = 0.6911112070083618


def mix_seed(*ints: int) -> int:
    """A 63-bit seed mixed from integers (``numpy.random.SeedSequence``)."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def chunk_generator(frame_seed: int, chunk_index: int, device) -> torch.Generator:
    """The generator of chunk ``chunk_index`` of the frame with ``frame_seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(frame_seed, chunk_index))
    return g


def resolve_inference_kernel(kernel: str, train_cfg=None, device="cuda") -> str:
    """Resolve an inference ``--kernel`` choice to ``"fused"`` or ``"xla"``.

    ``"xla"`` names the plain path (``models.nerf.render_rays``), as in the JAX
    package. ``"auto"`` prefers the kernel the checkpoint trained under: on a
    CUDA device a fused- or auto-trained checkpoint renders through
    ``"fused"``; on the CPU ``"auto"`` takes the plain path and says so when
    the checkpoint trained under a kernel. ``"pallas"`` (the point-level MLP
    kernel) is not ported yet and raises.
    """
    trained = getattr(train_cfg, "kernel", "auto") if train_cfg is not None else "auto"
    choice = kernel if kernel != "auto" else None
    if choice is None:
        if torch.device(device).type == "cuda":
            choice = "fused" if trained in ("auto", "fused") else trained
        else:
            if trained in ("pallas", "fused"):
                print(f"[views] checkpoint trained under the {trained!r} kernel is "
                      "rendered through the plain path on the CPU; expect a "
                      "train/inference numerics mismatch", file=sys.stderr)
            choice = "xla"
    if choice == "pallas":
        raise NotImplementedError(
            "the point-level MLP kernel (--kernel pallas) is not ported yet "
            "(ROADMAP Queue 1 item 5, point-level MLP kernel)")
    if choice not in ("xla", "fused"):
        raise ValueError(f"unknown kernel {kernel!r}")
    return choice


def _to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    # clip then truncate (reference nerf_helpers.py:208-210)
    return torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)


def view_reconstruction(render_chunk: Callable, all_o_rays: torch.Tensor,
                        all_d_rays: torch.Tensor, chunk: int = 4096,
                        seed: int = 0) -> np.ndarray:
    """Render ``[H, W, 3]`` rays chunk by chunk -> ``[H, W, 3]`` uint8."""
    h, w, c = all_o_rays.shape
    o = all_o_rays.reshape(h * w, c)
    d = all_d_rays.reshape(h * w, c)
    out = []
    with torch.no_grad():
        for i, lo in enumerate(range(0, h * w, chunk)):
            g = chunk_generator(seed, i, o.device)
            out.append(render_chunk(o[lo:lo + chunk], d[lo:lo + chunk], g))
    return _to_uint8(torch.cat(out)).reshape(h, w, 3).cpu().numpy()


def render_poses_batched(render_chunk: Callable, poses, height: int, width: int,
                         focal, chunk: int = 4096,
                         frame_seeds: Optional[Sequence[int]] = None,
                         device="cuda") -> Iterator[np.ndarray]:
    """Yield one ``[H, W, 3]`` uint8 frame per pose, in order.

    Rays are made on ``device`` for each chunk's own pixels; frame ``i``
    seeds its chunks from ``frame_seeds[i]`` (default ``mix_seed(0, i)``).
    """
    poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=device)
    n_pix = height * width
    if frame_seeds is None:
        frame_seeds = [mix_seed(0, i) for i in range(poses.shape[0])]
    with torch.no_grad():
        for f in range(poses.shape[0]):
            out = []
            for i, lo in enumerate(range(0, n_pix, chunk)):
                flat = torch.arange(lo, min(lo + chunk, n_pix), device=device)
                o, d = cameras.rays_for_pixels(
                    (flat % width).float(), (flat // width).float(),
                    height, width, focal, poses[f])
                g = chunk_generator(frame_seeds[f], i, device)
                out.append(render_chunk(o.contiguous(), d.contiguous(), g))
            yield _to_uint8(torch.cat(out)).reshape(height, width, 3).cpu().numpy()


def make_fine_render_chunk(params, config: NeRFConfig, compute_dtype=None,
                           mlp_apply=None, render_fn=None,
                           coarse_sampler=None) -> Callable:
    """The standard ``render_chunk``: hierarchical render, fine color out.

    ``render_fn`` overrides the render (e.g. ``make_fused_render_fn()``);
    the default is the plain ``models.nerf.render_rays``.
    """
    render = render_fn or render_rays

    def render_chunk(o, d, generator):
        out = render(params, config, o, d, generator, compute_dtype=compute_dtype,
                     mlp_apply=mlp_apply, coarse_sampler=coarse_sampler)
        return out["fine_rgb_rays"]

    return render_chunk


def orbit_views(render_chunk: Callable, height: int = 800, width: int = 800,
                radius: float = 4.0, cam_angle_x: float = DEFAULT_CAM_ANGLE_X,
                chunk: int = 4096, num_poses: int = 40, seed: int = 0,
                device="cuda") -> Iterator[np.ndarray]:
    """The reference's 360-degree orbit (phi -30, ``radius``), frame by frame."""
    poses = cameras.spherical_poses(num_poses=num_poses, radius=radius)
    focal = cameras.focal_from_angle(width, cam_angle_x)
    seeds = [mix_seed(seed, i) for i in range(len(poses))]
    return render_poses_batched(render_chunk, poses, height, width, focal, chunk=chunk,
                                frame_seeds=seeds, device=device)


def generate_360_view_synthesis(render_chunk: Callable, save_dir, epoch,
                                height: int = 800, width: int = 800,
                                radius: float = 4.0,
                                cam_angle_x: float = DEFAULT_CAM_ANGLE_X,
                                chunk: int = 4096, num_poses: int = 40,
                                seed: int = 0, device="cuda") -> Path:
    """Render the orbit and write ``{save_dir}/{epoch}-360.gif``."""
    from minimal_nerf_torch.utils import imageio as mio

    save_dir = Path(save_dir)
    if not save_dir.is_dir():
        raise FileNotFoundError(f"missing save dir {save_dir}")
    views = list(orbit_views(render_chunk, height, width, radius, cam_angle_x, chunk,
                             num_poses, seed, device))
    out_path = save_dir / f"{epoch}-360.gif"
    mio.mimwrite(out_path, views)
    return out_path
