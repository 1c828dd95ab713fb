"""Blender-style scenes held in memory, and per-step ray-batch sampling.

Counterpart of the in-memory parts of ``minimal_nerf_tpu/data/synthetic.py``:
``num_rays`` random pixels of ONE frame per batch, with the reference's
center-crop warmup (margins ``H//4``, ``W//4``), rays generated only for the
sampled pixels. Images stay uint8 ``[F, H, W, 3]`` on the device and a batch
gathers its pixels directly (the JAX package's u32 word packing is a TPU
gather workaround and is not ported). ``SyntheticScene.load`` (PNG trees) is
not ported yet: the card's machine has no PNG decoder.

Random draws come from a ``torch.Generator``, or from given coordinates so
tests can replay the JAX draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from minimal_nerf_torch.ops import cameras


def sample_random_coordinates(n: int, height: int, width: int, cropping: bool = False,
                              generator: Optional[torch.Generator] = None,
                              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``xs [n]`` in ``[0, width)``, ``ys [n]`` in ``[0, height)`` (int64);
    with ``cropping`` only from the center half (margins ``H//4``/``W//4``)."""
    ew = width // 4 if cropping else 0
    eh = height // 4 if cropping else 0
    device = device if device is not None else (generator.device if generator else "cpu")
    xs = torch.randint(ew, width - ew, (n,), generator=generator, device=device)
    ys = torch.randint(eh, height - eh, (n,), generator=generator, device=device)
    return xs, ys


@dataclasses.dataclass
class SyntheticScene:
    """One split of a scene in memory.

    Attributes:
        images: ``[F, H, W, 3]`` uint8 tensor.
        poses: ``[F, 4, 4]`` float32 camera-to-world tensor.
        focal: focal length in pixels.
        camera_angle_x: horizontal field of view (radians).
    """

    images: torch.Tensor
    poses: torch.Tensor
    focal: float
    camera_angle_x: float
    split: str
    base_dir: str

    @property
    def num_frames(self) -> int:
        return self.images.shape[0]

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]


def ray_batch_from_arrays(frame_idx, num_rays: int, height: int, width: int, focal: float,
                          images: torch.Tensor, poses: torch.Tensor, cropping: bool = False,
                          generator: Optional[torch.Generator] = None,
                          coords=None) -> Dict[str, torch.Tensor]:
    """The pixel -> ray -> rgb sampling core: ``origin``, ``direc`` ``[N, 3]``,
    ``rgb [N, 3]`` (fp32 in ``[0, 1]``), ``xs``, ``ys``. ``coords = (xs, ys)``
    replaces the draws."""
    if coords is None:
        xs, ys = sample_random_coordinates(num_rays, height, width, cropping, generator,
                                           device=images.device)
    else:
        xs, ys = (torch.as_tensor(c, dtype=torch.int64, device=images.device) for c in coords)
    origin, direc = cameras.rays_for_pixels(xs.float(), ys.float(), height, width, focal,
                                            poses[frame_idx])
    rgb = images[frame_idx, ys, xs].float() / 255.0
    return {"origin": origin, "direc": direc, "rgb": rgb, "xs": xs, "ys": ys}
