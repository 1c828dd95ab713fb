"""Blender-style scenes: loading, and per-step ray-batch sampling.

Counterpart of ``minimal_nerf_tpu/data/synthetic.py``: a split is parsed
from ``transforms_{split}.json`` and its PNG frames decoded once
(``SyntheticScene.load``, through the port's own PNG decoder); a batch is
``num_rays`` random pixels of ONE frame, with the reference's center-crop
warmup (margins ``H//4``, ``W//4``), rays generated only for the sampled
pixels. Images stay uint8 ``[F, H, W, 3]`` on the device and a batch gathers
its pixels directly (the JAX package's u32 word packing is a TPU gather
workaround and is not ported).

Random draws come from a ``torch.Generator``, or from given coordinates so
tests can replay the JAX draws. ``SyntheticDataset``, ``SyntheticDataModule``
and ``getSyntheticDataloader`` are the reference-shaped facade over a scene.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
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

    @classmethod
    def load(cls, base_dir, split: str, device="cuda") -> "SyntheticScene":
        """Parse ``transforms_{split}.json`` and decode every frame's PNG
        (``utils.imageio.imread``: alpha dropped, gray expanded), then put
        ``images`` and ``poses`` on ``device``. ``split`` is ``"train"``,
        ``"val"`` or ``"test"``."""
        from minimal_nerf_torch import resolve_device
        from minimal_nerf_torch.utils import imageio as mio

        dev = resolve_device(device)
        base = Path(base_dir)
        with open(base / f"transforms_{split}.json") as f:
            meta = json.load(f)
        images = np.stack([mio.imread(base / (frame["file_path"].lstrip("./") + ".png"))
                           for frame in meta["frames"]])
        poses = np.stack([np.asarray(frame["transform_matrix"], dtype=np.float32)
                          for frame in meta["frames"]])
        camera_angle_x = float(meta["camera_angle_x"])
        return cls(images=torch.from_numpy(images).to(dev),
                   poses=torch.from_numpy(poses).to(dev),
                   focal=cameras.focal_from_angle(images.shape[2], camera_angle_x),
                   camera_angle_x=camera_angle_x, split=split, base_dir=str(base_dir))

    def frame_rays(self, frame_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """All ``H x W`` rays of one frame, ``[H, W, 3]`` each, on the
        scene's device (for view reconstruction and scoring)."""
        return cameras.get_rays(self.height, self.width, self.focal,
                                self.poses[frame_idx].cpu(), device=self.images.device)


def ray_batch_from_arrays(frame_idx, num_rays: int, height: int, width: int, focal: float,
                          images: torch.Tensor, poses: torch.Tensor, cropping: bool = False,
                          generator: Optional[torch.Generator] = None,
                          coords=None) -> Dict[str, torch.Tensor]:
    """The pixel -> ray -> rgb sampling core: ``origin``, ``direc`` ``[N, 3]``,
    ``rgb [N, 3]`` (fp32 in ``[0, 1]``), ``xs``, ``ys``. ``coords = (xs, ys)``
    replaces the draws. ``frame_idx`` is an int or an int64 tensor ``[1]`` on
    the images' device (the train step's, read without a host sync)."""
    if coords is None:
        xs, ys = sample_random_coordinates(num_rays, height, width, cropping, generator,
                                           device=images.device)
    else:
        xs, ys = (torch.as_tensor(c, dtype=torch.int64, device=images.device) for c in coords)
    c2w = poses.index_select(0, frame_idx)[0] if torch.is_tensor(frame_idx) else poses[frame_idx]
    origin, direc = cameras.rays_for_pixels(xs.float(), ys.float(), height, width, focal, c2w)
    rgb = images[frame_idx, ys, xs].float() / 255.0
    return {"origin": origin, "direc": direc, "rgb": rgb, "xs": xs, "ys": ys}


def getSyntheticDataloader(base_dir, tvt: str, num_rays: int, cropping: bool = False,
                           seed: int = 0, device="cuda") -> "SyntheticDataset":
    """Factory mirroring the reference's ``dataloader.getSyntheticDataloader``
    (JAX ``getSyntheticDataloader``): the returned dataset is iterable
    directly (one ray batch per frame), its split already on ``device``."""
    return SyntheticDataset(base_dir, tvt, num_rays, cropping=cropping, seed=seed, device=device)


class SyntheticDataModule:
    """Reference-shaped data module (JAX ``SyntheticDataModule``): a
    center-cropped and a full train dataset and a val dataset;
    ``train_dataloader`` gives the cropped one while ``current_epoch <
    cropping_epochs``. The Trainer does not use it: its train step draws
    the crop itself (``training.loop.draw_step_inputs``)."""

    def __init__(self, base_dir, num_rays: int, cropping_epochs: int, seed: int = 0,
                 device="cuda"):
        self.base_dir = base_dir
        self.num_rays = num_rays
        self.cropping_epochs = cropping_epochs
        self.current_epoch = 0
        self.crop_train_ds = SyntheticDataset(base_dir, "train", num_rays, cropping=True,
                                              seed=seed, device=device)
        self.train_ds = SyntheticDataset(base_dir, "train", num_rays, cropping=False,
                                         seed=seed + 1, device=device)
        self.val_ds = SyntheticDataset(base_dir, "val", num_rays, cropping=False, seed=seed + 2,
                                       device=device)

    def train_dataloader(self):
        if self.current_epoch < self.cropping_epochs:
            return self.crop_train_ds
        return self.train_ds

    def val_dataloader(self):
        return self.val_ds


class SyntheticDataset(torch.utils.data.Dataset):
    """Reference-shaped dataset (JAX ``SyntheticDataset``, reference
    ``dataloader.SyntheticDataset``) over a ``SyntheticScene``.

    ``dataset[idx]`` is ``num_rays`` random pixels of frame ``idx``
    (``ray_batch_from_arrays``: ``origin``, ``direc``, ``rgb``, ``xs``,
    ``ys``), plus ``all_origin``, ``all_direc`` ``[H, W, 3]`` and ``image``
    (fp32 in ``[0, 1]``) for the val and test splits. The ``n``-th item
    drawn draws from a generator seeded from ``(seed, n)``.
    """

    def __init__(self, base_dir, tvt: str, num_rays: int, cropping: bool = False,
                 seed: int = 0, device="cuda"):
        self.scene = SyntheticScene.load(base_dir, tvt, device)
        self.tvt = tvt
        self.num_rays = num_rays
        self.cropping = cropping
        self.seed = seed
        self._count = 0

    @property
    def focal(self) -> float:
        return self.scene.focal

    @property
    def H(self) -> int:
        return self.scene.height

    @property
    def W(self) -> int:
        return self.scene.width

    def __len__(self) -> int:
        return self.scene.num_frames

    def __getitem__(self, idx: int) -> Dict[str, torch.Tensor]:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        from minimal_nerf_torch.views import mix_seed

        scene = self.scene
        gen = torch.Generator(device=scene.images.device).manual_seed(
            mix_seed(self.seed, self._count))
        self._count += 1
        batch = ray_batch_from_arrays(idx, self.num_rays, scene.height, scene.width,
                                      scene.focal, scene.images, scene.poses, self.cropping, gen)
        if self.tvt != "train":
            all_o, all_d = scene.frame_rays(idx)
            batch = dict(batch, all_origin=all_o, all_direc=all_d,
                         image=scene.images[idx].float() / 255.0)
        return batch
