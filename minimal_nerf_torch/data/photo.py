"""Toy 2-D photo datasets for the image MLP (``train simple``).

Counterpart of ``minimal_nerf_tpu/data/photo.py`` (reference
``dataloader.py:164-203``): ``PhotoDataset`` yields one
(normalized-coordinate, rgb) pair per pixel, ``ValDataset`` the image size.
The photo is read through the port's own PNG decoder (``utils/imageio.py``)
and kept on the host; ``PhotoDataset.batches`` permutes the pixels with a
``torch.Generator`` and yields device tensors (the JAX package draws the
permutation from a key).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from minimal_nerf_torch.utils import imageio as mio


class PhotoDataset:
    """Per-pixel dataset of one photo; coordinates ``(y / (H-1), x / (W-1))``
    in ``[0, 1]``, colours in ``[0, 1]`` (fp32 numpy arrays)."""

    def __init__(self, im_path):
        self.im_path = im_path
        self.im = mio.imread(im_path).astype(np.float32) / 255.0
        self.H, self.W, self.C = self.im.shape
        ys, xs = np.meshgrid(np.arange(self.H), np.arange(self.W), indexing="ij")
        self.coords = np.stack([ys.ravel() / (self.H - 1), xs.ravel() / (self.W - 1)],
                               axis=-1).astype(np.float32)
        self.rgb = self.im.reshape(-1, 3)

    def __len__(self) -> int:
        return self.H * self.W

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        h, w = idx // self.W, idx % self.W
        return (np.array([h / (self.H - 1), w / (self.W - 1)], dtype=np.float32),
                self.im[h, w, :])

    def batches(self, generator: torch.Generator, batch_size: int, shuffle: bool = True,
                device="cuda") -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """One epoch of ``(coords [B, 2], rgb [B, 3])`` batches on ``device``
        (whole batches only), in the order of a permutation drawn from
        ``generator`` (a CPU generator), or in pixel order."""
        from minimal_nerf_torch import resolve_device

        dev = resolve_device(device)
        n = len(self)
        order = (torch.randperm(n, generator=generator) if shuffle
                 else torch.arange(n)).to(dev)
        coords, rgb = torch.from_numpy(self.coords).to(dev), torch.from_numpy(self.rgb).to(dev)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            yield coords[idx], rgb[idx]


def getPhotoDataloader(im_path, batch_size: int = 1024, seed: int = 0, shuffle: bool = True,
                       device="cuda"):
    """Mirror of the reference's ``dataloader.getPhotoDataloader``: the
    ``PhotoDataset`` with ``epoch(epoch_idx)`` giving that epoch's batches,
    permuted by a generator seeded with ``seed + epoch_idx``."""
    ds = PhotoDataset(im_path)

    def epoch(epoch_idx: int = 0):
        return ds.batches(torch.Generator().manual_seed(seed + epoch_idx), batch_size,
                          shuffle=shuffle, device=device)

    ds.epoch = epoch  # type: ignore[attr-defined]
    return ds


def getValDataloader(im_path, batch_size: int = 1, shuffle: bool = False):
    """Mirror of the reference's ``dataloader.getValDataloader``."""
    return ValDataset(im_path)


class ValDataset:
    """One item, the image size (reference ``dataloader.py:188-203``)."""

    def __init__(self, im_path):
        self.im_path = im_path
        self.im = mio.imread(im_path).astype(np.float32) / 255.0
        self.H, self.W, self.C = self.im.shape

    def __len__(self) -> int:
        return 1

    def __getitem__(self, idx: int) -> Tuple[int, int]:
        return (self.H, self.W)
