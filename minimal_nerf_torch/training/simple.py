"""Training loop of the toy 2-D image MLP (``train simple``).

Counterpart of ``minimal_nerf_tpu/training/simple.py`` (reference
``train_simple_image``, ``train_nerf.py:50-60``, and the ``ImageNeRFModel``
hooks, ``nerf_model.py:447-471``): random pixel batches, Adam at a constant
5e-4 (the port's ``loop.adam_apply``), a ``metrics.csv`` row every
``log_every`` steps and the whole image reconstructed as validation every
``val_every`` steps and at the last one. Plain PyTorch: no TPU kernel
computes this model in JAX.

Draws: step ``step`` draws its pixel indices from ``loop.step_generator(seed,
step, ...)`` on the device; the MLP is drawn from a generator seeded with
``seed``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from minimal_nerf_torch.models.image_nerf import image_nerf_apply, init_image_nerf
from minimal_nerf_torch.training import loop
from minimal_nerf_torch.training.checkpoint import flatten_tree, unflatten_tree

_PIXEL_STREAM = 0x1A6E


def simple_loss_and_grads(params, coords: torch.Tensor, rgb: torch.Tensor,
                          position_dim: int = 10):
    """``(loss, grads)`` of the mean squared error of the image MLP on one
    batch; no ``.grad`` is written."""
    leaves = flatten_tree(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = torch.mean((image_nerf_apply(params, coords, position_dim) - rgb) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten_tree(params, list(grads))


def simple_step(params, opt_state: Dict[str, Any], coords: torch.Tensor, rgb: torch.Tensor,
                position_dim: int = 10, lr: float = 5e-4):
    """One Adam step of the image MLP on one batch, in place; returns
    ``(opt_state, loss)``, the loss a device scalar."""
    loss, grads = simple_loss_and_grads(params, coords, rgb, position_dim)
    scalars = loop.adam_scalars(lr, opt_state["count"] + 1).to(coords.device)
    return loop.adam_apply(params, grads, opt_state, scalars), loss


def train_simple_image(im_path, root_dir, name: str, max_steps: int, position_dim: int = 10,
                       batch_size: int = 4096, lr: float = 5e-4, seed: int = 0,
                       val_every: int = 1000, log_every: int = 100, logger=None,
                       device="cuda"):
    """Overfit the image MLP to the photo at ``im_path`` for ``max_steps``
    steps of ``batch_size`` random pixels on ``device``; logs to
    ``{root_dir}/{name}`` (``training.metrics.MetricsLogger``): ``train_loss``
    every ``log_every`` steps, the reconstruction ``recon`` as a PNG every
    ``val_every`` steps and at the last. Returns the final parameters."""
    from minimal_nerf_torch import resolve_device, views
    from minimal_nerf_torch.data.photo import PhotoDataset
    from minimal_nerf_torch.training.metrics import MetricsLogger

    dev = resolve_device(device)
    ds = PhotoDataset(im_path)
    logger = logger or MetricsLogger(Path(root_dir) / name, name=name)
    params = init_image_nerf(torch.Generator(device=dev).manual_seed(seed), position_dim, dev)
    opt_state = loop.adam_init(params)
    coords_all = torch.from_numpy(ds.coords).to(dev)
    rgb_all = torch.from_numpy(ds.rgb).to(dev)
    n = coords_all.shape[0]
    for step in range(max_steps):
        gen = loop.step_generator(seed, step, _PIXEL_STREAM, dev)
        idx = torch.randint(0, n, (batch_size,), generator=gen, device=dev)
        opt_state, loss = simple_step(params, opt_state, coords_all[idx], rgb_all[idx],
                                      position_dim, lr)
        done = step + 1
        if done % log_every == 0 or done == max_steps:
            logger.log_scalars(done, {"train_loss": float(loss)})
        if done % val_every == 0 or done == max_steps:
            im = views.photo_nerf_to_image(
                lambda c: image_nerf_apply(params, c, position_dim), ds.H, ds.W, device=dev)
            logger.log_image("recon", (np.clip(im, 0, 1) * 255).astype(np.uint8), step=done)
    return params
