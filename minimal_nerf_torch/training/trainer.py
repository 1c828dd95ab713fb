"""Loading a trained model for inference.

Counterpart of ``load_state_for_inference`` in
``minimal_nerf_tpu/training/trainer.py``. The trainer itself (epochs,
validation, save and resume) is not ported yet; the train step is
``training/loop.py``. Only full coarse + fine checkpoints without an
occupancy grid load here; any other layout raises rather than being guessed
at.
"""

from __future__ import annotations

import torch

from minimal_nerf_torch import resolve_device
from minimal_nerf_torch.models.mlp import map_params, nerf_mlp_shapes
from minimal_nerf_torch.models.nerf import NeRFConfig
from minimal_nerf_torch.training import checkpoint as ckpt_lib
from minimal_nerf_torch.training.config import TrainConfig


def load_state_for_inference(ckpt_path, device="cuda"):
    """``(params, nerf_cfg, train_cfg, grid, step)`` of a checkpoint.

    ``params`` are fp32 tensors on ``device``; ``grid`` is always None until
    occupancy sampling is ported (ROADMAP Queue 1 item 4, occupancy).
    """
    dev = resolve_device(device)
    header, leaves = ckpt_lib.load_checkpoint(ckpt_path)
    nerf_cfg = NeRFConfig.from_dict(header["nerf_config"])
    train_cfg = TrainConfig.from_dict(header["train_config"])
    mode = (header.get("extra") or {}).get("mode", "full")
    if mode != "full":
        raise NotImplementedError(
            f"checkpoint mode {mode!r}: only 'full' coarse+fine checkpoints load in "
            "the port so far (ROADMAP Queue 1 item 6, single/simple modes)")
    if train_cfg.occupancy:
        raise NotImplementedError(
            "occupancy-trained checkpoint: the occupancy grid is not ported yet "
            "(ROADMAP Queue 1 item 4, occupancy)")
    mlp = nerf_mlp_shapes(nerf_cfg.position_dim, nerf_cfg.direction_dim)
    params = ckpt_lib.restore_params(header, leaves, {"coarse": mlp, "fine": mlp})
    params = map_params(lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev), params)
    return params, nerf_cfg, train_cfg, None, int(header["step"])
