"""Loading a trained model for inference.

Counterpart of ``load_state_for_inference`` in
``minimal_nerf_tpu/training/trainer.py``. The trainer itself (epochs,
validation, save and resume) is not ported yet; the train step is
``training/loop.py``. Full coarse + fine checkpoints load here, with the
density-EMA grid of an occupancy run; any other layout raises rather than
being guessed at.
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

    ``params`` are fp32 tensors on ``device``; ``grid`` is an occupancy
    run's ``[G, G, G]`` density EMA (fp32 on ``device``), else None. ``step``
    is the save step: a checkpoint saved inside the occupancy warmup trained
    with every cell forced occupied, and inference packs its grid the same
    way.
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
    occ_cfg = train_cfg.occupancy_config
    grid_shape = (occ_cfg.resolution,) * 3 if occ_cfg is not None else None
    mlp = nerf_mlp_shapes(nerf_cfg.position_dim, nerf_cfg.direction_dim)
    params, _, grid = ckpt_lib.restore_state(header, leaves, {"coarse": mlp, "fine": mlp},
                                             grid_shape)
    to_dev = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)  # noqa: E731
    params = map_params(to_dev, params)
    return params, nerf_cfg, train_cfg, None if grid is None else to_dev(grid), \
        int(header["step"])
