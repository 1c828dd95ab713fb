"""PyTorch/CUDA port of ``minimal_nerf_tpu`` for NVIDIA Hopper (H100).

The module layout mirrors the JAX package so each counterpart is easy to
find (``ops/encoding.py`` <-> ``ops/encoding.py`` and so on). Parameters keep
the JAX layout (``{"w": [in, out], "b": [out]}``) so the same weights drive
both packages. Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.

Ported so far: serving (rendering views from a checkpoint through the fused
ray-march forward kernel, ``kernels/fused_raymarch.py``) and the train step
(``training/loop.py``: batch sampling, the hierarchical loss through the
fused forward and backward kernels, Adam, the LR schedule) on in-memory and
procedural scenes (``data/``); and the point-level path (``--kernel
pallas``, ``kernels/raymarch.py``): the same render and train step with the
plain render around hand-written point-level MLP forward and backward
kernels (``training.loop.kernel_hooks``); and occupancy-guided coarse
sampling (``ops/occupancy.py``) for training and serving, its grid probe a
hand-written kernel (``kernels/occupancy_probe.py``), with the grid and the
Adam state kept in the checkpoint; the trainer (``train.py``); and scoring
(``score.py``, PSNR/SSIM in ``ops/image_metrics.py``), the batched pose
sweep behind ``--frames-per-dispatch`` (``views.render_poses_batched``) and
checkpoint conversion to and from the reference's format
(``convert_ckpt.py``).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request without a card raises.

    The port never falls back to the CPU on its own: the CPU runs only when
    the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
