"""PyTorch/CUDA port of ``minimal_nerf_tpu`` for NVIDIA Hopper (H100).

The module layout mirrors the JAX package so each counterpart is easy to
find (``ops/encoding.py`` <-> ``ops/encoding.py`` and so on). Parameters keep
the JAX layout (``{"w": [in, out], "b": [out]}``) so the same weights drive
both packages. Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.

This slice covers serving: rendering views from a checkpoint through the
fused ray-march forward kernel (``kernels/fused_raymarch.py``).
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
