"""PyTorch/CUDA port of ``minimal_nerf_tpu`` for NVIDIA Hopper (H100).

The module layout mirrors the JAX package so each counterpart is easy to
find (``ops/encoding.py`` <-> ``ops/encoding.py`` and so on). Parameters keep
the JAX layout (``{"w": [in, out], "b": [out]}``) so the same weights drive
both packages. Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.

Ported: all of the JAX package. Serving (``inference.py``, ``views.py``,
``render.py``, ``score.py``, ``convert_ckpt.py``): views through the fused
ray-march forward kernel, a frame's full chunks replayed from one captured
CUDA graph, PSNR/SSIM. Training (``training/``, ``train.py``): the step
through the fused forward and backward kernels, several steps a call as
replays of one captured CUDA graph, the ``full``, ``single`` and ``simple``
modes, data parallel (``parallel/``). Beside them the point kernels
(``--kernel pallas``) and occupancy sampling through a sampler kernel. One
module (``fields.py``) picks the field trained and served, the NeRF MLPs or
Instant-NGP's hash grid (``models/ngp.py``), and its kernel.
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
