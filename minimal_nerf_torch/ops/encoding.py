"""Positional (Fourier-feature) encoding.

Counterpart of ``minimal_nerf_tpu/ops/encoding.py``. The layout is
frequency-major with cos before sin: for each octave ``i`` the output holds
``cos(2**i * pi * x)`` over all C input channels, then ``sin(...)`` over all
C channels, giving ``2 * dim * C`` channels.
"""

from __future__ import annotations

import math

import torch


def positional_encoding(x: torch.Tensor, dim: int = 10) -> torch.Tensor:
    """Encode ``x [..., C]`` with ``dim`` octaves -> ``[..., 2 * dim * C]``."""
    c = x.shape[-1]
    freqs = (2.0 ** torch.arange(dim, dtype=x.dtype, device=x.device)) * math.pi
    angles = x[..., None, :] * freqs[:, None]  # [..., dim, C]
    enc = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-2)
    return enc.reshape(*x.shape[:-1], 2 * dim * c)


def normalize_coordinates(x: torch.Tensor, bound: float = math.pi) -> torch.Tensor:
    """Scale coordinates from ``[-bound, bound]`` into ``[-1, 1]``."""
    return x / bound
