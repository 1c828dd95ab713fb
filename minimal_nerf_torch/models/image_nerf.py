"""Toy 2-D image MLP: f(y, x) -> rgb (the ``train simple`` model).

Counterpart of ``minimal_nerf_tpu/models/image_nerf.py`` (reference
``ImageNeRFModel``, ``nerf_model.py:392-445``): the optional positional
encoding of the normalized pixel coordinates (off when ``position_dim <=
0``), then ten layers counting the input: seven of width 256 with ReLU,
256 -> 128 with ReLU, 128 -> 3 with a sigmoid. Parameters keep the JAX
layout ``{"layers": [{"w": [in, out], "b": [out]}, ...]}``. No TPU kernel
computes this model in JAX: it is plain PyTorch here too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from minimal_nerf_torch.models.mlp import init_linear, params_from_jax
from minimal_nerf_torch.ops.encoding import positional_encoding

Params = Dict[str, Any]


def image_nerf_dims(position_dim: int = 10):
    """The layer widths, input first: ``[in, 256 x 7, 128, 3]``."""
    input_size = 2 * 2 * position_dim if position_dim > 0 else 2
    return [input_size, 256, 256, 256, 256, 256, 256, 256, 128, 3]


def init_image_nerf(generator: torch.Generator, position_dim: int = 10,
                    device="cuda") -> Params:
    """The image MLP's layers drawn in turn from ``generator``
    (``models.mlp.init_linear``, as the NeRF MLP's)."""
    dims = image_nerf_dims(position_dim)
    return {"layers": [init_linear(din, dout, generator, device)
                       for din, dout in zip(dims[:-1], dims[1:])]}


def image_nerf_apply(params: Params, x: torch.Tensor, position_dim: int = 10) -> torch.Tensor:
    """``[N, 2]`` normalized pixel coordinates -> ``[N, 3]`` rgb (fp32)."""
    if position_dim > 0:
        x = positional_encoding(x, dim=position_dim)
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return torch.sigmoid(x @ layers[-1]["w"] + layers[-1]["b"])


def image_params_from_jax(tree, position_dim: int = 10, device="cuda") -> Params:
    """A JAX ``init_image_nerf`` tree (numpy arrays, e.g. ``jax.device_get``)
    as fp32 tensors on ``device``; a tree of another layout raises."""
    dims = image_nerf_dims(position_dim)
    layers = tree.get("layers") if isinstance(tree, dict) else None
    want = [((i, o), (o,)) for i, o in zip(dims[:-1], dims[1:])]
    got = None if layers is None else [(tuple(l["w"].shape), tuple(l["b"].shape))
                                       for l in layers]
    if got != want:
        raise ValueError(f"not an image MLP at position_dim {position_dim}: layer shapes "
                         f"{got}, expected {want}")
    return params_from_jax(tree, device)


class ImageNeRFModel:
    """Thin wrapper mirroring the reference class: ``forward(x)`` is
    ``image_nerf_apply``. Without params the layers are drawn from a
    generator seeded with ``seed`` on ``device``."""

    def __init__(self, position_dim: int = 10, params: Optional[Params] = None, seed: int = 0,
                 device="cuda"):
        from minimal_nerf_torch import resolve_device

        self.position_dim = position_dim
        dev = resolve_device(device)
        self.params = params if params is not None else init_image_nerf(
            torch.Generator(device=dev).manual_seed(seed), position_dim, dev)

    def forward(self, x):
        return image_nerf_apply(self.params, x, self.position_dim)

    __call__ = forward
