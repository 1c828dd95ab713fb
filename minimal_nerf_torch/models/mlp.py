"""The core NeRF MLP as a plain parameter dict + a pure apply function.

Counterpart of ``minimal_nerf_tpu/models/mlp.py``. Parameters keep the JAX
layout: nested dicts of ``{"w": [in, out], "b": [out]}`` with ``trunk[4]``,
``feature[3]``, ``density`` and ``rgb[2]``, so one set of weights drives both
packages (``params_from_jax`` / ``params_to_numpy``).

Architecture (reference ``nerf_model.py:308-389``): 4 trunk layers of width
256 on gamma(pos), a skip that re-concatenates gamma(pos), two more ReLU
layers and one linear layer, a ReLU density head, and an rgb head over
``[h, gamma(dir)]`` (width 128, then 3 with a sigmoid).

``compute_dtype=torch.bfloat16`` rounds matmul inputs to bf16 while the
products accumulate in fp32 (as ``preferred_element_type=float32`` does in
JAX): the rounded operands are multiplied as fp32 tensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from minimal_nerf_torch.ops.encoding import normalize_coordinates, positional_encoding

Params = Dict[str, Any]


def init_linear(in_dim: int, out_dim: int, generator: torch.Generator,
                device="cuda", gain: float = 1.0) -> Params:
    """Torch-``nn.Linear``-style init: ``U(+-1/sqrt(in_dim))`` for w and b.

    ``gain`` scales the weights' bound only; ``gain=sqrt(6)`` is the He
    (Kaiming) uniform init, which keeps the activations' scale through the
    ReLU layers so the outputs depend on the input.
    """
    bound = 1.0 / math.sqrt(in_dim)

    def uniform(scale, *shape):
        u = torch.rand(*shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        return (u * (2 * scale) - scale).to(device)

    return {"w": uniform(gain * bound, in_dim, out_dim), "b": uniform(bound, out_dim)}


def nerf_mlp_shapes(position_dim: int = 10, direction_dim: int = 4,
                    width: int = 256, rgb_width: int = 128) -> Params:
    """The params tree of ``init_nerf_mlp`` with each leaf's shape as a tuple."""
    pos_enc, dir_enc = 2 * 3 * position_dim, 2 * 3 * direction_dim
    lin = lambda i, o: {"w": (i, o), "b": (o,)}  # noqa: E731
    return {
        "trunk": [lin(pos_enc, width)] + [lin(width, width)] * 3,
        "feature": [lin(width + pos_enc, width), lin(width, width), lin(width, width)],
        "density": lin(width, 1),
        "rgb": [lin(width + dir_enc, rgb_width), lin(rgb_width, 3)],
    }


def init_nerf_mlp(
    generator: torch.Generator,
    position_dim: int = 10,
    direction_dim: int = 4,
    width: int = 256,
    rgb_width: int = 128,
    device="cuda",
    gain: float = 1.0,
) -> Params:
    """Initialize one NeRF MLP (coarse or fine) from ``generator``."""
    pos_enc = 2 * 3 * position_dim
    dir_enc = 2 * 3 * direction_dim
    lin = lambda i, o: init_linear(i, o, generator, device, gain)  # noqa: E731
    return {
        "trunk": [lin(pos_enc, width), lin(width, width), lin(width, width),
                  lin(width, width)],
        "feature": [lin(width + pos_enc, width), lin(width, width),
                    lin(width, width)],
        "density": lin(width, 1),
        "rgb": [lin(width + dir_enc, rgb_width), lin(rgb_width, 3)],
    }


def round_to(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and returned as fp32 (identity for None)."""
    if dtype is None or dtype == torch.float32:
        return x.float()
    return x.to(dtype).float()


def linear(p: Params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``x @ w + b`` with operands rounded to ``compute_dtype``, fp32 result."""
    y = round_to(x, compute_dtype) @ round_to(p["w"], compute_dtype)
    return y + p["b"].float()


def nerf_mlp_apply(
    params: Params,
    samples: torch.Tensor,
    direc: torch.Tensor,
    position_dim: int = 10,
    direction_dim: int = 4,
    compute_dtype=None,
):
    """Sample positions ``[N, S, 3]`` + ray directions ``[N, 3]`` ->
    ``density [N, S, 1]`` (ReLU) and ``rgb [N, S, 3]`` (sigmoid)."""
    direc = direc / torch.linalg.norm(direc, dim=-1, keepdim=True)
    direc = direc[:, None, :].expand(samples.shape)

    pos_enc = positional_encoding(normalize_coordinates(samples), dim=position_dim)
    dir_enc = positional_encoding(direc, dim=direction_dim)

    x = pos_enc
    for layer in params["trunk"]:
        x = torch.relu(linear(layer, x, compute_dtype))
    x = torch.cat([x, pos_enc], dim=-1)
    x = torch.relu(linear(params["feature"][0], x, compute_dtype))
    x = torch.relu(linear(params["feature"][1], x, compute_dtype))
    x = linear(params["feature"][2], x, compute_dtype)  # no activation

    density = torch.relu(linear(params["density"], x, compute_dtype))
    d = torch.cat([x, dir_enc], dim=-1)
    d = torch.relu(linear(params["rgb"][0], d, compute_dtype))
    rgb = torch.sigmoid(linear(params["rgb"][1], d, compute_dtype))
    return density, rgb


def map_params(fn, tree):
    """Apply ``fn`` to every leaf of a params tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree, device="cuda") -> Params:
    """A params tree of numpy arrays (e.g. ``jax.device_get`` of JAX params)
    as fp32 torch tensors on ``device``."""
    return map_params(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device), tree
    )


def params_to_numpy(params: Params):
    """The params tree as fp32 numpy arrays (loadable by the JAX package)."""
    return map_params(lambda t: t.detach().float().cpu().numpy(), params)
