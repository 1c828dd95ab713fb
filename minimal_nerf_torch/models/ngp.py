"""Instant-NGP's NeRF field: a multiresolution hash encoding, a density MLP
and a color MLP on spherical harmonics (Mueller et al., Instant Neural
Graphics Primitives with a Multiresolution Hash Encoding, SIGGRAPH 2022,
sec. 3 and 5.4).

One field serves both render passes (``models.nerf.render_rays`` on
``{"coarse": params, "fine": params}``, so that autograd sums both passes'
gradients into the same leaves): the parameter tree is ``{"table":
[entries, F], "density": [w0, w1], "color": [w0, w1, w2]}``, the MLPs
without biases (as tiny-cuda-nn's fully fused MLP has none).

- A point ``x`` enters as ``(x + bound) / (2 bound)`` over the occupancy
  grid's box, clamped to ``[0, 1]``, and is encoded on every level
  (``ops.encoding``: the paper's corners ``floor(x N_l)``, dense levels
  indexed one to one): ``[P, L * F]``;
- the density MLP (ReLU hidden layer, linear output) maps the encoding to
  ``density_outputs`` values, the first the log-density: density
  ``exp(h_0)``;
- the color MLP reads ``[h, SH(d)]`` (the direction's spherical harmonics
  of ``sh_degree``, 16 at degree 4): ReLU hidden layers, a sigmoid color.

Matmul inputs are rounded to the compute dtype with fp32 sums, as
``models.mlp.linear`` does; the table and the encoding stay fp32. The
encoding goes through the CUDA kernels (``kernels.hash_encode``) unless the
field is built for the plain path (``--kernel xla``), which indexes in
PyTorch (``ops.encoding.hash_encode_plain``).

Training (``NGPField.adam_options``): Adam with ``b2 = 0.99``, ``eps =
1e-15``; a table entry whose gradient is exactly 0 keeps its value and
moments; ``1e-6 * w`` (L2) is added to every MLP weight's gradient.

Spans (``utils.profiling``): ``nerf.ngp.encode`` (the box mapping and the
encoding), ``nerf.ngp.mlp`` (both MLPs and SH); the table's update is
``nerf.ngp.table_adam`` (``training.loop.adam_apply``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from minimal_nerf_torch.models.mlp import map_params, round_to
from minimal_nerf_torch.ops.encoding import grid_levels, hash_encode_plain, sh_encode
from minimal_nerf_torch.utils import profiling

Params = Dict[str, Any]

FIELD = "ngp"  # the field's name in a checkpoint's header and on the command line


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """The field's sizes (the paper's NeRF: L 16, F 2, T 2^19, N_min 16,
    N_max 2048; density MLP 32 -> 64 -> 16; color MLP 32 -> 64 -> 64 -> 3;
    SH of degree 4) and the box ``[-bound, bound]^3`` the table covers."""

    levels: int = 16
    features: int = 2
    log2_table: int = 19
    min_resolution: int = 16
    max_resolution: int = 2048
    density_width: int = 64
    density_outputs: int = 16
    color_width: int = 64
    color_layers: int = 2
    sh_degree: int = 4
    bound: float = 3.2

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NGPConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def grid(self):
        return grid_levels(self.levels, self.log2_table, self.min_resolution,
                           self.max_resolution)

    @property
    def entries(self) -> int:
        last = self.grid[-1]
        return last.offset + last.size


def param_shapes(cfg: NGPConfig) -> Params:
    """The parameter tree with each leaf's shape: the table ``[entries, F]``,
    each MLP weight ``[in, out]``."""
    enc, sh = cfg.levels * cfg.features, cfg.sh_degree ** 2
    dw, do, cw = cfg.density_width, cfg.density_outputs, cfg.color_width
    return {"table": (cfg.entries, cfg.features),
            "density": [(enc, dw), (dw, do)],
            "color": [(do + sh, cw)] + [(cw, cw)] * (cfg.color_layers - 1) + [(cw, 3)]}


def init_ngp(generator: torch.Generator, cfg: NGPConfig, device="cuda") -> Params:
    """The table ``U(+-1e-4)`` (the paper's), then each MLP weight ``U(+-sqrt(6
    / in))`` (He uniform), drawn in turn from ``generator``."""
    def uniform(shape, scale):
        u = torch.rand(*shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        return (u * (2 * scale) - scale).to(device)

    shapes = param_shapes(cfg)
    he = lambda s: uniform(s, math.sqrt(6.0 / s[0]))  # noqa: E731
    return {"table": uniform(shapes["table"], 1e-4),
            "density": [he(s) for s in shapes["density"]],
            "color": [he(s) for s in shapes["color"]]}


def to_unit_box(x: torch.Tensor, bound: float) -> torch.Tensor:
    """Points of ``[-bound, bound]^3`` as the table's ``[0, 1]^3``, clamped."""
    return torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)


def mlp(weights, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """ReLU layers without biases, the last linear: fp32 results of inputs
    rounded to ``compute_dtype``."""
    for i, w in enumerate(weights):
        x = round_to(x, compute_dtype) @ round_to(w, compute_dtype)
        if i < len(weights) - 1:
            x = torch.relu(x)
    return x


class NGPField:
    """The field as the train step, the grid's update, the checkpoint and
    the render chunk see it (``minimal_nerf_torch.fields``); ``kernels``
    picks the CUDA kernels' encoding (the plain one on the CPU) or the plain
    indexing (``--kernel xla``)."""

    name = FIELD
    adam = {"b1": 0.9, "b2": 0.99, "eps": 1e-15}
    l2 = 1e-6
    # instant-ngp's configs/nerf/base.json learning rate, decayed by the
    # repo's per-epoch schedule to a tenth over its 1200 epochs
    lr = {"start_lr": 1e-2, "end_lr": 1e-3}
    mode, data_parallel = "full", False

    def __init__(self, cfg: NGPConfig = NGPConfig(), kernels: bool = True):
        from minimal_nerf_torch.kernels.hash_encode import hash_encode

        self.cfg, self.kernels = cfg, kernels
        self.levels = cfg.grid
        self.encode = hash_encode if kernels else hash_encode_plain

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        return init_ngp(generator, self.cfg, device)

    def shapes(self) -> Params:
        return param_shapes(self.cfg)

    def header(self) -> Dict[str, Any]:
        """What a checkpoint's header ``extra`` holds of the field."""
        return {"field": FIELD, "ngp": self.cfg.to_dict()}

    def features(self, params: Params, pts: torch.Tensor) -> torch.Tensor:
        """The encoding ``[P, L * F]`` of points ``pts [P, 3]``."""
        with profiling.span("nerf.ngp.encode"):
            return self.encode(to_unit_box(pts, self.cfg.bound).contiguous(), params["table"],
                               self.levels)

    def density(self, params: Params, pts: torch.Tensor, compute_dtype=None,
                grid_source=None) -> torch.Tensor:
        """The density ``[P]`` at points ``pts [P, 3]`` (the grid's update;
        one field serves every ``grid_source``)."""
        feats = self.features(params, pts)
        with profiling.span("nerf.ngp.mlp"):
            return torch.exp(mlp(params["density"], feats, compute_dtype)[:, 0])

    def apply(self, params: Params, samples: torch.Tensor, direc: torch.Tensor,
              position_dim=None, direction_dim=None, compute_dtype=None):
        """The render hook (``models.mlp.nerf_mlp_apply``'s signature; the
        encoding sizes are unused): ``samples [N, S, 3]``, directions ``[N,
        3]`` -> density ``[N, S, 1]``, rgb ``[N, S, 3]``."""
        lead = samples.shape[:-1]
        feats = self.features(params, samples.reshape(-1, 3))
        with profiling.span("nerf.ngp.mlp"):
            h = mlp(params["density"], feats, compute_dtype)
            sh = sh_encode(direc / torch.linalg.norm(direc, dim=-1, keepdim=True),
                           self.cfg.sh_degree)
            sh = sh[:, None, :].expand(*lead, sh.shape[-1]).reshape(-1, sh.shape[-1])
            rgb = torch.sigmoid(mlp(params["color"], torch.cat([h, sh], dim=-1), compute_dtype))
        return torch.exp(h[:, :1]).reshape(*lead, 1), rgb.reshape(*lead, 3)

    def hooks(self):
        """``(mlp_apply, render_fn)`` of the train step, the validation and
        the render chunk: this field in both passes of the plain render."""
        from minimal_nerf_torch.models.nerf import render_rays

        def render_fn(params, *args, **kwargs):
            return render_rays({"coarse": params, "fine": params}, *args, **kwargs)

        return self.apply, render_fn

    def adam_options(self, params: Params) -> Dict[str, Any]:
        """``training.loop.adam_apply``'s keywords for this field: its
        ``b1``, ``b2``, ``eps``; L2 on the MLP weights; the table updated
        sparsely (an entry with a zero gradient left as it is)."""
        return dict(self.adam,
                    l2={"table": 0.0, **{k: map_params(lambda _: self.l2, params[k])
                                         for k in ("density", "color")}},
                    sparse={"table": True, **{k: map_params(lambda _: False, params[k])
                                              for k in ("density", "color")}})

