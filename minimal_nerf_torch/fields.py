"""The field a run trains or serves and the kernel it runs through, chosen
in one place for training and serving.

A field is what the train step, the occupancy grid, the checkpoint and the
render chunk know of a model: ``init(generator, device)``, ``shapes()`` (the
checkpoint's layout), ``header()`` (its entry in a checkpoint's ``extra``),
``density(params, pts [P, 3], compute_dtype, grid_source) -> [P]``,
``hooks()`` (the render hooks ``(mlp_apply, render_fn)``), ``adam`` and
``adam_options(params)`` (``training.loop.adam_apply``'s keywords), ``lr``
(learning rates replacing the ``TrainConfig``'s), ``mode`` (the training
mode of its tree) and ``data_parallel``; a field with an L1 term also has
``l1_weight(count)``, its weight at an Adam update. The fields: the NeRF
MLPs (``NeRFField``), Instant-NGP's (``models.ngp.NGPField``), TensoRF's
(``models.tensorf.TensoRFField``) and K-Planes' (``models.kplanes.
KPlanesField``).
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from minimal_nerf_torch.models.kplanes import FIELD as KPLANES, KPlanesConfig, KPlanesField
from minimal_nerf_torch.models.mlp import init_nerf_mlp, nerf_mlp_apply, nerf_mlp_shapes
from minimal_nerf_torch.models.nerf import NeRFConfig, init_nerf_network, render_rays
from minimal_nerf_torch.models.ngp import FIELD as NGP, NGPConfig, NGPField
from minimal_nerf_torch.models.tensorf import FIELD as TENSORF, TensoRFConfig, TensoRFField

Params = Dict[str, Any]

KERNELS = ("fused", "pallas", "xla")


def checkpoint_mode(header) -> str:
    """The training mode a checkpoint's header names (``"full"`` when it
    names none, as in JAX)."""
    return (header.get("extra") or {}).get("mode", "full")


def resolve_kernel(kernel: str, device="cuda", trained: str = "auto") -> str:
    """A ``--kernel`` choice as ``"fused"``, ``"pallas"`` (the point kernels
    under the plain render) or ``"xla"`` (the plain PyTorch path); another
    name raises ``ValueError``. ``"auto"`` takes ``trained``, the kernel a
    served checkpoint trained under, on a CUDA device (``"fused"`` for
    ``"auto"``), and the plain path elsewhere, saying so where the
    checkpoint trained under a kernel; an explicit choice is kept."""
    choice = kernel
    if kernel == "auto":
        if torch.device(device).type == "cuda":
            choice = "fused" if trained in ("auto", "fused") else trained
        else:
            if trained in ("pallas", "fused"):
                print(f"[views] checkpoint trained under the {trained!r} kernel is "
                      "rendered through the plain path on the CPU; expect a "
                      "train/inference numerics mismatch", file=sys.stderr)
            choice = "xla"
    if choice not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    return choice


def kernel_hooks(kernel: str, device="cuda",
                 mode: str = "full") -> Tuple[Optional[Callable], Optional[Callable]]:
    """``(mlp_apply, render_fn)`` of a ``--kernel`` choice (``train_nerf.py:
    261-282``), with packing caches of their own: the only caller of the
    kernels' hook factories. ``mode="single"`` (no ``render_fn``) gives the
    point kernels' hook for ``"pallas"``, else the plain MLP, as in JAX."""
    from minimal_nerf_torch.kernels.fused_raymarch import make_fused_render_fn
    from minimal_nerf_torch.kernels.raymarch import make_mlp_kernel_apply

    kernel = resolve_kernel(kernel, device)
    if mode == "single":
        return (make_mlp_kernel_apply() if kernel == "pallas" else None), None
    if kernel == "fused":
        return None, make_fused_render_fn()
    if kernel == "pallas":
        return make_mlp_kernel_apply(), render_rays
    return None, render_rays


def hooks_or(default, mlp_apply=None, render_fn=None):
    """The hooks given (an ``mlp_apply`` alone under the plain render), else
    ``default``'s: a field's, or a kernel's by name (``"fused"`` for the
    train step and its loss, ``"xla"`` for the eval step and the view
    chunks, as in JAX)."""
    if mlp_apply is not None or render_fn is not None:
        return mlp_apply, render_fn or render_rays
    return kernel_hooks(default) if isinstance(default, str) else default.hooks()


class NeRFField:
    """The coarse and fine MLPs (one MLP under ``mode="single"``) through
    ``kernel``'s hooks; optax's Adam, no header entry, no lr of their own."""

    name = "nerf"
    adam = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}
    lr: Dict[str, float] = {}
    data_parallel = True

    def __init__(self, cfg: NeRFConfig = NeRFConfig(), kernel: str = "fused",
                 mode: str = "full"):
        if mode not in ("full", "single"):
            raise ValueError(f"mode {mode!r}: the Trainer trains 'full' or 'single'")
        self.cfg, self.kernel, self.mode = cfg, kernel, mode

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        if self.mode == "single":
            return init_nerf_mlp(generator, self.cfg.position_dim, self.cfg.direction_dim,
                                 device=device)
        return init_nerf_network(generator, self.cfg, device=device)

    def shapes(self) -> Params:
        mlp = nerf_mlp_shapes(self.cfg.position_dim, self.cfg.direction_dim)
        return mlp if self.mode == "single" else {"coarse": mlp, "fine": mlp}

    def header(self) -> Dict[str, Any]:
        return {}

    def density(self, params: Params, pts: torch.Tensor, compute_dtype=None,
                grid_source: str = "coarse") -> torch.Tensor:
        """The plain MLP's density of the net(s) of ``grid_source`` (the max
        over both for ``"both"``), whatever the kernel."""
        pts = pts[:, None, :]  # [P, 1, 3]: one point per "ray"
        # density does not depend on the direction (its head reads the trunk
        # before the direction features join); any unit direction serves
        dirs = torch.zeros((pts.shape[0], 3), dtype=torch.float32, device=pts.device)
        dirs[:, 2] = -1.0
        nets = ("coarse", "fine") if grid_source == "both" else (grid_source,)
        sigma = None
        for name in nets:
            density, _ = nerf_mlp_apply(params[name], pts, dirs, self.cfg.position_dim,
                                        self.cfg.direction_dim, compute_dtype=compute_dtype)
            density = density[..., 0].float()
            sigma = density if sigma is None else torch.maximum(sigma, density)
        return sigma[:, 0]

    def hooks(self):
        return kernel_hooks(self.kernel, mode=self.mode)

    def adam_options(self, params: Params) -> Dict[str, Any]:
        return dict(self.adam)


def make_field(name: str, nerf_cfg: NeRFConfig, kernel: str = "fused", device="cuda",
               mode: str = "full", ngp: Optional[Dict[str, Any]] = None,
               tensorf: Optional[Dict[str, Any]] = None,
               kplanes: Optional[Dict[str, Any]] = None):
    """The field ``name`` (``--field``, a checkpoint's) under ``kernel``:
    the NeRF MLPs of ``nerf_cfg``, Instant-NGP's of the ``NGPConfig``
    fields in ``ngp``, TensoRF's of the ``TensoRFConfig`` fields in
    ``tensorf`` or K-Planes' of the ``KPlanesConfig`` fields in
    ``kplanes``, the last three through their CUDA kernels unless
    ``"xla"``."""
    kernel = resolve_kernel(kernel, device)
    if name == NeRFField.name:
        return NeRFField(nerf_cfg, kernel, mode)
    if name == NGP:
        return NGPField(NGPConfig.from_dict(ngp or {}), kernels=kernel != "xla")
    if name == TENSORF:
        return TensoRFField(TensoRFConfig.from_dict(tensorf or {}), kernels=kernel != "xla")
    if name == KPLANES:
        return KPlanesField(KPlanesConfig.from_dict(kplanes or {}), kernels=kernel != "xla")
    raise ValueError(f"unknown field {name!r}")


def checkpoint_field(header: Dict[str, Any], kernel: str = "fused"):
    """The field a checkpoint's header names (``extra["field"]``; else the
    NeRF MLPs, one MLP in ``mode="single"``) at its saved sizes."""
    extra = header.get("extra") or {}
    return make_field(extra.get("field", NeRFField.name),
                      NeRFConfig.from_dict(header.get("nerf_config", {})), kernel,
                      mode=checkpoint_mode(header), ngp=extra.get(NGP),
                      tensorf=extra.get(TENSORF), kplanes=extra.get(KPLANES))


def default_field(field, nerf_cfg: NeRFConfig, kernel: str = "fused", device="cuda",
                  mode: str = "full"):
    """``field``, or the NeRF MLPs of ``nerf_cfg`` where none is given."""
    return make_field(NeRFField.name, nerf_cfg, kernel, device, mode) if field is None else field
