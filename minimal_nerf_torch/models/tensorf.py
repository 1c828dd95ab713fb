"""TensoRF's VM field (Chen, Xu, Geiger, Yu, Su, TensoRF: Tensorial Radiance
Fields, ECCV 2022, sec. 3-4; the authors' ``TensorVMSplit`` and
``MLPRender_Fea`` at ``configs/lego.txt``'s sizes).

One field serves both render passes (``models.nerf.render_rays`` on
``{"coarse": params, "fine": params}``): the parameter tree is
``{"density_planes" [3, N, N, R_sigma], "density_lines" [3, N, R_sigma],
"app_planes" [3, N, N, R_c], "app_lines" [3, N, R_c], "basis" [3 R_c,
app_dim], "mlp": [{"w", "b"}] * 3}``, the factors channel-last
(``kernels.vm_sample``: mode ``m``'s plane is TensoRF's ``[1, R, N, N]``
permuted to ``[N, N, R]``).

- A point of the box ``[-bound, bound]^3`` samples the factors
  (``kernels.vm_sample``): ``f_sigma``, the sum over the 3 modes and the
  ``R_sigma`` components of plane x line, and the ``3 R_c`` appearance
  products; outside the box its density is 0 and it sends the factors no
  gradient;
- density ``distance_scale * softplus(f_sigma + density_shift)``
  (``25 softplus(f - 10)``, so that the render's ``1 - exp(-sigma delta)``
  is TensoRF's alpha at its distance scale);
- color: the products through ``basis`` (no bias) to ``app_dim`` features
  ``a``, then ``[a, d, PE(a, feature_pe), PE(d, view_pe)]`` (``d`` the unit
  view direction; ``PE(v, F)`` the sines, then the cosines, of ``v_c 2^f``
  at index ``c F + f``) through ``feature_width``-wide ReLU layers with
  biases to a sigmoid color.

Matmul inputs are rounded to the compute dtype with fp32 sums
(``models.mlp.linear``); the factors, their products and their gradients
stay fp32. The sampling goes through the CUDA kernels on a card unless the
field is built for the plain path (``--kernel xla``); CPU tensors and that
path take autograd through ``vm_sample.sample_plain``.

Training (``TensoRFField.adam_options``): Adam with ``b2 = 0.99``, ``eps =
1e-8``; the factors at the schedule's learning rate (TensoRF's ``lr_init``
0.02), ``basis`` and the MLP at ``basis_lr_scale`` of it (``lr_basis``
1e-3); TensoRF's L1 term on the density factors, ``w sign(p) / numel``
per mode's plane or line added to their gradients, its weight ``w``
(``l1_weight``) by the Adam update's count, a device scalar of the step's
inputs (``training.loop.adam_scalars``).

Spans (``utils.profiling``): ``nerf.tensorf.sample`` (the box and the
sampling kernels), ``nerf.tensorf.mlp`` (the density's softplus, the basis
and the shading MLP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from minimal_nerf_torch.kernels import vm_sample as vm
from minimal_nerf_torch.models.mlp import init_linear, linear, map_params, round_to
from minimal_nerf_torch.utils import profiling

Params = Dict[str, Any]

FIELD = "tensorf"  # the field's name in a checkpoint's header and on the command line


@dataclasses.dataclass(frozen=True)
class TensoRFConfig:
    """The field's sizes (``configs/lego.txt``: ``N_voxel_final`` 300^3,
    ``n_lamb_sigma`` 16 and ``n_lamb_sh`` 48 a mode, ``data_dim_color`` 27,
    ``featureC`` 128, ``fea_pe`` 2, ``view_pe`` 2; the Blender ``aabb``
    1.5, ``density_shift`` -10, ``distance_scale`` 25) and its optimizer's
    (``lr_basis`` over ``lr_init``, ``L1_weight_inital`` until the update
    ``l1_switch`` and ``L1_weight_rest`` from it)."""

    resolution: int = 300
    density_components: int = 16
    app_components: int = 48
    app_dim: int = 27
    feature_width: int = 128
    feature_pe: int = 2
    view_pe: int = 2
    bound: float = 1.5
    density_shift: float = -10.0
    distance_scale: float = 25.0
    basis_lr_scale: float = 0.05
    l1_initial: float = 8e-5
    l1_rest: float = 4e-5
    l1_switch: int = 2000

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TensoRFConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def mlp_input(self) -> int:
        """``app_dim + 3 + 2 feature_pe app_dim + 2 view_pe 3`` (150)."""
        return self.app_dim + 3 + 2 * self.feature_pe * self.app_dim + 2 * self.view_pe * 3


def param_shapes(cfg: TensoRFConfig) -> Params:
    """The parameter tree with each leaf's shape (module doc)."""
    n, rd, rc, w = cfg.resolution, cfg.density_components, cfg.app_components, cfg.feature_width
    lin = lambda i, o: {"w": (i, o), "b": (o,)}  # noqa: E731
    return {"density_planes": (3, n, n, rd), "density_lines": (3, n, rd),
            "app_planes": (3, n, n, rc), "app_lines": (3, n, rc),
            "basis": (3 * rc, cfg.app_dim),
            "mlp": [lin(cfg.mlp_input, w), lin(w, w), lin(w, 3)]}


def init_tensorf(generator: torch.Generator, cfg: TensoRFConfig, device="cuda") -> Params:
    """TensoRF's initialization, drawn in turn from ``generator``: every
    factor ``0.1 N(0, 1)`` (``init_one_svd``), ``basis`` ``U(+-1/sqrt(in))``
    (``nn.Linear``'s), the MLP's layers likewise with the last bias 0."""
    shapes = param_shapes(cfg)

    def normal(shape):
        return (0.1 * torch.randn(*shape, generator=generator, dtype=torch.float32,
                                  device=generator.device)).to(device)

    factors = {k: normal(shapes[k]) for k in vm.KEYS}
    bound = 1.0 / math.sqrt(3 * cfg.app_components)
    u = torch.rand(*shapes["basis"], generator=generator, dtype=torch.float32,
                   device=generator.device)
    mlp = [init_linear(*s["w"], generator, device) for s in shapes["mlp"]]
    mlp[-1]["b"] = torch.zeros_like(mlp[-1]["b"])
    return dict(factors, basis=(u * (2 * bound) - bound).to(device), mlp=mlp)


def frequency_encoding(v: torch.Tensor, freqs: int) -> torch.Tensor:
    """``[..., C] -> [..., 2 C freqs]``: ``sin(v_c 2^f)`` at ``c freqs + f``,
    then the cosines (TensoRF's ``positional_encoding``, no pi)."""
    scales = 2.0 ** torch.arange(freqs, dtype=torch.float32, device=v.device)
    pts = (v[..., None] * scales).reshape(*v.shape[:-1], freqs * v.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


class TensoRFField:
    """The field as the train step, the grid's update, the checkpoint and
    the render chunk see it (``minimal_nerf_torch.fields``); ``kernels``
    picks the CUDA kernels' sampling for CUDA tensors, or the plain
    indexing everywhere (``--kernel xla``)."""

    name = FIELD
    adam = {"b1": 0.9, "b2": 0.99, "eps": 1e-8}
    # lego.txt's lr_init and lr_decay_target_ratio 0.1 over its 30,000
    # steps: 300 epochs of a Blender scene's 100 frames under the repo's
    # per-epoch schedule
    lr = {"start_lr": 0.02, "end_lr": 0.002, "lr_decay_epochs": 300}
    mode, data_parallel = "full", False

    def __init__(self, cfg: TensoRFConfig = TensoRFConfig(), kernels: bool = True):
        self.cfg, self.kernels = cfg, kernels

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        return init_tensorf(generator, self.cfg, device)

    def shapes(self) -> Params:
        return param_shapes(self.cfg)

    def header(self) -> Dict[str, Any]:
        """What a checkpoint's header ``extra`` holds of the field."""
        return {"field": FIELD, FIELD: self.cfg.to_dict()}

    def sample(self, params: Params, pts: torch.Tensor, with_app: bool = True):
        """``(f_sigma [P], prods [P, 3 R_c] or None)`` at points ``pts [P,
        3]``."""
        factors = {k: params[k] for k in vm.KEYS}
        with profiling.span("nerf.tensorf.sample"):
            if self.kernels and pts.is_cuda:
                return vm.vm_sample(pts, factors, self.cfg.bound, with_app)
            return vm.sample_plain(pts.contiguous(), factors, self.cfg.bound, with_app)

    def _sigma(self, f_sigma: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return cfg.distance_scale * torch.nn.functional.softplus(f_sigma + cfg.density_shift)

    def density(self, params: Params, pts: torch.Tensor, compute_dtype=None,
                grid_source=None) -> torch.Tensor:
        """The density ``[P]`` at points ``pts [P, 3]`` from the density
        factors alone (the grid's update; one field serves every
        ``grid_source``)."""
        f_sigma, _ = self.sample(params, pts, with_app=False)
        with profiling.span("nerf.tensorf.mlp"):
            return self._sigma(f_sigma)

    def apply(self, params: Params, samples: torch.Tensor, direc: torch.Tensor,
              position_dim=None, direction_dim=None, compute_dtype=None):
        """The render hook (``models.mlp.nerf_mlp_apply``'s signature; the
        encoding sizes are unused): ``samples [N, S, 3]``, directions ``[N,
        3]`` -> density ``[N, S, 1]``, rgb ``[N, S, 3]``."""
        cfg, lead = self.cfg, samples.shape[:-1]
        f_sigma, prods = self.sample(params, samples.reshape(-1, 3))
        with profiling.span("nerf.tensorf.mlp"):
            sigma = self._sigma(f_sigma)
            a = round_to(prods, compute_dtype) @ round_to(params["basis"], compute_dtype)
            d = direc / torch.linalg.norm(direc, dim=-1, keepdim=True)
            d = torch.cat([d, frequency_encoding(d, cfg.view_pe)], dim=-1)
            d = d[:, None, :].expand(*lead, d.shape[-1]).reshape(-1, d.shape[-1])
            h = torch.cat([a, d[:, :3], frequency_encoding(a, cfg.feature_pe), d[:, 3:]],
                          dim=-1)
            mlp = params["mlp"]
            for layer in mlp[:-1]:
                h = torch.relu(linear(layer, h, compute_dtype))
            rgb = torch.sigmoid(linear(mlp[-1], h, compute_dtype))
        return sigma.reshape(*lead, 1), rgb.reshape(*lead, 3)

    def hooks(self):
        """``(mlp_apply, render_fn)`` of the train step, the validation and
        the render chunk: this field in both passes of the plain render."""
        from minimal_nerf_torch.models.nerf import render_rays

        def render_fn(params, *args, **kwargs):
            return render_rays({"coarse": params, "fine": params}, *args, **kwargs)

        return self.apply, render_fn

    def l1_weight(self, count: int) -> float:
        """The L1 term's weight at the Adam update ``count`` (0-based)."""
        return self.cfg.l1_initial if count < self.cfg.l1_switch else self.cfg.l1_rest

    def adam_options(self, params: Params) -> Dict[str, Any]:
        """``training.loop.adam_apply``'s keywords for this field: its
        ``b1``, ``b2``, ``eps``; the learning-rate scale of each leaf (1 on
        the factors, ``basis_lr_scale`` on the basis and the MLP); the L1
        term's ``1 / numel`` of one mode's density plane or line."""
        n, s = self.cfg.resolution, self.cfg.basis_lr_scale
        zero = {k: 0.0 for k in vm.KEYS[2:]}
        return dict(self.adam,
                    lr_scale=dict({k: 1.0 for k in vm.KEYS}, basis=s,
                                  mlp=map_params(lambda _: s, params["mlp"])),
                    l1=dict(zero, density_planes=1.0 / (n * n * self.cfg.density_components),
                            density_lines=1.0 / (n * self.cfg.density_components), basis=0.0,
                            mlp=map_params(lambda _: 0.0, params["mlp"])))
