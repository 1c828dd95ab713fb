"""TensoRF's VM field (Chen et al., ECCV 2022, sec. 3-4; ``configs/lego.txt``)
as the port runs it: density and appearance factors, plane x line at 300^2
and 300 (the CUDA kernels ``vm_sample_{fwd,bwd}``), the basis matrix and
the 128-wide shading MLP, one field for both passes of the fast recipe's
render, trained through ``make_multi_step``'s replayed step with TensoRF's
Adam (per-leaf learning rates, an L1 term on the density factors). Its
sizes and samples are the configuration's ``tensorf`` group.

Besides ``fields.INTERFACE``, the work the benchmark's readers take from
here: ``mlp_macs`` (the basis and the MLP's multiply-adds a point, forward
and backward) and ``vm_bytes_per_point`` (the bytes that no version of
either sampling kernel can avoid). ``fault: "plane"`` in the group (set
only by ``readings.py --override`` and the tests) puts back the first
mode's appearance plane after every call, a planted fault for the output
check.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from nerfbench.reference import tensorf as RT
from nerfbench.traffic import generate as gen

GROUP = "tensorf"


def program_configs(cfg: Dict[str, Any]):
    """The package's ``(NeRFConfig, TrainConfig, TensoRFConfig)`` of a
    configuration file."""
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.models.tensorf import TensoRFConfig
    from minimal_nerf_torch.training.config import TrainConfig

    t, tr, o = cfg[GROUP], cfg["train"], cfg["occupancy"]
    nerf_cfg = NeRFConfig(coarse_samples=t["coarse_samples"], fine_samples=t["fine_samples"],
                          near=t["near"], far=t["far"], fine_sampling=t["fine_sampling"])
    kw = {k: tr[k] for k in ("num_rays", "precision", "kernel", "steps_per_call",
                             "cropping_epochs", "steps_per_epoch", "start_lr", "end_lr",
                             "lr_decay_epochs", "lr_floor")}
    kw.update(occupancy=True, **{f"occ_{k}": v for k, v in o.items()})
    return nerf_cfg, TrainConfig(**kw), TensoRFConfig.from_dict(t)


def shapes(t: Dict[str, Any]) -> Dict[str, Any]:
    """The parameter tree's shapes: the factors channel-last, the basis
    ``[3 R_c, app_dim]``, each MLP layer's ``w [in, out]`` and ``b
    [out]``."""
    n, rd, rc, w = t["resolution"], t["density_components"], t["app_components"], \
        t["feature_width"]
    inp = t["app_dim"] + 3 + 2 * t["feature_pe"] * t["app_dim"] + 2 * t["view_pe"] * 3
    lin = lambda i, o: {"w": (i, o), "b": (o,)}  # noqa: E731
    return {"density_planes": (3, n, n, rd), "density_lines": (3, n, rd),
            "app_planes": (3, n, n, rc), "app_lines": (3, n, rc),
            "basis": (3 * rc, t["app_dim"]), "mlp": [lin(inp, w), lin(w, w), lin(w, 3)]}


def weights(seed: int, cfg: Dict[str, Any], traffic: Dict[str, Any], device) -> Dict[str, Any]:
    """Every factor ``U(+-factor_scale)`` (the group's: a density that
    varies across the box, as after training, not TensoRF's ``0.1 N(0, 1)``
    at step 0), then the basis and each MLP weight ``U(+-gain/sqrt(in))``
    (the traffic's gain) and each bias ``U(+-1/sqrt(in))``, all from one
    draw of the generator."""
    t = cfg[GROUP]
    s = shapes(t)
    factors = ("density_planes", "density_lines", "app_planes", "app_lines")
    total = (sum(math.prod(s[k]) for k in factors + ("basis",))
             + sum(math.prod(layer["w"]) + math.prod(layer["b"]) for layer in s["mlp"]))
    g = torch.Generator(device=device).manual_seed(gen.subseed(seed, gen.WEIGHTS))
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    pos = [0]

    def take(shape, scale):
        n = math.prod(shape)
        out = (u[pos[0]:pos[0] + n] * scale).reshape(shape).clone()
        pos[0] += n
        return out

    gain = traffic["weights"]["gain"]
    out = {k: take(s[k], t["factor_scale"]) for k in factors}
    out["basis"] = take(s["basis"], gain / math.sqrt(s["basis"][0]))
    out["mlp"] = [{"w": take(layer["w"], gain / math.sqrt(layer["w"][0])),
                   "b": take(layer["b"], 1.0 / math.sqrt(layer["w"][0]))}
                  for layer in s["mlp"]]
    return out


def points_per_ray(cfg: Dict[str, Any]) -> int:
    """The coarse pass and the sorted union of coarse and fine samples."""
    t = cfg[GROUP]
    return 2 * t["coarse_samples"] + t["fine_samples"]


def mlp_macs(cfg: Dict[str, Any]) -> Tuple[int, int]:
    """The basis and the MLP's multiply-adds a point, ``(forward,
    backward)``: forward every layer's ``in x out`` (3,888 + 19,200 + 16,384
    + 384 = 39,856 at the published widths); backward every weight's
    gradient again plus every layer's input gradient but the first MLP
    layer's rows of the view direction and its encoding (15 x 128), which
    carry no gradient to a parameter: 77,792."""
    s = shapes(cfg[GROUP])
    layers = [s["basis"]] + [layer["w"] for layer in s["mlp"]]
    fwd = sum(i * o for i, o in layers)
    view_rows = 3 + 2 * cfg[GROUP]["view_pe"] * 3
    return fwd, 2 * fwd - view_rows * s["mlp"][0]["w"][1]


def train_flops_per_ray(cfg: Dict[str, Any]) -> int:
    fwd, bwd = mlp_macs(cfg)
    return 2 * (fwd + bwd) * points_per_ray(cfg)


def render_flops_per_ray(cfg: Dict[str, Any]) -> int:
    return 2 * mlp_macs(cfg)[0] * points_per_ray(cfg)


def vm_bytes_per_point(cfg: Dict[str, Any]) -> int:
    """The bytes that no version of either sampling kernel can avoid per
    point, in the stated dtypes: the fp32 position read once and ``f_sigma``
    and the ``3 R_c`` fp32 products written once (forward), or their
    gradients read once (backward): ``12 + 4 (1 + 3 R_c)``, 592 at the
    published sizes. The factors' own traffic is left out: how much of it a
    kernel must move depends on which rows the points share, which the L2
    may serve."""
    return 4 * 3 + 4 * (1 + 3 * cfg[GROUP]["app_components"])


def train_program(cfg: Dict[str, Any], traffic: Dict[str, Any], focal: float, params, device):
    """``training.loop.make_multi_step`` (``make_train_step`` at one step per
    call) with the field ``models.tensorf.TensoRFField`` (the kernels'
    sampling unless the configuration's kernel is ``xla``) and the
    occupancy grid; the state is ``loop.adam_init``'s."""
    from minimal_nerf_torch.models.tensorf import TensoRFField
    from minimal_nerf_torch.training import loop

    nerf_cfg, train_cfg, tensorf_cfg = program_configs(cfg)
    static = loop.SceneStatic(height=traffic["height"], width=traffic["width"], focal=focal,
                              num_frames=traffic["frames"])
    field = TensoRFField(tensorf_cfg, kernels=train_cfg.kernel != "xla")
    occ_cfg = train_cfg.occupancy_config
    spc = train_cfg.steps_per_call
    if spc == 1:
        step = loop.make_train_step(nerf_cfg, train_cfg, static, None, device, None, occ_cfg,
                                    field=field)
    else:
        step = loop.make_multi_step(nerf_cfg, train_cfg, static, spc, None, device, None,
                                    occ_cfg, field=field)
    if cfg[GROUP].get("fault") == "plane":
        inner = step

        def step(params, state, *args):
            kept = params["app_planes"][0].clone()
            out = inner(params, state, *args)
            with torch.no_grad():
                out[0]["app_planes"][0] = kept
            return out
    return step, loop.adam_init(params)


def serve_program(cfg: Dict[str, Any], traffic: Dict[str, Any], params, grid, directory,
                  device):
    """A checkpoint of ``params`` and ``grid`` naming the field, written with
    the package's ``save_checkpoint`` into ``directory`` and loaded by
    ``inference.build_render_chunk`` for chunks of the traffic's ``chunk``
    rays."""
    from minimal_nerf_torch import inference
    from minimal_nerf_torch.models.tensorf import TensoRFField
    from minimal_nerf_torch.training.checkpoint import save_checkpoint

    nerf_cfg, train_cfg, tensorf_cfg = program_configs(cfg)
    ckpt = save_checkpoint(Path(directory) / "model.ckpt", params, traffic["checkpoint_step"],
                           nerf_cfg.to_dict(), train_cfg.to_dict(),
                           extra=dict({"mode": "full"}, **TensoRFField(tensorf_cfg).header()),
                           grid=grid)
    render_chunk, _, _ = inference.build_render_chunk(str(ckpt), rays=traffic["chunk"],
                                                      kernel=train_cfg.kernel, device=device)
    return render_chunk


reference = RT.tensorf_field
reference_numerics = RT.reference_numerics
control_numerics = RT.control_numerics
