"""K-Planes' hybrid field for a static scene (Fridovich-Keil et al., CVPR
2023, sec. 3-4; ``configs/final/NeRF/nerf_hybrid.py``) as the port runs it:
4 scales of 3 planes of 32 features at 64^2 to 512^2, multiplied per scale
(the CUDA kernels ``kplane_sample_{fwd,bwd}``), Instant-NGP's tiny density
and color MLPs, one field for both passes of the fast recipe's render,
trained through ``make_multi_step``'s replayed step with K-Planes' Adam and
its TV term on every plane. Its sizes and samples are the configuration's
``kplanes`` group.

Besides ``fields.INTERFACE``, the work the benchmark's readers take from
here: ``mlp_macs`` (the MLPs' multiply-adds a point, forward and backward)
and ``plane_bytes_per_point`` (the bytes that no version of either sampling
kernel can avoid). ``fault: "plane"`` in the group (set only by
``readings.py --override`` and the tests) puts back the finest scale's
first plane after every call, a planted fault for the output check.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from nerfbench.reference import kplanes as RK
from nerfbench.traffic import generate as gen

GROUP = "kplanes"


def program_configs(cfg: Dict[str, Any]):
    """The package's ``(NeRFConfig, TrainConfig, KPlanesConfig)`` of a
    configuration file."""
    from minimal_nerf_torch.models.kplanes import KPlanesConfig
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training.config import TrainConfig

    k, tr, o = cfg[GROUP], cfg["train"], cfg["occupancy"]
    nerf_cfg = NeRFConfig(coarse_samples=k["coarse_samples"], fine_samples=k["fine_samples"],
                          near=k["near"], far=k["far"], fine_sampling=k["fine_sampling"])
    kw = {key: tr[key] for key in ("num_rays", "precision", "kernel", "steps_per_call",
                                   "cropping_epochs", "steps_per_epoch", "start_lr", "end_lr",
                                   "lr_decay_epochs", "lr_floor")}
    kw.update(occupancy=True, **{f"occ_{key}": v for key, v in o.items()})
    return nerf_cfg, TrainConfig(**kw), KPlanesConfig.from_dict(k)


def shapes(k: Dict[str, Any]) -> Dict[str, Any]:
    """The parameter tree's shapes: per scale the planes ``[3, N_s, N_s, C]``
    channel-last, each MLP weight ``[in, out]`` (no biases)."""
    res = [k["base_resolution"] * m for m in k["multiscale"]]
    feats, sh = len(res) * k["features"], k["sh_degree"] ** 2
    dw, geo, cw = k["density_width"], k["geo_features"], k["color_width"]
    return {"planes": [(3, r, r, k["features"]) for r in res],
            "density": [(feats, dw), (dw, geo + 1)],
            "color": [(sh + geo, cw)] + [(cw, cw)] * (k["color_layers"] - 1) + [(cw, 3)]}


def weights(seed: int, cfg: Dict[str, Any], traffic: Dict[str, Any], device) -> Dict[str, Any]:
    """Every plane ``U(+-plane_scale)``, then each MLP weight
    ``U(+-gain/sqrt(in))`` (the traffic's gain), the density MLP's last
    column (the density's pre-activation) moved down by ``density_shift``
    times its bound, all from one draw of the generator: a density that
    varies across the box by orders of magnitude, a third or so of the box
    above the grid's threshold and the rest below it (the configuration's
    ``assumed`` gives the measured shares; K-Planes' planes ``U(0.1, 0.5)``
    are the state at step 0)."""
    k = cfg[GROUP]
    s = shapes(k)
    layers = s["density"] + s["color"]
    total = sum(math.prod(p) for p in s["planes"]) + sum(math.prod(w) for w in layers)
    g = torch.Generator(device=device).manual_seed(gen.subseed(seed, gen.WEIGHTS))
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    pos = [0]

    def take(shape, scale):
        n = math.prod(shape)
        out = (u[pos[0]:pos[0] + n] * scale).reshape(shape).clone()
        pos[0] += n
        return out

    gain = traffic["weights"]["gain"]
    planes = [take(p, k["plane_scale"]) for p in s["planes"]]
    density = [take(w, gain / math.sqrt(w[0])) for w in s["density"]]
    last = s["density"][-1]
    density[-1][:, k["geo_features"]] -= k["density_shift"] * gain / math.sqrt(last[0])
    return {"planes": planes, "density": density,
            "color": [take(w, gain / math.sqrt(w[0])) for w in s["color"]]}


def points_per_ray(cfg: Dict[str, Any]) -> int:
    """The coarse pass and the sorted union of coarse and fine samples."""
    k = cfg[GROUP]
    return 2 * k["coarse_samples"] + k["fine_samples"]


def mlp_macs(cfg: Dict[str, Any]) -> Tuple[int, int]:
    """The MLPs' multiply-adds a point, ``(forward, backward)``: forward
    every layer's ``in x out`` (8,192 + 1,024 + 1,984 + 4,096 + 192 =
    15,488 at the published widths); backward every weight's gradient
    again plus every layer's input gradient but the spherical harmonics'
    rows of the color MLP's first layer (the planes' features' rows carry
    the planes' gradient): 29,952."""
    s = shapes(cfg[GROUP])
    layers = s["density"] + s["color"]
    fwd = sum(i * o for i, o in layers)
    sh_rows = cfg[GROUP]["sh_degree"] ** 2
    return fwd, 2 * fwd - sh_rows * s["color"][0][1]


def train_flops_per_ray(cfg: Dict[str, Any]) -> int:
    fwd, bwd = mlp_macs(cfg)
    return 2 * (fwd + bwd) * points_per_ray(cfg)


def render_flops_per_ray(cfg: Dict[str, Any]) -> int:
    return 2 * mlp_macs(cfg)[0] * points_per_ray(cfg)


def plane_bytes_per_point(cfg: Dict[str, Any]) -> int:
    """The bytes that no version of either sampling kernel can avoid per
    point, in the stated dtypes: the fp32 position read once and the ``S
    C`` fp32 features written once (forward), or their gradient read once
    (backward): ``12 + 4 S C``, 524 at the published sizes. The planes' own
    traffic is left out: how much of it a kernel must move depends on which
    rows the points share, which the L2 may serve."""
    k = cfg[GROUP]
    return 4 * 3 + 4 * len(k["multiscale"]) * k["features"]


def train_program(cfg: Dict[str, Any], traffic: Dict[str, Any], focal: float, params, device):
    """``training.loop.make_multi_step`` (``make_train_step`` at one step per
    call) with the field ``models.kplanes.KPlanesField`` (the kernels'
    sampling unless the configuration's kernel is ``xla``) and the
    occupancy grid; the state is ``loop.adam_init``'s."""
    from minimal_nerf_torch.models.kplanes import KPlanesField
    from minimal_nerf_torch.training import loop

    nerf_cfg, train_cfg, kplanes_cfg = program_configs(cfg)
    static = loop.SceneStatic(height=traffic["height"], width=traffic["width"], focal=focal,
                              num_frames=traffic["frames"])
    field = KPlanesField(kplanes_cfg, kernels=train_cfg.kernel != "xla")
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
            kept = params["planes"][-1][0].clone()
            out = inner(params, state, *args)
            with torch.no_grad():
                out[0]["planes"][-1][0] = kept
            return out
    return step, loop.adam_init(params)


def serve_program(cfg: Dict[str, Any], traffic: Dict[str, Any], params, grid, directory,
                  device):
    """A checkpoint of ``params`` and ``grid`` naming the field, written with
    the package's ``save_checkpoint`` into ``directory`` and loaded by
    ``inference.build_render_chunk`` for chunks of the traffic's ``chunk``
    rays."""
    from minimal_nerf_torch import inference
    from minimal_nerf_torch.models.kplanes import KPlanesField
    from minimal_nerf_torch.training.checkpoint import save_checkpoint

    nerf_cfg, train_cfg, kplanes_cfg = program_configs(cfg)
    ckpt = save_checkpoint(Path(directory) / "model.ckpt", params, traffic["checkpoint_step"],
                           nerf_cfg.to_dict(), train_cfg.to_dict(),
                           extra=dict({"mode": "full"}, **KPlanesField(kplanes_cfg).header()),
                           grid=grid)
    render_chunk, _, _ = inference.build_render_chunk(str(ckpt), rays=traffic["chunk"],
                                                      kernel=train_cfg.kernel, device=device)
    return render_chunk


reference = RK.kplanes_field
reference_numerics = RK.reference_numerics
control_numerics = RK.control_numerics
