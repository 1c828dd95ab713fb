"""Instant-NGP's NeRF field (Mueller et al., SIGGRAPH 2022, sec. 3-5.4) as
the port runs it: a multiresolution hash grid (the CUDA kernels
``hash_encode_{fwd,bwd}``), a density MLP and a color MLP on spherical
harmonics, one field for both passes of the fast recipe's render, trained
through ``make_multi_step``'s replayed step with its own Adam. Its sizes and
samples are the configuration's ``ngp`` group, its box the occupancy grid's.

Besides ``fields.INTERFACE``, the work the benchmark's readers take from
here: ``mlp_macs`` (the MLPs' multiply-adds a point, forward and backward)
and ``encode_bytes_per_point`` (the bytes that no version of either hash
kernel can avoid). ``fault: "finest"`` in the group (set only by
``readings.py --override``) puts back the finest level's table rows after
every call, a planted fault for the output check.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from nerfbench.reference import ngp as RN
from nerfbench.traffic import generate as gen

GROUP = "ngp"


def program_configs(cfg: Dict[str, Any]):
    """The package's ``(NeRFConfig, TrainConfig, NGPConfig)`` of a
    configuration file."""
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.models.ngp import NGPConfig
    from minimal_nerf_torch.training.config import TrainConfig

    n, t, o = cfg[GROUP], cfg["train"], cfg["occupancy"]
    nerf_cfg = NeRFConfig(coarse_samples=n["coarse_samples"], fine_samples=n["fine_samples"],
                          near=n["near"], far=n["far"], fine_sampling=n["fine_sampling"])
    kw = {k: t[k] for k in ("num_rays", "precision", "kernel", "steps_per_call",
                            "cropping_epochs", "steps_per_epoch", "start_lr", "end_lr",
                            "lr_decay_epochs", "lr_floor")}
    kw.update(occupancy=True, **{f"occ_{k}": v for k, v in o.items()})
    ngp_cfg = NGPConfig.from_dict(dict(n, bound=o["bound"]))
    return nerf_cfg, TrainConfig(**kw), ngp_cfg


def shapes(ngp: Dict[str, Any]) -> Dict[str, Any]:
    """The parameter tree's shapes: the table, then each MLP weight ``[in,
    out]`` (no biases)."""
    enc, sh = ngp["levels"] * ngp["features"], ngp["sh_degree"] ** 2
    dw, do, cw = ngp["density_width"], ngp["density_outputs"], ngp["color_width"]
    return {"table": (RN.entries(ngp), ngp["features"]),
            "density": [(enc, dw), (dw, do)],
            "color": [(do + sh, cw)] + [(cw, cw)] * (ngp["color_layers"] - 1) + [(cw, 3)]}


def weights(seed: int, cfg: Dict[str, Any], traffic: Dict[str, Any], device) -> Dict[str, Any]:
    """The table ``U(+-table_scale)`` (the group's: a field that varies
    across the scene, as after training, not the paper's 1e-4 at step 0),
    then each MLP weight ``U(+-gain/sqrt(in))`` (the traffic's gain), all
    from one draw of the generator."""
    ngp = cfg[GROUP]
    s = shapes(ngp)
    layers = s["density"] + s["color"]
    total = math.prod(s["table"]) + sum(math.prod(w) for w in layers)
    g = torch.Generator(device=device).manual_seed(gen.subseed(seed, gen.WEIGHTS))
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    pos = [0]

    def take(shape, scale):
        n = math.prod(shape)
        out = (u[pos[0]:pos[0] + n] * scale).reshape(shape).clone()
        pos[0] += n
        return out

    gain = traffic["weights"]["gain"]
    table = take(s["table"], ngp["table_scale"])
    return {"table": table,
            "density": [take(w, gain / math.sqrt(w[0])) for w in s["density"]],
            "color": [take(w, gain / math.sqrt(w[0])) for w in s["color"]]}


def points_per_ray(cfg: Dict[str, Any]) -> int:
    """The coarse pass and the sorted union of coarse and fine samples."""
    n = cfg[GROUP]
    return 2 * n["coarse_samples"] + n["fine_samples"]


def mlp_macs(cfg: Dict[str, Any]) -> Tuple[int, int]:
    """The MLPs' multiply-adds a point, ``(forward, backward)``: forward
    every layer's ``in x out`` (3,072 + 6,336 = 9,408 at the published
    widths); backward every weight's gradient again plus every layer's
    input gradient but the spherical harmonics' rows of the color MLP's
    first layer (the encoding's rows carry the table's gradient): 17,792."""
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


def encode_bytes_per_point(cfg: Dict[str, Any]) -> int:
    """The bytes that no version of either hash kernel can avoid per point,
    in the stated dtypes: the fp32 position read once and the ``L F`` fp32
    features written once (forward), or their gradient read once
    (backward): ``12 + 4 L F``, 140 at the published sizes. The table's own
    traffic is left out: how much of it a kernel must move depends on which
    entries the points share, which the L2 may serve."""
    n = cfg[GROUP]
    return 4 * 3 + 4 * n["levels"] * n["features"]


def _finest_rows(cfg: Dict[str, Any]) -> slice:
    _, offset, size, _ = RN.levels(cfg[GROUP])[-1]
    return slice(offset, offset + size)


def train_program(cfg: Dict[str, Any], traffic: Dict[str, Any], focal: float, params, device):
    """``training.loop.make_multi_step`` (``make_train_step`` at one step per
    call) with the field ``models.ngp.NGPField`` (the kernels' encoding
    unless the configuration's kernel is ``xla``) and the occupancy grid;
    the state is ``loop.adam_init``'s."""
    from minimal_nerf_torch.models.ngp import NGPField
    from minimal_nerf_torch.training import loop

    nerf_cfg, train_cfg, ngp_cfg = program_configs(cfg)
    static = loop.SceneStatic(height=traffic["height"], width=traffic["width"], focal=focal,
                              num_frames=traffic["frames"])
    field = NGPField(ngp_cfg, kernels=train_cfg.kernel != "xla")
    occ_cfg = train_cfg.occupancy_config
    spc = train_cfg.steps_per_call
    if spc == 1:
        step = loop.make_train_step(nerf_cfg, train_cfg, static, None, device, None, occ_cfg,
                                    field=field)
    else:
        step = loop.make_multi_step(nerf_cfg, train_cfg, static, spc, None, device, None,
                                    occ_cfg, field=field)
    if cfg[GROUP].get("fault") == "finest":
        rows, inner = _finest_rows(cfg), step

        def step(params, state, *args):
            kept = params["table"][rows].clone()
            out = inner(params, state, *args)
            with torch.no_grad():
                out[0]["table"][rows] = kept
            return out
    return step, loop.adam_init(params)


def serve_program(cfg: Dict[str, Any], traffic: Dict[str, Any], params, grid, directory,
                  device):
    """A checkpoint of ``params`` and ``grid`` naming the field, written with
    the package's ``save_checkpoint`` into ``directory`` and loaded by
    ``inference.build_render_chunk`` for chunks of the traffic's ``chunk``
    rays."""
    from minimal_nerf_torch import inference
    from minimal_nerf_torch.models.ngp import NGPField
    from minimal_nerf_torch.training.checkpoint import save_checkpoint

    nerf_cfg, train_cfg, ngp_cfg = program_configs(cfg)
    ckpt = save_checkpoint(Path(directory) / "model.ckpt", params, traffic["checkpoint_step"],
                           nerf_cfg.to_dict(), train_cfg.to_dict(),
                           extra=dict({"mode": "full"}, **NGPField(ngp_cfg).header()), grid=grid)
    render_chunk, _, _ = inference.build_render_chunk(str(ckpt), rays=traffic["chunk"],
                                                      kernel=train_cfg.kernel, device=device)
    return render_chunk


reference = RN.ngp_field
reference_numerics = RN.reference_numerics
control_numerics = RN.control_numerics
