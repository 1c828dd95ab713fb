"""The NeRF MLP (Mildenhall et al., ECCV 2020) as the port runs it: a
coarse and a fine MLP on frequency encodings, trained and served through
``minimal_nerf_torch``'s fused kernels (the configuration's ``kernel``),
with the occupancy grid where the configuration has one. Its sizes and
samples are the configuration's ``nerf`` group."""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict

import torch

from nerfbench import counts
from nerfbench.reference import nerf as R
from nerfbench.traffic import generate as gen

GROUP = "nerf"


def program_configs(cfg: Dict[str, Any]):
    """The package's ``(NeRFConfig, TrainConfig)`` of a configuration file."""
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training.config import TrainConfig

    n, t, o = cfg["nerf"], cfg["train"], cfg.get("occupancy")
    nerf_cfg = NeRFConfig(position_dim=n["position_dim"], direction_dim=n["direction_dim"],
                          coarse_samples=n["coarse_samples"], fine_samples=n["fine_samples"],
                          near=n["near"], far=n["far"], fine_sampling=n["fine_sampling"])
    kw = {k: t[k] for k in ("num_rays", "precision", "kernel", "steps_per_call",
                            "cropping_epochs", "steps_per_epoch", "start_lr", "end_lr",
                            "lr_decay_epochs", "lr_floor")}
    if o:
        kw.update(occupancy=True, **{f"occ_{k}": v for k, v in o.items()})
    return nerf_cfg, TrainConfig(**kw)


def mlp_shapes(nerf: Dict[str, Any]) -> Dict[str, Any]:
    """The parameter tree of one MLP with each leaf's ``(in, out)`` or
    ``(out,)`` shape: ``{"w": [in, out], "b": [out]}`` per layer. The
    trunk's ``trunk_layers`` ReLU layers read the position encoding first;
    the ``feature_layers`` read it again beside the trunk's output (the
    skip), the last of them linear."""
    pe, de = 6 * nerf["position_dim"], 6 * nerf["direction_dim"]
    h, r = nerf["width"], nerf["rgb_width"]
    lin = lambda i, o: {"w": (i, o), "b": (o,)}  # noqa: E731
    return {"trunk": [lin(pe, h)] + [lin(h, h)] * (nerf["trunk_layers"] - 1),
            "feature": [lin(h + pe, h)] + [lin(h, h)] * (nerf["feature_layers"] - 1),
            "density": lin(h, 1),
            "rgb": [lin(h + de, r), lin(r, 3)]}


def weights(seed: int, cfg: Dict[str, Any], traffic: Dict[str, Any], device) -> Dict[str, Any]:
    """The coarse and fine MLPs, fp32: every weight ``U(+-gain/sqrt(in))``,
    every bias ``U(+-1/sqrt(in))``, plus ``density_bias`` on the density
    head's bias (the traffic's ``weights``), all from one draw of the
    generator. Copies of ``init_linear``'s uniform init with a gain and
    ``chip_smoke.py``'s +0.5 density bias."""
    spec = traffic["weights"]
    shapes = mlp_shapes(cfg["nerf"])
    layers = []

    def collect(tree):
        if isinstance(tree, dict) and "w" in tree:
            layers.append(tree)
        elif isinstance(tree, dict):
            for k in ("trunk", "feature", "density", "rgb"):
                collect(tree[k])
        else:
            for t in tree:
                collect(t)

    collect(shapes)
    total = 2 * sum(math.prod(s["w"]) + math.prod(s["b"]) for s in layers)
    g = torch.Generator(device=device).manual_seed(gen.subseed(seed, gen.WEIGHTS))
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    pos = [0]

    def take(shape, scale):
        n = math.prod(shape)
        out = (u[pos[0]:pos[0] + n] * scale).reshape(shape).clone()
        pos[0] += n
        return out

    def build(tree):
        if isinstance(tree, dict) and "w" in tree:
            bound = 1.0 / math.sqrt(tree["w"][0])
            return {"w": take(tree["w"], spec["gain"] * bound), "b": take(tree["b"], bound)}
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return [build(t) for t in tree]

    params = {name: build(shapes) for name in ("coarse", "fine")}
    for mlp in params.values():
        mlp["density"]["b"] += spec["density_bias"]
    return params


def points_per_ray(cfg: Dict[str, Any]) -> int:
    return counts.points_per_ray(cfg["nerf"])


def train_flops_per_ray(cfg: Dict[str, Any]) -> int:
    return counts.train_flops_per_ray(cfg["nerf"])


def render_flops_per_ray(cfg: Dict[str, Any]) -> int:
    return counts.render_flops_per_ray(cfg["nerf"])


def train_program(cfg: Dict[str, Any], traffic: Dict[str, Any], focal: float, params, device):
    """``training.loop.make_train_step`` at one step per call, else
    ``make_multi_step`` with the configuration's ``steps_per_call`` (one
    captured CUDA graph replayed per step), through
    ``loop.kernel_hooks(kernel)``, with the occupancy grid when the
    configuration has one; the state is ``loop.adam_init``'s."""
    from minimal_nerf_torch.training import loop

    nerf_cfg, train_cfg = program_configs(cfg)
    static = loop.SceneStatic(height=traffic["height"], width=traffic["width"], focal=focal,
                              num_frames=traffic["frames"])
    mlp_apply, render_fn = loop.kernel_hooks(train_cfg.kernel, device)
    occ_cfg = train_cfg.occupancy_config
    spc = train_cfg.steps_per_call
    if spc == 1:
        step = loop.make_train_step(nerf_cfg, train_cfg, static, render_fn, device, mlp_apply,
                                    occ_cfg)
    else:
        step = loop.make_multi_step(nerf_cfg, train_cfg, static, spc, render_fn, device,
                                    mlp_apply, occ_cfg)
    return step, loop.adam_init(params)


def serve_program(cfg: Dict[str, Any], traffic: Dict[str, Any], params, grid, directory,
                  device):
    """A checkpoint of ``params`` (and ``grid``) at the traffic's
    ``checkpoint_step``, written with the package's ``save_checkpoint``
    into ``directory`` and loaded by ``inference.build_render_chunk`` for
    chunks of the traffic's ``chunk`` rays."""
    from minimal_nerf_torch import inference
    from minimal_nerf_torch.training.checkpoint import save_checkpoint

    nerf_cfg, train_cfg = program_configs(cfg)
    ckpt = save_checkpoint(Path(directory) / "model.ckpt", params, traffic["checkpoint_step"],
                           nerf_cfg.to_dict(), train_cfg.to_dict(), grid=grid)
    render_chunk, _, _ = inference.build_render_chunk(str(ckpt), rays=traffic["chunk"],
                                                      kernel=train_cfg.kernel, device=device)
    return render_chunk


reference = R.nerf_field
reference_numerics = R.reference_numerics
control_numerics = R.control_numerics
