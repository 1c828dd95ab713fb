"""A test-only field (``field: "stub"``): a small plain-PyTorch field with
no key of the NeRF MLP, whose "program" is its own plain step.

Per pass (``params["coarse"]``, ``params["fine"]``) one tanh layer of
``width`` on the raw position, a softplus density head and a sigmoid color
head that also reads the unit direction. Its optimizer is Adam with
Instant-NGP's ``b2`` and ``eps``. The program's train step runs the
reference's steps (``reference.nerf.train_steps``) on the program's state;
``fault = "unchanged"`` in its group makes the step return that state as
it came. It has no serving program.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from nerfbench.reference import nerf as R
from nerfbench.traffic import generate as gen

GROUP = "stub"


def _shapes(width: int) -> Dict[str, Any]:
    return {"w": (3, width), "b": (width,), "density": (width, 1), "color": (width, 3),
            "view": (3, 3)}


def weights(seed: int, cfg: Dict[str, Any], traffic: Dict[str, Any], device):
    g = torch.Generator(device=device).manual_seed(gen.subseed(seed, gen.WEIGHTS))
    return {name: {k: torch.rand(s, generator=g, device=device) - 0.5
                   for k, s in _shapes(cfg[GROUP]["width"]).items()}
            for name in ("coarse", "fine")}


def points_per_ray(cfg: Dict[str, Any]) -> int:
    s = cfg[GROUP]
    return 2 * s["coarse_samples"] + s["fine_samples"]


def train_flops_per_ray(cfg: Dict[str, Any]) -> int:
    return 3 * render_flops_per_ray(cfg)


def render_flops_per_ray(cfg: Dict[str, Any]) -> int:
    w = cfg[GROUP]["width"]
    return 2 * (3 * w + 4 * w) * points_per_ray(cfg)


def _point(params, which, x, d, num):
    p = params[which]
    if num == "bf16":
        x = x.to(torch.bfloat16).float()
    h = torch.tanh(x @ p["w"] + p["b"])
    dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rgb = torch.sigmoid(h @ p["color"] + (dn @ p["view"])[:, None, :])
    return torch.nn.functional.softplus(h @ p["density"])[..., 0], rgb


def _density(params, x, num):
    p = params["coarse"]
    return torch.nn.functional.softplus(torch.tanh(x @ p["w"] + p["b"]) @ p["density"])[..., 0]


def reference(cfg: Dict[str, Any]) -> R.Field:
    return R.Field(samples=cfg[GROUP], point=_point, density=_density,
                   adam=R.Adam(b2=0.99, eps=1e-15))


def reference_numerics(cfg: Dict[str, Any]) -> str:
    return "fp32"


def control_numerics(cfg: Dict[str, Any]) -> str:
    return "bf16"


def train_program(cfg: Dict[str, Any], traffic: Dict[str, Any], focal: float, params, device):
    field, num = reference(cfg), reference_numerics(cfg)
    spc = cfg["train"]["steps_per_call"]

    def step(params, state, images, poses, first: int, seed: int):
        with R.exact_float32():
            out = R.train_steps(params, cfg, images, poses, focal, seed, first, spc, num,
                                block_rays=traffic["reference_block_rays"], state=state,
                                field=field)
        metrics = {"train_loss": out["losses"][-1], "train_coarse_loss": out["coarse_losses"][-1]}
        if cfg[GROUP].get("fault") == "unchanged":
            return params, state, metrics
        return (R.unflatten(params, out["params"]),
                {"mu": out["mu"], "nu": out["nu"], "count": out["count"]}, metrics)

    return step, R.adam_state(params)


def serve_program(cfg, traffic, params, grid, directory, device):
    raise NotImplementedError("the stub field has no serving program")
