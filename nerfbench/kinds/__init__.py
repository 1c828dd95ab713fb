"""Drivers of the traffic kinds (``traffic/<name>.json``'s ``kind``).

Each module has a ``Cell(spec, seed, device, log)`` with ``setup()`` (the
inputs from the seed, the program built and warmed, set-up's own part of
the output check), ``unit()`` (one step call or one request of the window,
not waited for), ``finish()`` (waits for the device), ``work(units)`` (the
rays and points of ``units`` units), ``release()`` (drops the program's
state) and ``check()`` (the numbers the output check compares).
"""

from __future__ import annotations

from typing import Any, Dict


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

