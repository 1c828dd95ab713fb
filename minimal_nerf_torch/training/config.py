"""Training configuration dataclass.

Counterpart of ``minimal_nerf_tpu/training/config.py`` with the same fields
and ``to_dict``/``from_dict``, so checkpoint headers read the same in both
packages. Defaults mirror the reference (4096 rays/batch, Adam 5e-4 decaying
to 5e-5 over 1200 epochs, bf16 matmul inputs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_rays: int = 4096
    max_steps: int = 100000
    cropping_epochs: int = 10
    check_val_every_n_epoch: int = 10
    start_lr: float = 5e-4
    end_lr: float = 5e-5
    lr_decay_epochs: int = 1200
    lr_floor: float = 0.0
    seed: int = 0
    # "bf16": matmul inputs rounded to bfloat16 (fp32 accumulation); "fp32"
    precision: str = "bf16"
    log_every: int = 100
    ckpt_every_steps: int = 10000
    steps_per_epoch: Optional[int] = None
    val_render_every: int = 1
    steps_per_call: int = 1
    # kernel the run trained under ("xla" | "pallas" | "fused" | "auto");
    # inference renders through the same one by default
    kernel: str = "auto"
    rng_impl: str = "threefry2x32"
    # occupancy-grid sampling (ops.occupancy.OccupancyConfig's fields)
    occupancy: bool = False
    occ_resolution: int = 64
    occ_bound: float = 3.2
    occ_threshold: float = 1e-2
    occ_rel_threshold: float = 1e-2
    occ_decay: float = 0.9
    occ_update_every: int = 16
    occ_warmup_steps: int = 256
    occ_num_bins: int = 64
    occ_floor: float = 0.25
    occ_in_bin_jitter: bool = True
    occ_grid_source: str = "coarse"
    occ_probe_method: str = "auto"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in d.items() if k in known}
        if d.get("occupancy") and "occ_rel_threshold" not in d:
            # runs from before the relative threshold used the absolute cutoff
            kept["occ_rel_threshold"] = 0.0
        return cls(**kept)

    @property
    def occupancy_config(self):
        """The ``ops.occupancy.OccupancyConfig`` this config describes, or None
        when occupancy is off."""
        if not self.occupancy:
            return None
        from minimal_nerf_torch.ops.occupancy import OccupancyConfig

        return OccupancyConfig(
            resolution=self.occ_resolution, bound=self.occ_bound,
            threshold=self.occ_threshold, rel_threshold=self.occ_rel_threshold,
            decay=self.occ_decay, update_every=self.occ_update_every,
            warmup_steps=self.occ_warmup_steps, num_bins=self.occ_num_bins,
            floor=self.occ_floor, in_bin_jitter=self.occ_in_bin_jitter,
            grid_source=self.occ_grid_source, probe_method=self.occ_probe_method)

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.precision == "bf16" else None
