"""Tiny sizes at which every cell runs on the CPU through the package's
plain versions of its kernels (the published widths, few rays, samples and
pixels)."""

import pytest
import torch

TRAIN = {"frames": 4, "height": 24, "width": 24, "follow_steps": 3, "check_calls": 3,
         "reference_block_rays": 64, "trace_steps": 2}
VIEW = {"height": 24, "width": 24, "chunk": 64, "requests": 64, "check_points": 24 * 24 * 32 * 2,
        "reference_chunks_per_block": 2}


def tiny(workload: str, rays: int = None, samples: int = 16):
    """``run.run_cell``'s overrides of ``workload`` at a CPU size: 512 rays a
    step at one step per call, 128 at the fast recipe's 20."""
    cfg = {"train": {"num_rays": rays or (128 if "fast" in workload else 512)},
           "nerf": {"coarse_samples": samples, "fine_samples": samples}}
    if "fast" in workload:
        cfg["occupancy"] = {"resolution": 8, "warmup_steps": 4}
    return {"config": cfg, "traffic": TRAIN if workload.startswith("train") else VIEW}


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
