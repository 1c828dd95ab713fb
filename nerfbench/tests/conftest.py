"""Tiny sizes at which every cell runs on the CPU through the package's
plain versions of its kernels (the published widths, few rays, samples and
pixels)."""

import pytest
import torch

from nerfbench import spec

TRAIN = {"frames": 4, "height": 24, "width": 24, "follow_steps": 3, "check_calls": 3,
         "reference_block_rays": 64, "trace_steps": 2}
VIEW = {"height": 24, "width": 24, "chunk": 64, "requests": 64, "check_points": 24 * 24 * 32 * 2,
        "reference_chunks_per_block": 2}


def tiny(workload: str, rays: int = None, samples: int = 16):
    """``run.run_cell``'s overrides of ``workload`` at a CPU size, read from
    its configuration and traffic: 512 rays a step at one step per call, 128
    at more (the fast recipe's 20); ``samples`` coarse and fine samples in
    the field's group; an 8^3 grid warm after 4 steps where the
    configuration has an occupancy grid; the tiny scene of the traffic's
    kind."""
    cell = spec.load_cell(workload)
    cfg = cell["config"]
    over = {"train": {"num_rays": rays or (512 if cfg["train"]["steps_per_call"] == 1 else 128)},
            spec.field(cfg).GROUP: {"coarse_samples": samples, "fine_samples": samples}}
    if cfg.get("occupancy"):
        over["occupancy"] = {"resolution": 8, "warmup_steps": 4}
    return {"config": over, "traffic": {"train": TRAIN, "view": VIEW}[cell["traffic"]["kind"]]}


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
