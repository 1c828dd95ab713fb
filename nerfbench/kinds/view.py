"""View traffic: one 800x800 novel view per request on the render CLI's
orbit, the next request sent when the last frame is on the host (a closed
loop), as a viewer asks for views one at a time.

Set-up writes a checkpoint of the seeded weights (and grid) with the
package's ``save_checkpoint`` into a temporary directory, loads it through
``inference.build_render_chunk`` and renders one warm-up view. A request is
``views.render_poses_batched`` over that render chunk for one pose, its
frame taken from the iterator (on the host) and copied out of the sweep's
pinned buffer, as a client that keeps it would. Every frame of the window
is kept.

``check()`` draws from the seed a sample of the window's frames, as many as
``check_points`` sample points allow (at least one), renders them with
``reference.nerf.render_frame`` from the same weights, grid, poses and frame
seeds, and compares the 8-bit frames (``compare``): ``frame_mean_abs``, the
mean absolute difference in levels of the worst frame, and
``chunk_mean_abs_max``, that of the worst chunk of ``chunk`` pixels, which a
wrong chunk moves even when its frame's mean stays low.
"""

from __future__ import annotations

import gc
import tempfile
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from nerfbench import counts
from nerfbench.kinds import program_configs
from nerfbench.reference import nerf as R
from nerfbench.traffic import generate as gen

SAMPLE = 7  # the subseed tag of the output check's sample


class Cell:
    unit_name = "request"

    def __init__(self, spec: Dict[str, Any], seed: int, device, log):
        self.spec, self.seed, self.dev, self.log = spec, seed, torch.device(device), log
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.trace_units = self.traffic["trace_frames"]
        tr = self.traffic
        self.pixels = tr["height"] * tr["width"]
        self.ppr = counts.points_per_ray(self.cfg["nerf"])

    def work(self, units: int) -> Dict[str, int]:
        return {"rays": units * self.pixels, "points": units * self.pixels * self.ppr,
                "frames": units}

    def setup(self) -> None:
        from minimal_nerf_torch import inference
        from minimal_nerf_torch.training.checkpoint import save_checkpoint

        cfg, tr, dev = self.cfg, self.traffic, self.dev
        params = gen.weights(self.seed, cfg["nerf"], tr["weights"], dev)
        self.params0 = R.map_tree(lambda t: t.detach().clone(), params)
        occ = cfg.get("occupancy")
        self.grid0 = gen.grid(self.seed, occ, tr["grid"], dev) if occ else None
        if occ:
            self.log(f"grid: {100.0 * float((self.grid0 > 0).float().mean()):.4f}% of cells "
                     "inside the seeded object")
        nerf_cfg, train_cfg = program_configs(cfg)
        self.tmp = tempfile.TemporaryDirectory(prefix="nerfbench-")
        ckpt = save_checkpoint(Path(self.tmp.name) / "model.ckpt", params,
                               tr["checkpoint_step"], nerf_cfg.to_dict(), train_cfg.to_dict(),
                               grid=self.grid0)
        self.render_chunk, _, _ = inference.build_render_chunk(
            str(ckpt), rays=tr["chunk"], kernel=train_cfg.kernel, device=dev)
        n = tr["requests"]
        self.poses = gen.orbit_poses(self.seed, n + 1, tr, dev)
        self.frame_seeds = gen.frame_seeds(self.seed, n + 1)
        self.focal = gen.focal_from_angle(tr["width"], tr["camera_angle_x"])
        self._request(n)  # the warm-up view, not one of the window's requests
        self.frames: List[np.ndarray] = []

    def _request(self, i: int) -> np.ndarray:
        from minimal_nerf_torch import views

        tr = self.traffic
        frames = views.render_poses_batched(
            self.render_chunk, self.poses[i:i + 1], tr["height"], tr["width"], self.focal,
            chunk=tr["chunk"], frame_seeds=[self.frame_seeds[i]],
            frames_per_dispatch=tr["frames_per_dispatch"], device=self.dev)
        return next(frames)

    def unit(self) -> None:
        if len(self.frames) >= self.traffic["requests"]:
            raise RuntimeError(f"more than {self.traffic['requests']} requests in one run")
        # a copy: the delivered frame lies in a pinned buffer of the sweep's,
        # which goes back to the program's allocator once the client drops it
        self.frames.append(np.array(self._request(len(self.frames))))

    def finish(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def release(self) -> None:
        self.render_chunk = None
        self.tmp.cleanup()
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List[int]:
        """The frames the output check compares, drawn from the seed."""
        k = max(1, self.traffic["check_points"] // (self.pixels * self.ppr))
        rng = np.random.default_rng(gen.subseed(self.seed, SAMPLE))
        return sorted(int(i) for i in rng.choice(len(self.frames), min(k, len(self.frames)),
                                                 replace=False))

    def reference_frames(self, numerics: R.Numerics, indices: List[int]) -> List[torch.Tensor]:
        tr = self.traffic
        with R.exact_float32():
            return [R.to_uint8(R.render_frame(
                self.params0, self.cfg, self.poses[i], tr["height"], tr["width"], self.focal,
                self.frame_seeds[i], tr["chunk"], numerics, self.grid0,
                tr["reference_chunks_per_block"])) for i in indices]

    def compare(self, got: List[torch.Tensor], ref: List[torch.Tensor]) -> Dict[str, float]:
        chunk = self.traffic["chunk"]
        frame_mean, chunk_max = 0.0, 0.0
        for a, b in zip(got, ref):
            diff = (a.to(b.device).float() - b.float()).abs().reshape(-1, 3)
            frame_mean = max(frame_mean, float(diff.mean()))
            far = diff.amax(dim=1) > 8
            self.log(f"frame: mean |diff| {float(diff.mean())!r} levels; "
                     f"{100.0 * float(far.float().mean())!r}% of pixels off by more than 8 "
                     f"carry {100.0 * float(diff[far].sum() / diff.sum().clamp(min=1e-9))!r}%")
            for lo in range(0, diff.shape[0], chunk):
                chunk_max = max(chunk_max, float(diff[lo:lo + chunk].mean()))
        return {"frame_mean_abs": frame_mean, "chunk_mean_abs_max": chunk_max}

    def check(self) -> Dict[str, float]:
        idx = self.sample()
        self.log(f"output check: frames {idx} of {len(self.frames)}")
        got = [torch.from_numpy(np.asarray(self.frames[i])) for i in idx]
        return self.compare(got, self.reference_frames(R.reference_numerics(self.cfg), idx))

    def control(self) -> Dict[str, float]:
        """The reference in the control's precision in the program's place."""
        idx = self.sample()
        return self.compare(self.reference_frames(R.control_numerics(self.cfg), idx),
                            self.reference_frames(R.reference_numerics(self.cfg), idx))
