"""Benchmark: training throughput of the full hierarchical NeRF on one card.

    python -m minimal_nerf_torch.bench [--device cuda]

The port's counterpart of the JAX package's ``bench.py``, with its
definitions: 4096 rays per step, bf16 matmul inputs, no crop warmup, the
pixels drawn from a device-resident scene of 100 random 800x800 frames
(``bench_scene``), 20 train steps per call (``training.loop
.make_multi_step``: on the card one captured CUDA graph of the step,
replayed once per step), every path from JAX's init of ``NeRFConfig()``
(``bench_init``). Three paths, in ``bench.py``'s order:

- ``fused 64+128``: the production model through the fused ray-march
  forward and backward kernels (``kernels/fused_raymarch.py``);
- ``pallas 64+128``: the same model through the point-level MLP kernels
  under the plain render (``kernels/raymarch.py``, ``--kernel pallas``);
- ``fast (occupancy 16+48, fused)``: the ``--fast`` recipe, occupancy-guided
  coarse sampling (``ops/occupancy.py``, the sampler kernel
  ``kernels/occupancy_sampler.py``) at 16 + 48 samples through the fused
  kernels. Its grid warmup (256 steps) covers the first windows: they
  sample every cell.

Each path (``measure``) builds its kernels (timed on their own), runs one
warm-up call at step 0 (the CUDA graph's capture), then ``windows`` windows
of ``reps`` calls, ``start_step`` advancing by 20 per call. A window is
timed on the host clock and closes on the last call's loss read to the
host; its rate is ``reps * 20 * 4096 / seconds``. The path's value is its
best window, ``bench.py``'s definition; every window and their median are
printed beside it. The production rate is the larger of fused and pallas.

Prints ``[bench]`` lines on stderr (each window, the build and warm-up
seconds, the path's peak device memory, the memory still reserved after
the path is freed, the wrappers' launch counts of the path) and ONE JSON
line on stdout: ``bench.py``'s keys plus ``device`` and ``power_limit``.
There is no fallback: a path that fails to build, launch or step raises, so
the process exits non-zero. Without a card ``--device cuda`` (the default)
raises; ``--device cpu`` runs the kernels' plain versions.

Baseline: the reference publishes no training throughput; its only
measured rate is scoring at ~17.6k rays/s on a Colab P100
(``nerf_metrics.txt:5``). ``vs_baseline`` divides the training rate, a
heavier workload (forward, backward and Adam), by that rate.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from minimal_nerf_torch.utils import profiling

BASELINE_RAYS_PER_SEC = 17_600.0  # the reference's scoring rate on a Colab P100
SEED = 0  # the draws' seed and JAX's PRNGKey(0) of the init
FOCAL = 1111.111
CONFIG = "--fast recipe (occupancy 16+48, fused kernels, occupancy sampler kernel)"


def bench_scene(num_frames: int = 100, height: int = 800, width: int = 800, device="cuda"):
    """``(images, poses, static)``: ``bench.py``'s scene, uint8 ``[F, H, W,
    3]`` random frames from ``np.random.default_rng(0)`` and identity poses
    at ``z = 4``, on ``device``."""
    from minimal_nerf_torch.training.loop import SceneStatic

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (num_frames, height, width, 3), dtype=np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    poses[:, 2, 3] = 4.0
    static = SceneStatic(height=height, width=width, focal=FOCAL, num_frames=num_frames)
    return torch.from_numpy(images).to(device), torch.from_numpy(poses).to(device), static


def bench_init(nerf_cfg, device="cuda"):
    """JAX's ``init_nerf_network(PRNGKey(0), nerf_cfg)`` (``utils/threefry.py``)
    as fp32 tensors on ``device``."""
    from minimal_nerf_torch.models.mlp import params_from_jax
    from minimal_nerf_torch.utils import threefry

    return params_from_jax(threefry.init_nerf_network(SEED, nerf_cfg.position_dim,
                                                      nerf_cfg.direction_dim), device)


class TrainCalls:
    """One path's train state and its calls of ``num_inner`` steps
    (``loop.make_multi_step`` through the hooks of ``kernel``):
    ``calls(images, poses, start_step, inputs=None) -> last metrics``. The
    parameters (updated in place), the Adam state and, with an
    ``occupancy_cfg``, the grid start fresh and stay on the object."""

    def __init__(self, nerf_cfg, train_cfg, static, kernel: str, params, device,
                 occupancy_cfg=None, num_inner: int = 20):
        from minimal_nerf_torch.ops import occupancy as occ
        from minimal_nerf_torch.training import loop

        mlp_apply, render_fn = loop.kernel_hooks(kernel, device)
        self.multi_fn = loop.make_multi_step(nerf_cfg, train_cfg, static, num_inner, render_fn,
                                             device, mlp_apply, occupancy_cfg)
        self.params, self.opt_state = params, loop.adam_init(params)
        self.grid = occ.init_grid(occupancy_cfg, device) if occupancy_cfg is not None else None

    def __call__(self, images, poses, start_step: int, inputs=None) -> Dict[str, torch.Tensor]:
        if self.grid is None:
            self.params, self.opt_state, metrics = self.multi_fn(
                self.params, self.opt_state, images, poses, start_step, SEED, inputs=inputs)
        else:
            self.params, self.opt_state, self.grid, metrics = self.multi_fn(
                self.params, self.opt_state, self.grid, images, poses, start_step, SEED,
                inputs=inputs)
        return metrics


def _kernel_modules():
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import occupancy_probe as op
    from minimal_nerf_torch.kernels import occupancy_sampler as osk
    from minimal_nerf_torch.kernels import raymarch as rm

    return fr, rm, op, osk


def reset_launches() -> None:
    """Every launch counter set to 0 (``utils.profiling.reset``)."""
    profiling.reset()


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters by kernel (``utils.profiling``).
    On the card a replayed step runs no wrapper: each replay adds the
    launches its graph's capture counted."""
    fr, rm, op, osk = _kernel_modules()
    return {"fused_raymarch_fwd": profiling.counter(fr.FWD_LAUNCHES),
            "fused_raymarch_bwd": profiling.counter(fr.BWD_LAUNCHES),
            "raymarch_mlp_fwd": profiling.counter(rm.FWD_LAUNCHES),
            "raymarch_mlp_bwd": profiling.counter(rm.BWD_LAUNCHES),
            "occupancy_probe": profiling.counter(op.LAUNCHES),
            "occupancy_sampler": profiling.counter(osk.LAUNCHES)}


def path_kernels(kernel: str, occupancy_cfg=None):
    """The CUDA sources a path launches (``kernels/build.py`` names)."""
    fr, rm, _, osk = _kernel_modules()
    names = [fr.KERNEL, fr.BWD_KERNEL] if kernel == "fused" else [rm.KERNEL, rm.BWD_KERNEL]
    return names + ([osk.KERNEL] if occupancy_cfg is not None else [])


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def measure(label: str, nerf_cfg, train_cfg, static, images, poses, kernel: str,
            occupancy_cfg=None, num_inner: int = 20, windows: int = 3, reps: int = 5,
            clock: Callable[[], float] = time.perf_counter) -> Dict[str, Any]:
    """One path, as ``bench.py``'s ``measure``: the kernels built (on the
    card), one warm-up call at step 0, then ``windows`` windows of ``reps``
    calls of ``num_inner`` steps from step ``num_inner`` on, each timed by
    ``clock`` up to the host's read of its last loss.

    Returns ``label``, ``rates`` (rays/s of each window), ``best`` (their
    maximum, the path's value), ``median``, ``loss`` (the last call's),
    ``build_s``, ``warmup_s``, ``peak_bytes`` (``max_memory_allocated`` over
    the path on the card, else None) and ``launches`` (``launch_counts``
    after the path, set to 0 before it)."""
    from minimal_nerf_torch.kernels import build

    dev = images.device
    on_card = dev.type == "cuda"
    params = bench_init(nerf_cfg, dev)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    names = path_kernels(kernel, occupancy_cfg) if on_card else []
    t0 = clock()
    if names:
        build.build_all(names)  # every source at once
        for name in names:
            build.load(name)
    build_s = clock() - t0
    calls = TrainCalls(nerf_cfg, train_cfg, static, kernel, params, dev, occupancy_cfg,
                       num_inner)
    t0 = clock()
    loss = calls(images, poses, 0)["train_loss"].item()
    warmup_s = clock() - t0
    _log(f"{label}: kernels {names or 'none (plain versions)'} built and loaded in "
         f"{build_s:.2f} s; warm-up call (steps 0-{num_inner - 1}, the graph's capture) "
         f"{warmup_s:.2f} s, loss {loss:.4f}")
    warmup_steps = occupancy_cfg.warmup_steps if occupancy_cfg is not None else 0
    rates = []
    start = num_inner
    for w in range(windows):
        first = start
        t0 = clock()
        for _ in range(reps):
            metrics = calls(images, poses, start)
            start += num_inner
        loss = metrics["train_loss"].item()
        elapsed = clock() - t0
        rates.append(reps * num_inner * train_cfg.num_rays / elapsed)
        warm = max(0, min(start, warmup_steps) - first)
        _log(f"{label}: window {w} steps {first}-{start - 1}: {rates[-1]:,.1f} rays/s "
             f"({1e3 * elapsed / (reps * num_inner):.3f} ms/step, loss {loss:.4f}"
             + (f", {warm} of its steps in the grid warmup" if occupancy_cfg else "") + ")")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    result = {"label": label, "rates": rates, "best": max(rates),
              "median": statistics.median(rates), "loss": loss, "build_s": build_s,
              "warmup_s": warmup_s, "peak_bytes": peak, "launches": launch_counts()}
    _log(f"{label}: windows {', '.join(f'{r:,.0f}' for r in rates)} rays/s -> best "
         f"{result['best']:,.0f}, median {result['median']:,.0f} (loss {loss:.4f}); peak "
         + (f"{peak / 2 ** 20:.1f} MiB" if peak is not None else "not measured (no card)")
         + f"; wrapper launches {json.dumps(result['launches'])}")
    _log(f"result {json.dumps(result)}")
    return result


def card_power_limit(device) -> str:
    """The card's power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it (e.g. ``700.00 W``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    line = out.stdout.strip().splitlines()[torch.device(device).index or 0]
    _log(f"card {line}")
    return line.rsplit(",", 1)[1].strip()


def bench_paths(nerf_cfg=None):
    """``(key, label, nerf_cfg, kernel, occupancy_cfg)`` of the three paths,
    in ``bench.py``'s order: fused and pallas at ``nerf_cfg`` (default
    ``NeRFConfig()``, 64+128), then the fast recipe (16+48, occupancy,
    fused)."""
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training.config import TrainConfig

    nerf_cfg = nerf_cfg or NeRFConfig()
    samples = f"{nerf_cfg.coarse_samples}+{nerf_cfg.fine_samples}"
    return (("fused", f"fused {samples}", nerf_cfg, "fused", None),
            ("pallas", f"pallas {samples}", nerf_cfg, "pallas", None),
            ("fast", "fast (occupancy 16+48, fused)",
             dataclasses.replace(nerf_cfg, coarse_samples=16, fine_samples=48), "fused",
             TrainConfig(occupancy=True).occupancy_config))


def run(device="cuda", num_frames: int = 100, height: int = 800, width: int = 800,
        nerf_cfg=None, num_rays: int = 4096, num_inner: int = 20, reps: int = 5,
        windows: int = 3) -> Dict[str, Any]:
    """The three paths in ``bench.py``'s order on one scene; returns the JSON
    line's object. Between paths every reference to the finished one is
    dropped and the cache emptied, so its CUDA graph's private pool goes."""
    from minimal_nerf_torch import resolve_device
    from minimal_nerf_torch.training.config import TrainConfig

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    power_limit = card_power_limit(dev) if on_card else None
    t0 = time.perf_counter()
    images, poses, static = bench_scene(num_frames, height, width, dev)
    _log(f"scene {num_frames} x {height} x {width} uint8 on {dev} "
         f"({images.numel() / 1e6:.1f} MB) in {time.perf_counter() - t0:.2f} s")
    train_cfg = TrainConfig(num_rays=num_rays, cropping_epochs=0, precision="bf16")
    rates = {}
    for key, label, cfg, kernel, occ_cfg in bench_paths(nerf_cfg):
        rates[key] = measure(label, cfg, train_cfg, static, images, poses, kernel, occ_cfg,
                             num_inner, windows, reps)["best"]
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            _log(f"{label}: freed; reserved {torch.cuda.memory_reserved(dev) / 2 ** 20:.1f} "
                 f"MiB, allocated {torch.cuda.memory_allocated(dev) / 2 ** 20:.1f} MiB")
    production = max(rates["fused"], rates["pallas"])
    return {"metric": "train_rays_per_sec_per_chip_fast",
            "value": round(rates["fast"], 1),
            "unit": "rays/s",
            "vs_baseline": round(rates["fast"] / BASELINE_RAYS_PER_SEC, 2),
            "config": CONFIG,
            "production_64_128_rays_per_sec": round(production, 1),
            "production_vs_baseline": round(production / BASELINE_RAYS_PER_SEC, 2),
            "device": torch.cuda.get_device_name(dev) if on_card else str(dev),
            "power_limit": power_limit}


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description="Training throughput of the NeRF on one card.")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; cpu runs the kernels' "
                             "plain versions)")
    args = parser.parse_args(argv)
    line = run(args.device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
