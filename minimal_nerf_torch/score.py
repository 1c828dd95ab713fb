"""Score a checkpoint on a scene's test split: average PSNR and SSIM.

    python -m minimal_nerf_torch.score -c CKPT_PATH -r 4096 -b BASE_DIR

Same flags as the JAX package's ``score.py``, plus ``--device``;
``--data-parallel N`` splits each ray chunk over N cards
(``inference.build_render_chunk``; default 1, one card). Every test
view (or the first ``--limit``) is rendered through the kernel the
checkpoint trained under (``inference.build_render_chunk``), swept
``--frames-per-dispatch`` frames at a time with the frames kept on the
device (``views.render_poses_batched``), and scored against the uint8
ground truth with the torch metrics of ``ops/image_metrics.py`` on the same
device. The per-frame sums stay there and are fetched once at the end, so
scoring adds no wait for the device per frame. Frame ``i`` draws its
samples from ``views.mix_seed(0, i)`` (the JAX package from
``PRNGKey(i)``).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def calculate_scores(ckpt: str, base_dir, rays: int, limit: int = 0, kernel: str = "auto",
                     data_parallel: int = 1, ignore_occupancy: bool = False,
                     coarse: int = 0, fine: int = 0, bake_occupancy: bool = False,
                     frames_per_dispatch: int = 8, device="cuda"):
    """Print and return ``(average PSNR, average SSIM)`` over the test views."""
    import torch

    from minimal_nerf_torch import resolve_device, views
    from minimal_nerf_torch.data.synthetic import SyntheticScene
    from minimal_nerf_torch.inference import build_render_chunk
    from minimal_nerf_torch.ops.image_metrics import psnr, ssim

    dev = resolve_device(device)
    render_chunk, _, _ = build_render_chunk(
        ckpt, rays, kernel=kernel, data_parallel=data_parallel,
        ignore_occupancy=ignore_occupancy, coarse=coarse, fine=fine,
        bake_occupancy=bake_occupancy, device=dev)
    scene = SyntheticScene.load(base_dir, "test", dev)

    n = scene.num_frames if not limit else min(limit, scene.num_frames)
    psnr_sum = ssim_sum = torch.zeros((), dtype=torch.float64, device=dev)
    recon_iter = views.render_poses_batched(
        render_chunk, scene.poses[:n], scene.height, scene.width, scene.focal, chunk=rays,
        frames_per_dispatch=frames_per_dispatch, device=dev, device_frames=True)
    for idx, recon in enumerate(recon_iter):
        gt_im = scene.images[idx]
        ssim_sum = ssim_sum + ssim(gt_im, recon)
        psnr_sum = psnr_sum + psnr(gt_im, recon)

    psnr_total, ssim_total = torch.stack([psnr_sum, ssim_sum]).tolist()
    psnr_avg, ssim_avg = psnr_total / n, ssim_total / n
    print("==============Calculate Scores==============")
    print(f"average psnr score: {psnr_avg}")
    print(f"average ssim score: {ssim_avg}")
    return psnr_avg, ssim_avg


def main(argv=None):
    parser = argparse.ArgumentParser(description="Calculate score metrics for NeRF Models.")
    parser.add_argument("-c", "--ckpt", type=str, required=True, help="ckpt path for model")
    parser.add_argument("-r", "--rays", type=int, default=4096,
                        help="number of rays per batch")
    parser.add_argument("-b", "--base_dir", type=Path,
                        default=Path("./data/nerf_synthetic/lego/"), help="dataset directory")
    parser.add_argument("--limit", type=int, default=0,
                        help="score only the first N test views (0 = all)")
    parser.add_argument("--kernel", choices=["auto", "xla", "pallas", "fused"],
                        default="auto")
    parser.add_argument("--data-parallel", type=int, default=1,
                        help="split each ray chunk over this many cards of this process "
                             "(the CPU N times with --device cpu)")
    parser.add_argument("--ignore-occupancy", action="store_true",
                        help="uniform coarse sampling for occupancy checkpoints")
    parser.add_argument("--bake-occupancy", action="store_true",
                        help="bake an occupancy grid from the trained densities for a "
                             "checkpoint without one")
    parser.add_argument("--coarse", type=int, default=0,
                        help="override coarse samples/ray (0 = checkpoint value)")
    parser.add_argument("--fine", type=int, default=0,
                        help="override fine samples/ray (0 = checkpoint value)")
    parser.add_argument("--frames-per-dispatch", type=int, default=8,
                        help="test frames rendered per batch, the next batch queued before "
                             "this one is scored (1 = frame-at-a-time)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render and score on (default cuda)")
    args = parser.parse_args(argv)
    return calculate_scores(args.ckpt, args.base_dir, args.rays, limit=args.limit,
                            kernel=args.kernel, data_parallel=args.data_parallel,
                            ignore_occupancy=args.ignore_occupancy, coarse=args.coarse,
                            fine=args.fine, bake_occupancy=args.bake_occupancy,
                            frames_per_dispatch=args.frames_per_dispatch,
                            device=args.device)


if __name__ == "__main__":
    main()
