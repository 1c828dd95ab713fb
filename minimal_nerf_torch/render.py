"""Render a 360-degree orbit gif from a checkpoint.

    python -m minimal_nerf_torch.render -c CKPT_PATH -r 4096 -p 40 -s SAVE_DIR

Same flags as the JAX package's ``render.py``, plus ``--device``;
``--data-parallel N`` splits each ray chunk over N cards
(``inference.build_render_chunk``; default 1, one card). The orbit
is swept ``--frames-per-dispatch`` poses at a time (default 8), the next
batch queued on the device before this one is fetched
(``views.render_poses_batched``); the frames are the same for any value.
The gif is named from the checkpoint's ``epoch=`` substring:
``{SAVE_DIR}/{epoch}-360.gif``. ``render_views`` yields the uint8 frames
without writing anything.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Iterator

import numpy as np


def render_views(ckpt: str, rays: int = 4096, num_poses: int = 40, height: int = 800,
                 width: int = 800, kernel: str = "auto", coarse: int = 0, fine: int = 0,
                 device="cuda", data_parallel: int = 1, ignore_occupancy: bool = False,
                 bake_occupancy: bool = False,
                 frames_per_dispatch: int = 8) -> Iterator[np.ndarray]:
    """Yield the orbit's ``[H, W, 3]`` uint8 frames."""
    from minimal_nerf_torch import resolve_device, views
    from minimal_nerf_torch.inference import build_render_chunk

    dev = resolve_device(device)
    render_chunk, _, _ = build_render_chunk(
        ckpt, rays, kernel=kernel, data_parallel=data_parallel,
        ignore_occupancy=ignore_occupancy, coarse=coarse, fine=fine,
        bake_occupancy=bake_occupancy, device=dev)
    return views.orbit_views(render_chunk, height=height, width=width, chunk=rays,
                             num_poses=num_poses, frames_per_dispatch=frames_per_dispatch,
                             device=dev)


def epoch_tag(ckpt: str) -> str:
    """The ``epoch=E`` part of a checkpoint name (reference ``render.py:15-16``)."""
    i = ckpt.find("epoch=")
    return ckpt[i: i + ckpt[i:].find("-")]


def render(ckpt: str, save_dir: Path, rays: int, num_poses: int, height: int = 800,
           width: int = 800, kernel: str = "auto", coarse: int = 0, fine: int = 0,
           device="cuda", **options) -> Path:
    """Render the orbit and write ``{save_dir}/{epoch}-360.gif``."""
    from minimal_nerf_torch.utils import imageio as mio

    frames = list(render_views(ckpt, rays, num_poses, height, width, kernel, coarse,
                               fine, device, **options))
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    out = save_dir / f"{epoch_tag(ckpt)}-360.gif"
    mio.mimwrite(out, frames)
    return out


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description="Render a 360 view from a NeRF Model")
    parser.add_argument("-c", "--ckpt", type=str, required=True, help="ckpt path for model")
    parser.add_argument("-r", "--rays", type=int, default=4096,
                        help="number of rays per batch")
    parser.add_argument("-p", "--num_poses", type=int, default=40,
                        help="number of images in gif.")
    parser.add_argument("-s", "--save_dir", type=Path, default=Path("./recons/"),
                        help="where to save the resulting gif")
    parser.add_argument("--height", type=int, default=800)
    parser.add_argument("--width", type=int, default=800)
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
                        help="poses rendered per batch, the next batch queued before "
                             "this one is fetched (1 = pose-at-a-time)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default cuda)")
    args = parser.parse_args(argv)
    return render(args.ckpt, args.save_dir, args.rays, args.num_poses, height=args.height,
                  width=args.width, kernel=args.kernel, coarse=args.coarse, fine=args.fine,
                  device=args.device, data_parallel=args.data_parallel,
                  ignore_occupancy=args.ignore_occupancy,
                  bake_occupancy=args.bake_occupancy,
                  frames_per_dispatch=args.frames_per_dispatch)


if __name__ == "__main__":
    print(main())
