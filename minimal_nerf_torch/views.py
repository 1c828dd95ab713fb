"""View reconstruction and 360-degree view synthesis.

Counterpart of ``minimal_nerf_tpu/views.py``. A view is swept in ray chunks
by a plain Python loop (PyTorch runs eagerly, so there is nothing to trace);
chunk ``i`` of a frame draws its samples from a ``torch.Generator`` seeded
from ``(frame seed, i)``, so a frame renders the same whatever else runs.
A ``render_chunk`` is ``(o [C, 3], d [C, 3], generator) -> rgb [C, 3]``.

``photo_nerf_to_image`` sweeps a 2-D image model over every pixel of a
photo (``train simple``). ``make_sharded_render_chunk`` splits each chunk
over several devices of this process (render and score ``--data-parallel``).

Many poses (the render CLI's orbit, the score CLI's test split) go through
``render_poses_batched``: ``frames_per_dispatch`` frames per batch, the next
batch queued on the device before this one is waited for, each batch
fetched in one asynchronous copy (or kept on the device for scoring).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from minimal_nerf_torch.models.nerf import NeRFConfig, render_rays
from minimal_nerf_torch.ops import cameras
from minimal_nerf_torch.utils import profiling

# Blender-synthetic default horizontal FoV (reference nerf_helpers.py:163)
DEFAULT_CAM_ANGLE_X = 0.6911112070083618


def mix_seed(*ints: int) -> int:
    """A 63-bit seed mixed from integers (``numpy.random.SeedSequence``)."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def chunk_generator(frame_seed: int, chunk_index: int, device) -> torch.Generator:
    """The generator of chunk ``chunk_index`` of the frame with ``frame_seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(frame_seed, chunk_index))
    return g


def resolve_inference_kernel(kernel: str, train_cfg=None, device="cuda") -> str:
    """Resolve an inference ``--kernel`` choice to ``"fused"``, ``"pallas"``
    or ``"xla"``.

    ``"xla"`` names the plain path (``models.nerf.render_rays``) and
    ``"pallas"`` the plain render around the point-level MLP kernels, as in
    the JAX package. ``"auto"`` prefers the kernel the checkpoint trained
    under: on a CUDA device a fused- or auto-trained checkpoint renders
    through ``"fused"`` and a pallas-trained one through ``"pallas"``; on the
    CPU ``"auto"`` takes the plain path and says so when the checkpoint
    trained under a kernel. An explicit choice is kept (on the CPU a kernel
    runs its plain version).
    """
    trained = getattr(train_cfg, "kernel", "auto") if train_cfg is not None else "auto"
    choice = kernel if kernel != "auto" else None
    if choice is None:
        if torch.device(device).type == "cuda":
            choice = "fused" if trained in ("auto", "fused") else trained
        else:
            if trained in ("pallas", "fused"):
                print(f"[views] checkpoint trained under the {trained!r} kernel is "
                      "rendered through the plain path on the CPU; expect a "
                      "train/inference numerics mismatch", file=sys.stderr)
            choice = "xla"
    if choice not in ("xla", "fused", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r}")
    return choice


def _to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    # clip then truncate (reference nerf_helpers.py:208-210)
    return torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)


def view_reconstruction(render_chunk: Callable, all_o_rays: torch.Tensor,
                        all_d_rays: torch.Tensor, chunk: int = 4096,
                        seed: int = 0) -> np.ndarray:
    """Render ``[H, W, 3]`` rays chunk by chunk -> ``[H, W, 3]`` uint8."""
    h, w, c = all_o_rays.shape
    o = all_o_rays.reshape(h * w, c)
    d = all_d_rays.reshape(h * w, c)
    out = []
    with torch.no_grad():
        for i, lo in enumerate(range(0, h * w, chunk)):
            g = chunk_generator(seed, i, o.device)
            out.append(render_chunk(o[lo:lo + chunk], d[lo:lo + chunk], g))
    return _to_uint8(torch.cat(out)).reshape(h, w, 3).cpu().numpy()


def render_poses_batched(render_chunk: Callable, poses, height: int, width: int,
                         focal, chunk: int = 4096,
                         frame_seeds: Optional[Sequence[int]] = None,
                         frames_per_dispatch: int = 8, device="cuda",
                         device_frames: bool = False) -> Iterator:
    """Yield one ``[H, W, 3]`` uint8 frame per pose, in order, rendered
    ``frames_per_dispatch`` frames at a time with one batch of lookahead.

    Rays are made on ``device`` for each chunk's own pixels; frame ``i``
    seeds its chunks from ``frame_seeds[i]`` (default ``mix_seed(0, i)``), so
    the frames are the same for every ``frames_per_dispatch``. Frame ``i`` is
    the span ``nerf.view.frame`` of unit ``i``, and each of its chunks (rays,
    generator, ``render_chunk``) the span ``nerf.view.chunk``. The chunks of
    batch ``b + 1`` are queued before batch ``b`` is waited for, so the
    caller's work on a batch's frames overlaps the device's work on the
    next. On a CUDA device a batch comes back in one ``non_blocking`` copy
    into a pinned buffer of its own (a yielded frame stays valid), waited for
    with an event; with ``device_frames`` nothing is copied and the frames
    are yielded as uint8 tensors on ``device``. Frames are numpy arrays
    otherwise. A short last batch renders only its own frames.
    """
    if frames_per_dispatch < 1:
        raise ValueError(f"frames_per_dispatch must be positive, got {frames_per_dispatch}")
    poses = torch.as_tensor(poses if torch.is_tensor(poses) else np.asarray(poses),
                            dtype=torch.float32, device=device)
    n, n_pix = poses.shape[0], height * width
    if frame_seeds is None:
        frame_seeds = [mix_seed(0, i) for i in range(n)]
    on_cuda = poses.device.type == "cuda"

    def render_frame(f: int) -> torch.Tensor:
        out = []
        with profiling.span("nerf.view.frame", f):
            for i, lo in enumerate(range(0, n_pix, chunk)):
                with profiling.span("nerf.view.chunk"):
                    flat = torch.arange(lo, min(lo + chunk, n_pix), device=poses.device)
                    o, d = cameras.rays_for_pixels(
                        (flat % width).float(), (flat // width).float(),
                        height, width, focal, poses[f])
                    g = chunk_generator(frame_seeds[f], i, poses.device)
                    out.append(render_chunk(o.contiguous(), d.contiguous(), g))
            return _to_uint8(torch.cat(out)).reshape(height, width, 3)

    def dispatch(lo: int):
        """Queue the frames ``lo ..`` of one batch and, on a card, their copy
        to the host; returns the frames and the copy's event (or None)."""
        frames = torch.stack([render_frame(f)
                              for f in range(lo, min(lo + frames_per_dispatch, n))])
        if device_frames or not on_cuda:
            return frames, None
        host = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)
        host.copy_(frames, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    with torch.no_grad():
        pending = dispatch(0) if n else None
        for lo in range(0, n, frames_per_dispatch):
            ahead = lo + frames_per_dispatch
            queued = dispatch(ahead) if ahead < n else None
            frames, done = pending
            if done is not None:
                done.synchronize()
            for frame in frames:
                yield frame if device_frames else frame.numpy()
            pending = queued


def make_param_render_chunk(config: NeRFConfig, compute_dtype=None, mlp_apply=None,
                            render_fn=None, coarse_sampler=None) -> Callable:
    """A render chunk taking the parameters as an argument,
    ``render_chunk_p(params, o, d, generator) -> fine rgb``: the
    hierarchical render (``render_fn``, default the plain
    ``models.nerf.render_rays``) with its fine color out. For parameters
    that change between views (the trainer's validation, which updates them
    in place; the fused render's packing cache follows the update).
    ``uniforms`` replaces the generator's draws
    (``models.nerf.draw_render_uniforms``)."""
    render = render_fn or render_rays

    def render_chunk_p(params, o, d, generator, uniforms=None):
        out = render(params, config, o, d, generator, compute_dtype=compute_dtype,
                     mlp_apply=mlp_apply, coarse_sampler=coarse_sampler, uniforms=uniforms)
        return out["fine_rgb_rays"]

    return render_chunk_p


def make_occ_param_render_chunk(config: NeRFConfig, occ_cfg, compute_dtype=None,
                                mlp_apply=None, render_fn=None) -> Callable:
    """``render_chunk_p((params, occ_words), o, d, generator)``: the render
    chunk of ``make_param_render_chunk`` with the coarse samples following
    the packed occupancy grid ``occ_words`` (``ops.occupancy.pack_occupancy``)
    passed beside the parameters, for a grid that changes between views."""
    from minimal_nerf_torch.ops import occupancy as occ

    render = render_fn or render_rays

    def render_chunk_p(state, o, d, generator):
        params, occ_words = state
        out = render(params, config, o, d, generator, compute_dtype=compute_dtype,
                     mlp_apply=mlp_apply,
                     coarse_sampler=occ.make_occupancy_sampler(occ_words, occ_cfg))
        return out["fine_rgb_rays"]

    return render_chunk_p


def view_reconstruction_with_params(render_chunk_p: Callable, params, all_o_rays: torch.Tensor,
                                    all_d_rays: torch.Tensor, chunk: int = 4096,
                                    seed: int = 0) -> np.ndarray:
    """``view_reconstruction`` of ``render_chunk_p`` with ``params`` (the
    render chunk's state) passed to every chunk."""
    return view_reconstruction(lambda o, d, g: render_chunk_p(params, o, d, g), all_o_rays,
                               all_d_rays, chunk=chunk, seed=seed)


def make_fine_render_chunk(params, config: NeRFConfig, compute_dtype=None,
                           mlp_apply=None, render_fn=None,
                           coarse_sampler=None) -> Callable:
    """The standard ``render_chunk``: ``make_param_render_chunk`` with
    ``params`` bound. ``render_fn`` overrides the render (e.g.
    ``make_fused_render_fn()``); the default is the plain
    ``models.nerf.render_rays``.
    """
    render_chunk_p = make_param_render_chunk(config, compute_dtype, mlp_apply, render_fn,
                                             coarse_sampler)
    return lambda o, d, generator, uniforms=None: render_chunk_p(params, o, d, generator,
                                                                 uniforms)


def make_sharded_render_chunk(shard_chunks: Sequence[Callable], devices: Sequence,
                              draw: Callable) -> Callable:
    """A ``render_chunk`` whose rays are split over several devices of this
    process (JAX ``make_sharded_render_chunk`` over a local mesh).

    ``shard_chunks[k]`` is a ``render_chunk`` on ``devices[k]`` that takes
    ``uniforms=`` (``make_fine_render_chunk``) with its own copy of the
    parameters (and its own kernel launches);
    ``draw(n, generator)`` draws a chunk's uniforms
    (``models.nerf.draw_render_uniforms``). Each call draws the WHOLE
    chunk's uniforms once from the caller's generator, gives shard ``k`` its
    contiguous block of the rays and the uniforms (``torch.tensor_split``:
    any chunk size), queues every shard before it gathers their colors on
    the caller's device: N shards render what one does, bit for bit. (JAX
    folds the shard index into each shard's key instead.)
    """
    n_shards = len(devices)

    def render_chunk(o, d, generator):
        from minimal_nerf_torch.models.nerf import map_uniforms

        uniforms = draw(o.shape[0], generator)
        outs = []
        for k, (fn, dev) in enumerate(zip(shard_chunks, devices)):
            rows = lambda t: torch.tensor_split(t, n_shards)[k].to(dev)  # noqa: E731
            outs.append(fn(rows(o), rows(d), None, uniforms=map_uniforms(rows, uniforms)))
        return torch.cat([c.to(o.device) for c in outs])

    return render_chunk


def orbit_views(render_chunk: Callable, height: int = 800, width: int = 800,
                radius: float = 4.0, cam_angle_x: float = DEFAULT_CAM_ANGLE_X,
                chunk: int = 4096, num_poses: int = 40, seed: int = 0,
                frames_per_dispatch: int = 8, device="cuda") -> Iterator[np.ndarray]:
    """The reference's 360-degree orbit (phi -30, ``radius``), swept
    ``frames_per_dispatch`` poses at a time (``render_poses_batched``)."""
    poses = cameras.spherical_poses(num_poses=num_poses, radius=radius)
    focal = cameras.focal_from_angle(width, cam_angle_x)
    seeds = [mix_seed(seed, i) for i in range(len(poses))]
    return render_poses_batched(render_chunk, poses, height, width, focal, chunk=chunk,
                                frame_seeds=seeds, frames_per_dispatch=frames_per_dispatch,
                                device=device)


def generate_360_view_synthesis(render_chunk: Callable, save_dir, epoch,
                                height: int = 800, width: int = 800,
                                radius: float = 4.0,
                                cam_angle_x: float = DEFAULT_CAM_ANGLE_X,
                                chunk: int = 4096, num_poses: int = 40,
                                seed: int = 0, frames_per_dispatch: int = 8,
                                device="cuda") -> Path:
    """Render the orbit and write ``{save_dir}/{epoch}-360.gif``."""
    from minimal_nerf_torch.utils import imageio as mio

    save_dir = Path(save_dir)
    if not save_dir.is_dir():
        raise FileNotFoundError(f"missing save dir {save_dir}")
    views = list(orbit_views(render_chunk, height, width, radius, cam_angle_x, chunk,
                             num_poses, seed, frames_per_dispatch, device))
    out_path = save_dir / f"{epoch}-360.gif"
    mio.mimwrite(out_path, views)
    return out_path


def photo_nerf_to_image(image_apply: Callable, im_h: int, im_w: int, chunk: int = 4096,
                        device="cuda") -> np.ndarray:
    """Query a 2-D image model at every pixel (JAX ``photo_nerf_to_image``,
    reference ``nerf_helpers.py:212-238``): ``image_apply`` maps ``[C, 2]``
    normalized coordinates ``(y / (H-1), x / (W-1))`` to ``[C, 3]`` rgb; the
    coordinates are made on ``device`` and swept in ``chunk``-pixel chunks
    without gradients. Returns ``[im_h, im_w, 3]`` float32 numpy."""
    from minimal_nerf_torch import resolve_device

    dev = resolve_device(device)
    ys, xs = torch.meshgrid(torch.arange(im_h, dtype=torch.float32, device=dev),
                            torch.arange(im_w, dtype=torch.float32, device=dev), indexing="ij")
    # tensor divisors: a CUDA tensor divided by a Python number is multiplied
    # by its reciprocal, which may round differently from JAX's division
    div = lambda v, n: v.reshape(-1) / torch.tensor(n, dtype=torch.float32, device=dev)  # noqa: E731
    coords = torch.stack([div(ys, im_h - 1), div(xs, im_w - 1)], dim=-1)
    with torch.no_grad():
        rgb = torch.cat([image_apply(coords[lo:lo + chunk])
                         for lo in range(0, coords.shape[0], chunk)])
    return rgb.float().reshape(im_h, im_w, 3).cpu().numpy()
