"""View reconstruction and 360-degree view synthesis.

Counterpart of ``minimal_nerf_tpu/views.py``. A view is swept in ray chunks;
chunk ``i`` of a frame draws its samples from a ``torch.Generator`` seeded
from ``(frame seed, i)``, so a frame renders the same however it is swept.
A ``render_chunk`` is ``(o [C, 3], d [C, 3], generator) -> rgb [C, 3]``,
built on a field's or a kernel's hooks (``minimal_nerf_torch.fields``).

Many poses (the render CLI's orbit, the score CLI's test split) go through
``render_poses_batched``: ``frames_per_dispatch`` frames per batch, the next
batch queued on the device before this one is waited for, each batch
fetched in one asynchronous copy (or kept on the device for scoring). A
``StaticRenderChunk`` (the serving set-up's, whose state never changes) has
its full chunks swept on a CUDA device as replays of one captured CUDA graph
of the whole per-chunk chain (``_ChunkGraph``), the same frames bit for bit;
other sweeps (the CPU, several devices, the trainer's) loop in Python.

``photo_nerf_to_image`` sweeps a 2-D image model over every pixel of a
photo (``train simple``). ``make_sharded_render_chunk`` splits each chunk
over several devices of this process (render and score ``--data-parallel``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from minimal_nerf_torch import fields
from minimal_nerf_torch.models.nerf import NeRFConfig
from minimal_nerf_torch.ops import cameras
from minimal_nerf_torch.utils import profiling

# Blender-synthetic default horizontal FoV (reference nerf_helpers.py:163)
DEFAULT_CAM_ANGLE_X = 0.6911112070083618
# the devices on which a StaticRenderChunk's full chunks are graph replays
_GRAPH_DEVICES = ("cuda",)


def mix_seed(*ints: int) -> int:
    """A 63-bit seed mixed from integers (``numpy.random.SeedSequence``)."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def chunk_generator(frame_seed: int, chunk_index: int, device) -> torch.Generator:
    """The generator of chunk ``chunk_index`` of the frame with ``frame_seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(frame_seed, chunk_index))
    return g


def _to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    # clip then truncate (reference nerf_helpers.py:208-210)
    return torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)


def _chunk_rays(flat: torch.Tensor, height: int, width: int, focal,
               pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contiguous ``o, d [N, 3]`` of the row-major pixel indices ``flat [N]``
    of a ``height x width`` view from ``pose``."""
    o, d = cameras.rays_for_pixels((flat % width).float(), (flat // width).float(),
                                   height, width, focal, pose)
    return o.contiguous(), d.contiguous()


class StaticRenderChunk:
    """A ``render_chunk`` whose state (parameters, grid, packed weights) is
    never updated after it is built: the serving set-up's, on one device
    (``inference.build_render_chunk``). On a CUDA device
    ``render_poses_batched`` sweeps its full chunks as replays of one
    captured CUDA graph, which it keeps here (``graph``) for the next sweep;
    a chunk of another size, view or device captures again. Called, it is
    the render chunk it wraps."""

    def __init__(self, render_chunk: Callable):
        self.render_chunk = render_chunk
        self.graph: Optional[_ChunkGraph] = None

    def __call__(self, o, d, generator):
        return self.render_chunk(o, d, generator)


class _ChunkGraph:
    """A view sweep's chain for one full chunk of ``n`` rays, captured as
    one CUDA graph and replayed for every full chunk of every frame.

    The graph holds everything from the chunk's pixel offset to its colors:
    the pixel indices (a static ``arange(n)`` plus ``offset``, the eager
    loop's ``arange(lo, lo + n)``), the rays from the static ``pose``, the
    chunk's draws from ``generator`` (registered with the graph, so that each
    replay draws from the seed it was given), the render, the colors written
    into their rows of the static ``frame``, and ``offset`` advanced by
    ``n``. A replay refills the offset in place where the last one did not
    leave it at the chunk's pixel (a frame's first replay), and seeds the
    generator with the chunk's ``mix_seed(frame seed, i)``: chunk ``i``
    draws and renders what the eager loop's does, bit for bit. The chunk's
    kernel hooks read the weights they packed before the capture (the state
    never changes).

    The capture (span ``nerf.view.capture``) launches nothing: the launch
    counters it raised are taken back, and each replay adds them, with one
    ``view.graph_replays``.
    """

    def __init__(self, render_chunk: Callable, key: tuple, pose: torch.Tensor,
                 colors: torch.Tensor):
        """``key``: ``(n, height, width, focal, pose shape, device)``;
        ``pose`` the first frame's; ``colors`` a chunk's, whose dtype and
        width the frame takes."""
        n, height, width, focal, _, dev = self.key = key
        self.index = torch.arange(n, device=dev)
        self.offset = torch.zeros((), dtype=torch.int64, device=dev)
        self.next_lo = 0  # ``offset`` once every queued replay has run
        self.pose = pose.clone()
        self.frame = torch.empty((height * width,) + colors.shape[1:], dtype=colors.dtype,
                                 device=dev)
        self.generator = torch.Generator(device=dev)

        def body():
            flat = self.index + self.offset
            o, d = _chunk_rays(flat, height, width, focal, self.pose)
            self.frame.index_copy_(0, flat, render_chunk(o, d, self.generator))
            self.offset.add_(n)

        self.counts = profiling.CaptureCounts("view.graph_replays")
        with profiling.span("nerf.view.capture"), self.counts.capture(keep=False):
            self.graph = self._capture(body)

    def _capture(self, body: Callable) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            body()
        return graph

    def replay(self, lo: int, seed: int) -> None:
        """Render the full chunk at pixel ``lo``, drawn from ``seed``, into
        its rows of ``frame``."""
        if lo != self.next_lo:
            self.offset.fill_(lo)
        self.generator.manual_seed(seed)
        self.graph.replay()
        self.next_lo = lo + self.index.shape[0]
        self.counts.replayed()


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
    generator, ``render_chunk``) the span ``nerf.view.chunk``. For a
    ``StaticRenderChunk`` on a CUDA device every full chunk but the first the
    render chunk ever met is a replay of its ``_ChunkGraph`` (the span holds
    the replay's refills and ``graph.replay()``), captured after that first
    chunk ran eagerly; a short last chunk runs eagerly. The chunks of
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
    graphed = (isinstance(render_chunk, StaticRenderChunk)
               and poses.device.type in _GRAPH_DEVICES)
    key = (chunk, height, width, focal, tuple(poses.shape[1:]), poses.device)

    def render_frame(f: int) -> torch.Tensor:
        eager = []  # (pixel, colors) of the chunks rendered eagerly
        with profiling.span("nerf.view.frame", f):
            graph = None
            if graphed and render_chunk.graph is not None and render_chunk.graph.key == key:
                graph = render_chunk.graph
                graph.pose.copy_(poses[f])
            for i, lo in enumerate(range(0, n_pix, chunk)):
                full = lo + chunk <= n_pix
                with profiling.span("nerf.view.chunk"):
                    if graph is not None and full:
                        graph.replay(lo, mix_seed(frame_seeds[f], i))
                        continue
                    flat = torch.arange(lo, min(lo + chunk, n_pix), device=poses.device)
                    g = chunk_generator(frame_seeds[f], i, poses.device)
                    eager.append((lo, render_chunk(
                        *_chunk_rays(flat, height, width, focal, poses[f]), g)))
                if graphed and graph is None and full:
                    render_chunk.graph = None  # release the old graph's pool first
                    graph = render_chunk.graph = _ChunkGraph(render_chunk, key, poses[f],
                                                             eager[-1][1])
            if graph is None:
                rgb = torch.cat([colors for _, colors in eager])
            else:
                rgb = graph.frame
                for lo, colors in eager:
                    rgb[lo:lo + colors.shape[0]] = colors
            return _to_uint8(rgb).reshape(height, width, 3)

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
    mlp_apply, render = fields.hooks_or("xla", mlp_apply, render_fn)

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

    mlp_apply, render = fields.hooks_or("xla", mlp_apply, render_fn)

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
    ``params`` bound (its hooks, ``fields.kernel_hooks``; default the plain
    render).
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
