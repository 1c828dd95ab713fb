"""Checkpoint -> ``render_chunk`` setup shared by the inference CLIs.

Counterpart of ``minimal_nerf_tpu/inference.py``: load a checkpoint, apply
the inference-time sample-count overrides, attach the occupancy sampler (the
checkpoint's grid, or one baked from the trained densities), resolve the
kernel (by default the one the checkpoint trained under,
``views.resolve_inference_kernel``) and build the render chunk: one copy of
it per device, each chunk split over them (``--data-parallel``,
``views.make_sharded_render_chunk``; one device by default).
"""

from __future__ import annotations

import dataclasses


def build_render_chunk(ckpt: str, rays: int, kernel: str = "auto",
                       data_parallel: int = 1, ignore_occupancy: bool = False,
                       coarse: int = 0, fine: int = 0, bake_occupancy: bool = False,
                       device="cuda"):
    """Load ``ckpt`` and build ``render_chunk(o, d, generator) -> rgb``.

    Returns ``(render_chunk, nerf_cfg, train_cfg)``; the configs reflect the
    ``coarse``/``fine`` overrides. ``rays`` is the caller's chunk size (the
    render chunk itself takes any ray count).

    An occupancy-trained checkpoint renders with its grid, packed with every
    cell forced occupied if it was saved inside the warmup, unless
    ``ignore_occupancy`` (uniform coarse samples). ``bake_occupancy`` bakes a
    grid for a checkpoint that has none (``ops.occupancy.bake_grid``, 4
    jittered passes drawn from a generator seeded with 0 on ``device``; the
    JAX package draws them from ``PRNGKey(0)``, so the two bakes differ).

    Every chunk is split over ``data_parallel = N`` devices from ``device``
    on (``parallel.local_devices``: N cards, more than are visible raising,
    or the CPU N times; 0 is taken as 1, as JAX renders unsharded at N <= 1),
    each with its own copy of the parameters, grid and kernel hooks; the
    whole chunk's uniforms are drawn once and sliced, so any N renders the
    frames of one device's chunk bit for bit.

    On one device the render chunk is a ``views.StaticRenderChunk``: its
    state is never updated, so on a card ``views.render_poses_batched``
    sweeps its full chunks as replays of one captured CUDA graph.

    A ``mode="single"`` checkpoint raises ``ValueError``: its one coarse
    MLP has no fine network to render views with (JAX's render path needs
    ``params["coarse"]``, and its ``--bake-occupancy`` refuses one).

    A checkpoint of one field (``models.ngp``, its header's ``field``)
    renders both passes through that field: its hash encoding through the
    CUDA kernels under ``fused`` or ``pallas`` (the plain indexing under
    ``xla``), and its density bakes a grid.
    """
    import torch

    from minimal_nerf_torch import views
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.ngp import checkpoint_field
    from minimal_nerf_torch.ops import occupancy as occ
    from minimal_nerf_torch.training.checkpoint import read_header
    from minimal_nerf_torch.training.trainer import checkpoint_mode, load_state_for_inference

    header = read_header(ckpt)
    mode = checkpoint_mode(header)
    if mode != "full":
        raise ValueError(f"{ckpt} is a mode={mode!r} checkpoint (one coarse MLP): render and "
                         "score need a 'full' coarse + fine checkpoint")
    if data_parallel < 0:
        raise ValueError(f"--data-parallel {data_parallel}: a mesh of a negative size")
    if rays < 1:
        raise ValueError(f"rays must be positive, got {rays}")

    params, nerf_cfg, train_cfg, grid, ckpt_step = load_state_for_inference(ckpt, device=device)
    if coarse or fine:
        # the MLP weights do not depend on the per-ray sample counts
        nerf_cfg = dataclasses.replace(
            nerf_cfg,
            coarse_samples=coarse or nerf_cfg.coarse_samples,
            fine_samples=fine or nerf_cfg.fine_samples,
        )
    kernel = views.resolve_inference_kernel(kernel, train_cfg, device)
    field = checkpoint_field(header, kernels=kernel != "xla")
    words = None
    occ_cfg = train_cfg.occupancy_config
    if grid is None and bake_occupancy and not ignore_occupancy:
        occ_cfg = occ_cfg or occ.OccupancyConfig()
        density_fn = None if field is None else (
            lambda pts: field.density(params, pts, train_cfg.compute_dtype))
        grid = occ.bake_grid(params, nerf_cfg.position_dim, nerf_cfg.direction_dim, occ_cfg,
                             torch.Generator(device=device).manual_seed(0),
                             compute_dtype=train_cfg.compute_dtype, density_fn=density_fn)
        ckpt_step = occ_cfg.warmup_steps  # a baked grid is never warmup-forced
    if grid is not None and not ignore_occupancy:
        words = occ.pack_occupancy(grid, occ_cfg, force_all=ckpt_step < occ_cfg.warmup_steps)

    def chunk_on(dev):
        """The render chunk with its own parameters, grid and hooks on ``dev``."""
        render_fn = mlp_apply = None
        if field is not None:
            mlp_apply, render_fn = field.hooks()
        elif kernel == "fused":
            from minimal_nerf_torch.kernels.fused_raymarch import make_fused_render_fn

            render_fn = make_fused_render_fn()
        elif kernel == "pallas":
            from minimal_nerf_torch.kernels.raymarch import make_mlp_kernel_apply

            mlp_apply = make_mlp_kernel_apply()
        sampler = (None if words is None else
                   occ.make_occupancy_sampler(words.to(dev), occ_cfg))
        return views.make_fine_render_chunk(
            map_params(lambda t: t.to(dev), params), nerf_cfg,
            compute_dtype=train_cfg.compute_dtype, mlp_apply=mlp_apply, render_fn=render_fn,
            coarse_sampler=sampler)

    from minimal_nerf_torch.models.nerf import draw_render_uniforms
    from minimal_nerf_torch.parallel import local_devices

    devices = local_devices(max(1, data_parallel), device)
    shards = [chunk_on(dev) for dev in devices]
    draw_occ = occ_cfg if words is not None else None
    render_chunk = views.make_sharded_render_chunk(
        shards, devices, lambda n, generator: draw_render_uniforms(
            nerf_cfg, n, generator, generator.device, draw_occ))
    if len(devices) == 1:
        # nothing updates the loaded state: the sweep may replay a graph of it
        render_chunk = views.StaticRenderChunk(render_chunk)
    return render_chunk, nerf_cfg, train_cfg
