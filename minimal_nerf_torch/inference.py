"""Checkpoint -> ``render_chunk`` setup shared by the inference CLIs.

Counterpart of ``minimal_nerf_tpu/inference.py``: load a checkpoint, apply
the inference-time sample-count overrides, attach the occupancy sampler (the
checkpoint's grid, or one baked from the trained densities), resolve the
kernel (by default the one the checkpoint trained under,
``views.resolve_inference_kernel``) and build the render chunk on ``device``.
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

    A ``mode="single"`` checkpoint raises ``ValueError``: its one coarse
    MLP has no fine network to render views with (JAX's render path needs
    ``params["coarse"]``, and its ``--bake-occupancy`` refuses one).
    """
    import torch

    from minimal_nerf_torch import views
    from minimal_nerf_torch.ops import occupancy as occ
    from minimal_nerf_torch.training.checkpoint import read_header
    from minimal_nerf_torch.training.trainer import checkpoint_mode, load_state_for_inference

    mode = checkpoint_mode(read_header(ckpt))
    if mode != "full":
        raise ValueError(f"{ckpt} is a mode={mode!r} checkpoint (one coarse MLP): render and "
                         "score need a 'full' coarse + fine checkpoint")
    if data_parallel > 1:
        raise NotImplementedError(
            "data-parallel rendering is not ported yet (ROADMAP Queue 1 item 7, data parallel)")
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
    coarse_sampler = None
    occ_cfg = train_cfg.occupancy_config
    if grid is None and bake_occupancy and not ignore_occupancy:
        occ_cfg = occ_cfg or occ.OccupancyConfig()
        grid = occ.bake_grid(params, nerf_cfg.position_dim, nerf_cfg.direction_dim, occ_cfg,
                             torch.Generator(device=device).manual_seed(0),
                             compute_dtype=train_cfg.compute_dtype)
        ckpt_step = occ_cfg.warmup_steps  # a baked grid is never warmup-forced
    if grid is not None and not ignore_occupancy:
        words = occ.pack_occupancy(grid, occ_cfg, force_all=ckpt_step < occ_cfg.warmup_steps)
        coarse_sampler = occ.make_occupancy_sampler(words, occ_cfg)

    kernel = views.resolve_inference_kernel(kernel, train_cfg, device)
    render_fn = mlp_apply = None
    if kernel == "fused":
        from minimal_nerf_torch.kernels.fused_raymarch import make_fused_render_fn

        render_fn = make_fused_render_fn()
    elif kernel == "pallas":
        from minimal_nerf_torch.kernels.raymarch import make_mlp_kernel_apply

        mlp_apply = make_mlp_kernel_apply()
    render_chunk = views.make_fine_render_chunk(
        params, nerf_cfg, compute_dtype=train_cfg.compute_dtype, mlp_apply=mlp_apply,
        render_fn=render_fn, coarse_sampler=coarse_sampler)
    return render_chunk, nerf_cfg, train_cfg
