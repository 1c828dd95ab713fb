"""Checkpoint -> ``render_chunk`` setup shared by the inference CLIs.

Counterpart of ``minimal_nerf_tpu/inference.py``: load a checkpoint, apply
the inference-time sample-count overrides, resolve the kernel (by default the
one the checkpoint trained under, ``views.resolve_inference_kernel``) and
build the render chunk on ``device``.
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
    """
    from minimal_nerf_torch import views
    from minimal_nerf_torch.training.trainer import load_state_for_inference

    if data_parallel > 1:
        raise NotImplementedError(
            "data-parallel rendering is not ported yet (ROADMAP Queue 1 item 7, data parallel)")
    if bake_occupancy or ignore_occupancy:
        raise NotImplementedError(
            "occupancy options are not ported yet (ROADMAP Queue 1 item 4, occupancy)")
    if rays < 1:
        raise ValueError(f"rays must be positive, got {rays}")

    params, nerf_cfg, train_cfg, _, _ = load_state_for_inference(ckpt, device=device)
    if coarse or fine:
        # the MLP weights do not depend on the per-ray sample counts
        nerf_cfg = dataclasses.replace(
            nerf_cfg,
            coarse_samples=coarse or nerf_cfg.coarse_samples,
            fine_samples=fine or nerf_cfg.fine_samples,
        )
    kernel = views.resolve_inference_kernel(kernel, train_cfg, device)
    render_fn = None
    if kernel == "fused":
        from minimal_nerf_torch.kernels.fused_raymarch import make_fused_render_fn

        render_fn = make_fused_render_fn()
    render_chunk = views.make_fine_render_chunk(
        params, nerf_cfg, compute_dtype=train_cfg.compute_dtype, render_fn=render_fn)
    return render_chunk, nerf_cfg, train_cfg
