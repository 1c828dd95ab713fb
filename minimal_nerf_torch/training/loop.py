"""The train and eval steps: batch sampling, hierarchical render, loss,
Adam, LR.

Counterpart of ``minimal_nerf_tpu/training/loop.py`` (single device; the
multi-step scan and data parallelism are not ported yet). PyTorch runs
eagerly, so there is no ``jit``: ``make_train_step`` returns a plain function
that samples a batch, renders it through the fused kernels (or the hooks of
another ``--kernel``, ``kernel_hooks``), takes the gradients with autograd
and applies Adam with optax's semantics IN PLACE on the parameter tensors.
With an ``OccupancyConfig`` the step first updates the density-EMA grid (in
place) and packs it (``occupancy_step_context``), and the loss samples its
coarse points through the grid (``coarse_sampler`` of ``nerf_loss``, the
counterpart of JAX's ``make_occupancy_loss``).

Adam is written as plain functions over ``{"count", "mu", "nu"}`` with ``mu``
and ``nu`` in the parameter tree's layout, the state optax keeps, so the
moments map onto the checkpoint's leaves without reshaping.

Random draws: each step derives its generators from ``(seed, step)``; the
per-epoch frame permutation from ``(seed, epoch)`` alone, so every step of an
epoch sees the same permutation and visits each frame exactly once. The
validation of val frame ``idx`` at ``step`` draws from ``(seed, step + idx)``
on a stream of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from minimal_nerf_torch.data.synthetic import ray_batch_from_arrays
from minimal_nerf_torch.models.mlp import map_params
from minimal_nerf_torch.models.nerf import NeRFConfig
from minimal_nerf_torch.ops import occupancy as occ
from minimal_nerf_torch.training.checkpoint import flatten_tree, unflatten_tree
from minimal_nerf_torch.training.config import TrainConfig

Params = Dict[str, Any]

# stream tags separating the generators derived from one seed; the grid
# update's jitter has its own, so enabling occupancy perturbs no other draw
_PERM_STREAM, _BATCH_STREAM, _RENDER_STREAM, _OCC_STREAM = 0x5EED, 1, 2, 0x0CC
_VAL_STREAM = 0x7A1


@dataclasses.dataclass
class SceneStatic:
    """Static facts about a scene split."""

    height: int
    width: int
    focal: float
    num_frames: int


def scene_static(scene) -> SceneStatic:
    return SceneStatic(height=scene.height, width=scene.width, focal=scene.focal,
                       num_frames=scene.num_frames)


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable:
    """``lr(step) = max(start_lr * gamma^epoch, lr_floor)`` with
    ``gamma = (end/start)^(1/decay_epochs)``: the reference's ExponentialLR
    stepped once per epoch (staircase). Returns an fp32 scalar tensor."""
    gamma = (cfg.end_lr / cfg.start_lr) ** (1.0 / cfg.lr_decay_epochs)

    def schedule(step) -> torch.Tensor:
        epoch = int(step) // steps_per_epoch
        lr = (torch.tensor(cfg.start_lr, dtype=torch.float32)
              * torch.tensor(gamma, dtype=torch.float32) ** epoch)
        return torch.clamp(lr, min=cfg.lr_floor)

    return schedule


def adam_init(params: Params) -> Dict[str, Any]:
    """Zero moments in the parameter tree's layout and a zero count."""
    zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
    return {"count": 0, "mu": map_params(zeros, params), "nu": map_params(zeros, params)}


@torch.no_grad()
def adam_update(params: Params, grads: Params, state: Dict[str, Any], lr: torch.Tensor,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Dict[str, Any]:
    """One ``optax.adam`` step: moments updated, bias-corrected at the
    incremented count, ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)``. The LR is
    the schedule's value at the count before the increment (the caller's
    ``lr``). ``params`` and the moments are updated in place; returns the
    new state."""
    count = state["count"] + 1
    # fp32 scalars as optax computes them; as Python floats they are exact
    # and need no host-to-device copy
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    bc1, bc2 = float(1 - f32(b1) ** count), float(1 - f32(b2) ** count)
    step_size = -float(lr)
    for p, g, m, v in zip(flatten_tree(params), flatten_tree(grads),
                          flatten_tree(state["mu"]), flatten_tree(state["nu"])):
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * (g * g) + b2 * v)
        p.add_(step_size * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
    return dict(state, count=count)


def global_norm(grads: Params) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in flatten_tree(grads)))


_DENSITY_STAT_KEYS = ("coarse_density_sumsq", "coarse_density_non_zeros",
                      "fine_density_sumsq", "fine_density_non_zeros")


def finalize_metrics(metrics: Dict[str, torch.Tensor], grads: Params) -> Dict[str, torch.Tensor]:
    """The reference's logged names (``minimal_nerf_tpu/training/loop.py:86-106``
    on one device): the density sums of squares become
    ``{coarse,fine}_density_norms`` (their square roots), the non-zero counts
    stay, and ``grad_2.0_norm_total`` is the gradients' global norm. The
    fused render has no density statistics, as in JAX."""
    m = dict(metrics)
    for name in ("coarse", "fine"):
        k = f"{name}_density_sumsq"
        if k in m:
            m[f"{name}_density_norms"] = torch.sqrt(m.pop(k))
    m["grad_2.0_norm_total"] = global_norm(grads)
    return m


def nerf_loss(params: Params, nerf_cfg: NeRFConfig, o_rays, d_rays, rgb,
              generator: Optional[torch.Generator] = None, compute_dtype=None,
              render_fn=None, uniforms=None, mlp_apply=None,
              coarse_sampler=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``MSE(coarse, gt) + MSE(fine, gt)`` (reference ``nerf_model.py:158-161``).

    ``render_fn`` is the hierarchical render (signature of
    ``models.nerf.render_rays``); ``mlp_apply`` is its MLP hook. With
    neither, the fused kernels' ``render_rays_fused``; with ``mlp_apply``
    alone, ``models.nerf.render_rays``. ``coarse_sampler`` overrides the
    coarse sample placement (the occupancy sampler,
    ``ops.occupancy.make_occupancy_sampler``). ``uniforms`` replaces the
    draws. The render's density statistics, where it has them, join the
    metrics.
    """
    from minimal_nerf_torch.kernels.fused_raymarch import render_rays_fused
    from minimal_nerf_torch.models.nerf import render_rays

    render = render_fn or (render_rays if mlp_apply is not None else render_rays_fused)
    out = render(params, nerf_cfg, o_rays, d_rays, generator, compute_dtype=compute_dtype,
                 mlp_apply=mlp_apply, return_stats=True, uniforms=uniforms,
                 coarse_sampler=coarse_sampler)
    coarse_loss = torch.mean((out["coarse_rgb_rays"] - rgb) ** 2)
    fine_loss = torch.mean((out["fine_rgb_rays"] - rgb) ** 2)
    loss = coarse_loss + fine_loss
    metrics = {"train_loss": loss, "train_coarse_loss": coarse_loss,
               "train_fine_loss": fine_loss}
    metrics.update({k: out[k] for k in _DENSITY_STAT_KEYS if k in out})
    return loss, metrics


def step_generator(seed: int, step: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step, stream)``."""
    mixed = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9
             + stream * 0x94D049BB133111EB) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def epoch_permutation(seed: int, epoch: int, num_frames: int) -> torch.Tensor:
    """The frame order of one epoch (CPU int64), the same for all its steps."""
    return torch.randperm(num_frames, generator=step_generator(seed, epoch, _PERM_STREAM, "cpu"))


def sample_train_batch(step: int, images: torch.Tensor, poses: torch.Tensor,
                       static: SceneStatic, num_rays: int, steps_per_epoch: int,
                       cropping_epochs: int, seed: int,
                       generator: Optional[torch.Generator] = None,
                       coords=None) -> Dict[str, Any]:
    """Pick this step's frame from the epoch's permutation, sample pixels
    (center crop while ``epoch < cropping_epochs``) and build their rays.

    ``coords = (xs, ys)`` replaces the pixel draws. Returns ``origin``,
    ``direc``, ``rgb`` ``[N, 3]``, ``xs``, ``ys`` and the ``frame`` index.
    """
    epoch = step // steps_per_epoch
    perm = epoch_permutation(seed, epoch, static.num_frames)
    frame = int(perm[step % steps_per_epoch % static.num_frames])
    batch = ray_batch_from_arrays(frame, num_rays, static.height, static.width, static.focal,
                                  images, poses, cropping=epoch < cropping_epochs,
                                  generator=generator, coords=coords)
    return dict(batch, frame=frame)


def loss_and_grads(params: Params, nerf_cfg: NeRFConfig, batch: Dict[str, Any],
                   compute_dtype=None, render_fn=None, generator=None, uniforms=None,
                   mlp_apply=None, coarse_sampler=None):
    """``(metrics, grads)`` of ``nerf_loss`` on one batch; the parameters'
    leaves are made to require gradients, and no ``.grad`` is written."""
    leaves = flatten_tree(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = nerf_loss(params, nerf_cfg, batch["origin"], batch["direc"], batch["rgb"],
                              generator, compute_dtype, render_fn, uniforms, mlp_apply,
                              coarse_sampler)
    grads = torch.autograd.grad(loss, leaves)
    return ({k: v.detach() for k, v in metrics.items()},
            unflatten_tree(params, list(grads)))


def resolve_kernel(kernel: str, device="cuda") -> str:
    """``"auto"`` is ``"fused"`` on a CUDA device and ``"xla"`` (the plain
    path) elsewhere; any other choice is kept."""
    if kernel == "auto":
        return "fused" if torch.device(device).type == "cuda" else "xla"
    return kernel


def kernel_hooks(kernel: str, device="cuda") -> Tuple[Optional[Callable], Callable]:
    """``(mlp_apply, render_fn)`` of a ``--kernel`` choice for the train step
    (``train_nerf.py:261-282``: ``resolve_kernel``, ``make_mlp_apply``,
    ``make_render_fn``).

    ``"fused"``, and ``"auto"`` on a CUDA device, give the fused kernels'
    render; ``"pallas"`` the point kernels' MLP hook under the plain render;
    ``"xla"``, and ``"auto"`` elsewhere, the plain render with the plain MLP
    (PyTorch matmuls, which the JAX package leaves to XLA).
    """
    from minimal_nerf_torch.kernels.fused_raymarch import make_fused_render_fn
    from minimal_nerf_torch.kernels.raymarch import make_mlp_kernel_apply
    from minimal_nerf_torch.models.nerf import render_rays

    kernel = resolve_kernel(kernel, device)
    if kernel == "fused":
        return None, make_fused_render_fn()
    if kernel == "pallas":
        return make_mlp_kernel_apply(), render_rays
    if kernel == "xla":
        return None, render_rays
    raise ValueError(f"unknown kernel {kernel!r}")


def occupancy_step_context(occupancy_cfg, nerf_cfg: NeRFConfig, compute_dtype, params: Params,
                           grid: torch.Tensor, step: int, seed: int,
                           jitter: Optional[torch.Tensor] = None):
    """The occupancy work of one step before its render (JAX
    ``_occ_step_context``).

    At ``step % update_every == 0`` the density EMA is updated IN PLACE in
    ``grid`` from ``params`` as they stand before this step's Adam update,
    through the plain MLP in the compute dtype with no gradient, whatever
    kernel the step renders through; its jitter comes from the occupancy
    stream of ``(seed, step)`` unless ``jitter [G^3, 3]`` is given. Then the
    grid is packed, every cell forced occupied while ``step < warmup_steps``.
    Returns ``(occ_words, occ_fraction)``; the fraction is the packed mask's
    mean (JAX counts the words' set bits: the same number).
    """
    if step % occupancy_cfg.update_every == 0:
        gen = None if jitter is not None else step_generator(seed, step, _OCC_STREAM,
                                                             grid.device)
        grid.copy_(occ.update_grid_ema(grid, params, nerf_cfg.position_dim,
                                       nerf_cfg.direction_dim, occupancy_cfg, gen,
                                       compute_dtype=compute_dtype, jitter=jitter))
    warm = step < occupancy_cfg.warmup_steps
    words = occ.pack_occupancy(grid, occupancy_cfg, force_all=warm)
    return words, occ.occupancy_mask(grid, occupancy_cfg, warm).float().mean()


def make_train_step(nerf_cfg: NeRFConfig, train_cfg: TrainConfig, static: SceneStatic,
                    render_fn=None, device="cuda", mlp_apply=None,
                    occupancy_cfg=None) -> Callable:
    """The train step ``step_fn(params, opt_state, images, poses, step, seed)
    -> (params, opt_state, metrics)``.

    ``render_fn`` and ``mlp_apply`` are the render hooks (``kernel_hooks``).
    With neither, the fused kernels' hierarchical render with its packing
    cache (``make_fused_render_fn``); with ``mlp_apply`` alone, the plain
    render ``models.nerf.render_rays`` around it. The parameters and Adam
    moments are updated IN PLACE (the returned ``params`` is the same tree).
    Metrics are device scalars under the JAX names plus ``lr`` (no host
    sync).

    With ``occupancy_cfg`` (``ops.occupancy.OccupancyConfig``) the step is
    ``step_fn(params, opt_state, grid, images, poses, step, seed) ->
    (params, opt_state, grid, metrics)``: ``occupancy_step_context`` updates
    the ``[G, G, G]`` grid in place and packs it, the coarse samples follow
    the packed grid, and the metrics gain ``occ_fraction``.
    """
    from minimal_nerf_torch import resolve_device
    from minimal_nerf_torch.kernels.fused_raymarch import make_fused_render_fn
    from minimal_nerf_torch.models.nerf import render_rays

    dev = resolve_device(device)
    steps_per_epoch = train_cfg.steps_per_epoch or static.num_frames
    lr_sched = make_lr_schedule(train_cfg, steps_per_epoch)
    render = render_fn or (render_rays if mlp_apply is not None else make_fused_render_fn())

    def step_fn(params, opt_state, images, poses, step: int, seed: int, coarse_sampler=None):
        batch = sample_train_batch(step, images, poses, static, train_cfg.num_rays,
                                   steps_per_epoch, train_cfg.cropping_epochs, seed,
                                   generator=step_generator(seed, step, _BATCH_STREAM, dev))
        metrics, grads = loss_and_grads(
            params, nerf_cfg, batch, train_cfg.compute_dtype, render,
            generator=step_generator(seed, step, _RENDER_STREAM, dev), mlp_apply=mlp_apply,
            coarse_sampler=coarse_sampler)
        opt_state = adam_update(params, grads, opt_state, lr_sched(opt_state["count"]))
        return params, opt_state, dict(finalize_metrics(metrics, grads), lr=lr_sched(step))

    if occupancy_cfg is None:
        return step_fn

    def occ_step_fn(params, opt_state, grid, images, poses, step: int, seed: int):
        words, occ_fraction = occupancy_step_context(
            occupancy_cfg, nerf_cfg, train_cfg.compute_dtype, params, grid, step, seed)
        params, opt_state, metrics = step_fn(params, opt_state, images, poses, step, seed,
                                             occ.make_occupancy_sampler(words, occupancy_cfg))
        return params, opt_state, grid, dict(metrics, occ_fraction=occ_fraction)

    return occ_step_fn


def make_eval_step(nerf_cfg: NeRFConfig, train_cfg: TrainConfig, mlp_apply=None,
                   render_fn=None, occupancy_cfg=None) -> Callable:
    """The validation losses of one ray batch (JAX ``make_eval_step``):
    ``eval_fn(params, origin, direc, rgb, generator, occ_words=None,
    uniforms=None) -> {"val_loss", "val_coarse_loss", "val_fine_loss"}``,
    device scalars, no gradient.

    ``render_fn`` is the hierarchical render (default: the plain
    ``models.nerf.render_rays``, as in JAX) and ``mlp_apply`` its MLP hook.
    With ``occupancy_cfg`` the coarse samples follow the packed grid
    ``occ_words`` through the train step's sampler
    (``ops.occupancy.make_occupancy_sampler``): a uniform-sampled validation
    of an occupancy-trained model would be a train/val sampling mismatch.
    ``uniforms`` replaces the render's draws.
    """
    from minimal_nerf_torch.models.nerf import render_rays

    render = render_fn or render_rays

    @torch.no_grad()
    def eval_fn(params, origin, direc, rgb, generator=None, occ_words=None, uniforms=None):
        sampler = (occ.make_occupancy_sampler(occ_words, occupancy_cfg)
                   if occupancy_cfg is not None else None)
        out = render(params, nerf_cfg, origin, direc, generator,
                     compute_dtype=train_cfg.compute_dtype, mlp_apply=mlp_apply,
                     coarse_sampler=sampler, uniforms=uniforms)
        coarse_loss = torch.mean((out["coarse_rgb_rays"] - rgb) ** 2)
        fine_loss = torch.mean((out["fine_rgb_rays"] - rgb) ** 2)
        return {"val_loss": coarse_loss + fine_loss, "val_coarse_loss": coarse_loss,
                "val_fine_loss": fine_loss}

    return eval_fn


def make_batched_eval_step(nerf_cfg: NeRFConfig, train_cfg: TrainConfig,
                           val_static: SceneStatic, mlp_apply=None, render_fn=None,
                           occupancy_cfg=None) -> Callable:
    """The validation losses averaged over EVERY val frame (JAX
    ``make_batched_eval_step``; reference ``nerf_model.py:171-197``).

    ``eval_all(params, images, poses, step, seed, occ_words=None,
    coords=None, uniforms=None) -> {"val_loss", "val_coarse_loss",
    "val_fine_loss"}``: the means over frames as device scalars (the caller
    fetches them once). Frame ``idx`` samples ``num_rays`` pixels of the
    whole frame (no crop) and renders them through ``make_eval_step``, its
    draws from ``step_generator(seed, step + idx, _VAL_STREAM)``; the frames
    run as a Python loop. ``coords[idx] = (xs, ys)`` and ``uniforms[idx]``
    replace frame ``idx``'s draws.
    """
    eval_fn = make_eval_step(nerf_cfg, train_cfg, mlp_apply, render_fn, occupancy_cfg)

    def eval_all(params, images, poses, step: int, seed: int, occ_words=None, coords=None,
                 uniforms=None):
        per_frame = []
        for idx in range(val_static.num_frames):
            gen = step_generator(seed, step + idx, _VAL_STREAM, images.device)
            batch = ray_batch_from_arrays(idx, train_cfg.num_rays, val_static.height,
                                          val_static.width, val_static.focal, images, poses,
                                          generator=gen,
                                          coords=None if coords is None else coords[idx])
            per_frame.append(eval_fn(params, batch["origin"], batch["direc"], batch["rgb"],
                                     gen, occ_words,
                                     None if uniforms is None else uniforms[idx]))
        return {k: torch.mean(torch.stack([m[k] for m in per_frame])) for k in per_frame[0]}

    return eval_all
