"""The train and eval steps: batch sampling, hierarchical render, loss,
Adam, LR; several train steps per call.

Counterpart of ``minimal_nerf_tpu/training/loop.py``. A train step is two
parts (``_build_step``, the counterpart of JAX's ``_build_step_runner``):

- ``draw_step_inputs``: every random draw and host decision of one step
  (the frame, the pixel coordinates after the crop/full choice, the render
  uniforms, Adam's LR and bias corrections, the occupancy warmup flag);
- the body, which reads those inputs only from device tensors: it renders
  the batch through the field's hooks (``minimal_nerf_torch.fields``) or
  those given, takes the gradients with autograd and applies the field's
  Adam, optax's semantics, IN PLACE on the parameter tensors.

``make_train_step`` is draw + body for one step. ``make_multi_step`` draws N
steps, then runs the body N times: on a CUDA device by replaying one
captured CUDA graph of the body N times (``_StepGraph``), elsewhere eagerly.
With an ``OccupancyConfig`` the density-EMA grid is updated in place before
the body at every ``update_every``-th step, eagerly between replays
(``update_step_grid``); the body packs the grid and the loss samples its
coarse points through it (``coarse_sampler`` of ``nerf_loss``, the
counterpart of JAX's ``make_occupancy_loss``).

Spans (``utils.profiling``): a call of either is ``nerf.train.call`` (unit
its first step, ``n`` its steps), holding ``nerf.train.draw`` (the draws put
on the device), ``nerf.train.grid_update`` (each occupancy update), and per
step ``nerf.train.body`` (eager), ``nerf.train.capture`` or
``nerf.train.replay``.

``mode="single"`` (JAX ``loss_fn=single_nerf_loss``) trains one MLP on the
coarse-only render through the same draw and body: its step draws only the
coarse uniforms, and its loss is ``single_nerf_loss``.

Data parallel (``mesh``, a ``parallel.mesh.Mesh``; JAX
``make_sharded_grad_fn``): every rank draws the WHOLE step's inputs as one
device would, and the body renders only the rank's contiguous rows of the
pixels and uniforms; the gradients, the loss and the metrics then cross the
ranks in one all-reduce of a flat fp32 buffer, divided by the world size
(JAX's ``pmean``), before the grad norm and Adam. So an N-rank step is the
1-rank step on the same draws up to the summation order, and a world of one
is the step without a mesh, bit for bit. (JAX gives each shard its own
render key, ``fold_in(key, axis_index)``.)

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
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from minimal_nerf_torch import fields
from minimal_nerf_torch.data.synthetic import ray_batch_from_arrays, sample_random_coordinates
from minimal_nerf_torch.fields import kernel_hooks, resolve_kernel  # noqa: F401
from minimal_nerf_torch.models.mlp import map_params
from minimal_nerf_torch.models.nerf import NeRFConfig, draw_render_uniforms, map_uniforms
from minimal_nerf_torch.ops import occupancy as occ
from minimal_nerf_torch.parallel import distributed
from minimal_nerf_torch.parallel.mesh import shard_batch
from minimal_nerf_torch.training.checkpoint import flatten_tree, unflatten_tree
from minimal_nerf_torch.training.config import TrainConfig
from minimal_nerf_torch.utils import profiling

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


def adam_scalars(lr, count: int, b1: float = 0.9, b2: float = 0.999) -> torch.Tensor:
    """The step-dependent scalars of one Adam update, an fp32 CPU tensor
    ``[-lr, bc1, bc2, 1/bc1, 1/bc2]``: the bias corrections ``1 - b^count``
    at the incremented ``count`` as optax computes them in fp32, and their
    fp32 reciprocals."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)  # noqa: E731
    bc1, bc2 = 1 - f32(b1) ** count, 1 - f32(b2) ** count
    one = f32(1.0)
    return torch.stack([-f32(lr), bc1, bc2, one / bc1, one / bc2])


@torch.no_grad()
def adam_apply(params: Params, grads: Params, state: Dict[str, Any], scalars: torch.Tensor,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, l2: Optional[Params] = None,
               sparse: Optional[Params] = None) -> Dict[str, Any]:
    """One ``optax.adam`` step on the ``adam_scalars`` of this update, a
    tensor on the parameters' device (no host value enters the update):
    moments updated, bias-corrected, ``p -= lr * mu_hat / (sqrt(nu_hat) +
    eps)``. ``params`` and the moments are updated in place; returns the
    state with the count incremented.

    ``l2`` (floats in the parameters' layout) adds ``l2 * p`` to a leaf's
    gradient first; a leaf marked in ``sparse`` (bools in the layout) leaves
    every element whose gradient is exactly 0 as it is, value and moments
    (Instant-NGP's hash table, ``models/ngp.py``; in the span
    ``nerf.ngp.table_adam``). Without them the update is optax's.

    The bias corrections divide on the CPU and multiply by their reciprocals
    on a CUDA device: torch divides a CUDA tensor by a Python float as a
    product with the float's fp32 reciprocal, and the update stays the one
    the corrections gave as Python floats, bit for bit, on either device.
    """
    neg_lr, bc1, bc2, inv1, inv2 = scalars.unbind(0)
    on_card = scalars.device.type == "cuda"
    leaves = flatten_tree(params)
    decays = flatten_tree(l2) if l2 is not None else [0.0] * len(leaves)
    skips = flatten_tree(sparse) if sparse is not None else [False] * len(leaves)
    for p, g, m, v, decay, skip in zip(leaves, flatten_tree(grads), flatten_tree(state["mu"]),
                                       flatten_tree(state["nu"]), decays, skips):
        if decay:
            g = g + decay * p
        if skip:
            with profiling.span("nerf.ngp.table_adam"):
                touched = g != 0
                m.copy_(torch.where(touched, (1 - b1) * g + b1 * m, m))
                v.copy_(torch.where(touched, (1 - b2) * (g * g) + b2 * v, v))
                m_hat, v_hat = (m * inv1, v * inv2) if on_card else (m / bc1, v / bc2)
                p.copy_(torch.where(touched, p + neg_lr * (m_hat / (torch.sqrt(v_hat) + eps)), p))
            continue
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * (g * g) + b2 * v)
        m_hat, v_hat = (m * inv1, v * inv2) if on_card else (m / bc1, v / bc2)
        p.add_(neg_lr * (m_hat / (torch.sqrt(v_hat) + eps)))
    return dict(state, count=state["count"] + 1)


def adam_update(params: Params, grads: Params, state: Dict[str, Any], lr,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Dict[str, Any]:
    """``adam_apply`` at the LR ``lr``: the schedule's value at the count
    before the increment (the caller's). ``params`` and the moments are
    updated in place; returns the new state. The train step hands its drawn
    scalars to ``adam_apply``; this is optax's call shape, for a step driven
    by hand from its pieces, as the tests do to hold it against optax."""
    dev = flatten_tree(params)[0].device
    return adam_apply(params, grads, state, adam_scalars(lr, state["count"] + 1, b1, b2).to(dev),
                      b1, b2, eps)


def global_norm(grads: Params) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in flatten_tree(grads)))


_DENSITY_STAT_KEYS = ("coarse_density_sumsq", "coarse_density_non_zeros",
                      "fine_density_sumsq", "fine_density_non_zeros")


def finalize_metrics(metrics: Dict[str, torch.Tensor], grads: Params,
                     num_shards: int = 1) -> Dict[str, torch.Tensor]:
    """The reference's logged names (``minimal_nerf_tpu/training/loop.py:86-106``):
    the density sums of squares become ``{coarse,fine}_density_norms`` (the
    square roots of the whole batch's sums: the mean over ``num_shards``
    ranks is undone first), the non-zero counts become whole-batch counts
    likewise, and ``grad_2.0_norm_total`` is the gradients' global norm. The
    fused render has no density statistics, as in JAX."""
    m = dict(metrics)
    for name in ("coarse", "fine"):
        k = f"{name}_density_sumsq"
        if k in m:
            m[f"{name}_density_norms"] = torch.sqrt(m.pop(k) * num_shards)
            m[f"{name}_density_non_zeros"] = m[f"{name}_density_non_zeros"] * num_shards
    m["grad_2.0_norm_total"] = global_norm(grads)
    return m


def nerf_loss(params: Params, nerf_cfg: NeRFConfig, o_rays, d_rays, rgb,
              generator: Optional[torch.Generator] = None, compute_dtype=None,
              render_fn=None, uniforms=None, mlp_apply=None,
              coarse_sampler=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``MSE(coarse, gt) + MSE(fine, gt)`` (reference ``nerf_model.py:158-161``).

    ``render_fn`` is the hierarchical render (signature of
    ``models.nerf.render_rays``); ``mlp_apply`` is its MLP hook. With
    neither, the fused kernels' (``fields.hooks_or``); with ``mlp_apply``
    alone, ``models.nerf.render_rays``. ``coarse_sampler`` overrides the
    coarse sample placement (the occupancy sampler,
    ``ops.occupancy.make_occupancy_sampler``). ``uniforms`` replaces the
    draws. The render's density statistics, where it has them, join the
    metrics.
    """
    _, render = fields.hooks_or("fused", mlp_apply, render_fn)
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


def single_nerf_loss(params: Params, nerf_cfg: NeRFConfig, o_rays, d_rays, rgb,
                     generator: Optional[torch.Generator] = None, compute_dtype=None,
                     mlp_apply=None, uniforms=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Coarse-only MSE of one MLP ``params`` (JAX ``single_nerf_loss``,
    reference ``SingleNeRF.training_step``): ``render_single`` on the
    coarse draws of ``generator`` or ``uniforms``."""
    from minimal_nerf_torch.models.nerf import render_single

    out = render_single(params, nerf_cfg, o_rays, d_rays, generator,
                        compute_dtype=compute_dtype, mlp_apply=mlp_apply, uniforms=uniforms)
    loss = torch.mean((out["pred_rgbs"] - rgb) ** 2)
    return loss, {"train_loss": loss}


def step_generator(seed: int, step: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step, stream)``."""
    mixed = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9
             + stream * 0x94D049BB133111EB) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def epoch_permutation(seed: int, epoch: int, num_frames: int) -> torch.Tensor:
    """The frame order of one epoch (CPU int64), the same for all its steps."""
    return torch.randperm(num_frames, generator=step_generator(seed, epoch, _PERM_STREAM, "cpu"))


def train_frame(step: int, steps_per_epoch: int, num_frames: int, seed: int) -> int:
    """The frame of train step ``step``: its entry in the epoch's
    permutation (``epoch_permutation``)."""
    perm = epoch_permutation(seed, step // steps_per_epoch, num_frames)
    return int(perm[step % steps_per_epoch % num_frames])


def draw_train_pixels(step: int, static: SceneStatic, num_rays: int, steps_per_epoch: int,
                      cropping_epochs: int, seed: int, generator: Optional[torch.Generator],
                      device) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """``(frame, xs, ys)`` of train step ``step``: the epoch permutation's
    frame (``train_frame``) and ``num_rays`` pixels drawn from ``generator``
    on ``device``, in the center crop while ``epoch < cropping_epochs``."""
    frame = train_frame(step, steps_per_epoch, static.num_frames, seed)
    xs, ys = sample_random_coordinates(num_rays, static.height, static.width,
                                       step // steps_per_epoch < cropping_epochs, generator,
                                       device=device)
    return frame, xs, ys


def sample_train_batch(step: int, images: torch.Tensor, poses: torch.Tensor,
                       static: SceneStatic, num_rays: int, steps_per_epoch: int,
                       cropping_epochs: int, seed: int,
                       generator: Optional[torch.Generator] = None,
                       coords=None) -> Dict[str, Any]:
    """The ray batch of train step ``step``: its frame and pixels as the
    train step draws them (``draw_train_pixels``), gathered into rays as the
    step's body gathers them.

    ``coords = (xs, ys)`` replaces the pixel draws. Returns ``origin``,
    ``direc``, ``rgb`` ``[N, 3]``, ``xs``, ``ys`` and the ``frame`` index.
    """
    if coords is None:
        frame, xs, ys = draw_train_pixels(step, static, num_rays, steps_per_epoch,
                                          cropping_epochs, seed, generator, images.device)
        coords = (xs, ys)
    else:
        frame = train_frame(step, steps_per_epoch, static.num_frames, seed)
    batch = ray_batch_from_arrays(frame, num_rays, static.height, static.width, static.focal,
                                  images, poses, coords=coords)
    return dict(batch, frame=frame)


def loss_and_grads(params: Params, nerf_cfg: NeRFConfig, batch: Dict[str, Any],
                   compute_dtype=None, render_fn=None, generator=None, uniforms=None,
                   mlp_apply=None, coarse_sampler=None, mode: str = "full"):
    """``(metrics, grads)`` of ``nerf_loss`` (``mode="single"``:
    ``single_nerf_loss``, which takes no ``render_fn`` or ``coarse_sampler``)
    on one batch; the parameters' leaves are made to require gradients, and
    no ``.grad`` is written."""
    leaves = flatten_tree(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    o, d, rgb = batch["origin"], batch["direc"], batch["rgb"]
    if mode == "single":
        loss, metrics = single_nerf_loss(params, nerf_cfg, o, d, rgb, generator, compute_dtype,
                                         mlp_apply, uniforms)
    else:
        loss, metrics = nerf_loss(params, nerf_cfg, o, d, rgb, generator, compute_dtype,
                                  render_fn, uniforms, mlp_apply, coarse_sampler)
    grads = torch.autograd.grad(loss, leaves)
    return ({k: v.detach() for k, v in metrics.items()},
            unflatten_tree(params, list(grads)))


def update_step_grid(occupancy_cfg, nerf_cfg: NeRFConfig, compute_dtype, params: Params,
                     grid: torch.Tensor, step: int, seed: int,
                     jitter: Optional[torch.Tensor] = None, field=None) -> None:
    """At ``step % update_every == 0``, the density EMA updated IN PLACE in
    ``grid`` from ``params`` as they stand before this step's Adam update,
    through the ``field``'s density (default: the NeRF MLPs of ``nerf_cfg``)
    in the compute dtype with no gradient; its jitter comes from the
    occupancy stream of ``(seed, step)`` unless ``jitter [G^3, 3]`` is given.
    Runs eagerly, also between the replays of ``make_multi_step``."""
    if step % occupancy_cfg.update_every == 0:
        gen = None if jitter is not None else step_generator(seed, step, _OCC_STREAM,
                                                             grid.device)
        grid.copy_(occ.update_grid_ema(grid, fields.default_field(field, nerf_cfg), params,
                                       occupancy_cfg, gen, compute_dtype, jitter))


def pack_step_grid(occupancy_cfg, grid: torch.Tensor, force_all):
    """The grid packed for one step's sampler, every cell forced occupied
    where ``force_all`` (a bool, or a bool tensor on the grid's device):
    ``(occ_words, occ_fraction)``; the fraction is the packed mask's mean
    (JAX counts the words' set bits: the same number)."""
    words = occ.pack_occupancy(grid, occupancy_cfg, force_all=force_all)
    return words, occ.occupancy_mask(grid, occupancy_cfg, force_all).float().mean()


def draw_step_inputs(nerf_cfg: NeRFConfig, train_cfg: TrainConfig, static: SceneStatic,
                     step: int, count: int, seed: int, device,
                     occupancy_cfg=None, mode: str = "full",
                     betas: Tuple[float, ...] = ()) -> Dict[str, Any]:
    """Every random draw and host decision of train step ``step``, whose
    Adam update is the ``count + 1``-th, from the generators of ``(seed,
    step)`` in the order the render consumes them.

    Host values: ``frame`` (the epoch permutation's entry), ``force_all``
    (the occupancy warmup), ``adam`` (``adam_scalars`` at the schedule's LR
    of ``count``; ``betas``, a field's ``(b1, b2)``, in place of its
    defaults) and ``lr`` (the metric, the schedule at ``step``, an fp32 CPU
    scalar). On ``device``: the pixel coordinates ``xs``, ``ys`` (center
    crop while ``epoch < cropping_epochs``) and ``uniforms``, the render's
    draws: ``"coarse"`` (``[N, Sc]``, or under occupancy the sampler's ``(eps
    [N, 1], frac [N, Sc] or None)``), then the fine ``"eps" [N, 1]`` and, with
    ``fine_sampling="reference"``, ``"jitter" [N, Sf, 1]``; under
    ``mode="single"`` only ``"coarse"``. ``inputs_on_device`` puts the host
    values on the device.
    """
    steps_per_epoch = train_cfg.steps_per_epoch or static.num_frames
    lr_sched = make_lr_schedule(train_cfg, steps_per_epoch)
    frame, xs, ys = draw_train_pixels(step, static, train_cfg.num_rays, steps_per_epoch,
                                      train_cfg.cropping_epochs, seed,
                                      step_generator(seed, step, _BATCH_STREAM, device), device)
    uniforms = draw_render_uniforms(nerf_cfg, train_cfg.num_rays,
                                    step_generator(seed, step, _RENDER_STREAM, device), device,
                                    occupancy_cfg, mode)
    warm = occupancy_cfg is not None and step < occupancy_cfg.warmup_steps
    return {"frame": frame, "force_all": warm,
            "adam": adam_scalars(lr_sched(count), count + 1, *betas),
            "lr": lr_sched(step), "xs": xs, "ys": ys, "uniforms": uniforms}


def inputs_on_device(draws: List[Dict[str, Any]], device) -> List[Dict[str, Any]]:
    """``draw_step_inputs`` of one or more steps with their host values on
    ``device``, each kind in one host-to-device copy (from pinned memory,
    not waited for, on a CUDA device): per step ``frame [1]`` int64,
    ``force_all`` bool and ``adam [5]`` fp32, beside the draws' device
    tensors and the ``lr`` metric."""
    dev = torch.device(device)
    host = (torch.tensor([d["frame"] for d in draws], dtype=torch.int64),
            torch.tensor([bool(d["force_all"]) for d in draws]),
            torch.stack([d["adam"] for d in draws]))
    if dev.type == "cuda":
        host = tuple(t.pin_memory().to(dev, non_blocking=True) for t in host)
    frames, force, adam = host
    return [dict(d, frame=frames[i:i + 1], force_all=force[i], adam=adam[i])
            for i, d in enumerate(draws)]


def _input_tensors(inp: Dict[str, Any]) -> List[torch.Tensor]:
    """The device tensors of one step's inputs, in a fixed order."""
    u = inp["uniforms"]
    coarse = u["coarse"] if isinstance(u["coarse"], tuple) else (u["coarse"],)
    return [t for t in (inp["frame"], inp["force_all"], inp["adam"], inp["xs"], inp["ys"],
                        *coarse, u.get("eps"), u.get("jitter")) if t is not None]


def _clone_inputs(inp: Dict[str, Any]) -> Dict[str, Any]:
    """One step's inputs with every device tensor copied (the static inputs
    of a captured step)."""
    c = lambda t: None if t is None else t.clone()  # noqa: E731
    u = inp["uniforms"]
    coarse = tuple(map(c, u["coarse"])) if isinstance(u["coarse"], tuple) else c(u["coarse"])
    return dict(inp, frame=c(inp["frame"]), force_all=c(inp["force_all"]),
                adam=c(inp["adam"]), xs=c(inp["xs"]), ys=c(inp["ys"]),
                uniforms={k: coarse if k == "coarse" else c(v) for k, v in u.items()})


def _all_reduce_mean(metrics: Dict[str, torch.Tensor], grads: Params, mesh):
    """``(metrics, grads)`` averaged over the ranks in ONE all-reduce of a
    flat fp32 buffer (``parallel.distributed.all_reduce_mean``)."""
    leaves, names = flatten_tree(grads), list(metrics)
    reduced = distributed.all_reduce_mean(leaves + [metrics[k] for k in names], mesh)
    return (dict(zip(names, reduced[len(leaves):])),
            unflatten_tree(grads, reduced[:len(leaves)]))


def _build_step(nerf_cfg: NeRFConfig, train_cfg: TrainConfig, static: SceneStatic,
                render_fn, device, mlp_apply, occupancy_cfg, mode: str = "full", mesh=None,
                field=None):
    """The ONE implementation of a train step (JAX ``_build_step_runner``):
    ``(draw, update_grid, body)``, which ``make_train_step`` and
    ``make_multi_step`` both drive, so the eager and the replayed step
    cannot drift apart.

    ``draw(step, count, seed)`` is ``draw_step_inputs``;
    ``update_grid(params, grid, step, seed)`` the occupancy update of the
    step (nothing without occupancy); ``body(params, opt_state, grid,
    images, poses, inp) -> (params, opt_state, metrics)`` the rest of the
    step on ``inputs_on_device`` inputs, reading no host value: it packs the
    grid (occupancy), gathers the batch, renders, takes the gradients and
    applies Adam in place. ``mode="single"``: the coarse-only loss of one
    MLP, no render hook and no occupancy. With a ``mesh`` the body renders
    this rank's rows of the drawn pixels and uniforms and averages the
    gradients and metrics over the ranks before Adam. The ``field``
    (``minimal_nerf_torch.fields``; default the NeRF MLPs under the fused
    kernels) brings its render hooks where none are given, its density to
    the grid's update and its Adam (``adam_options``).
    """
    from minimal_nerf_torch import resolve_device

    if mode == "single" and occupancy_cfg is not None:
        raise ValueError("occupancy acceleration requires mode='full'")
    field = fields.default_field(field, nerf_cfg, mode=mode)
    if field.mode != mode or (mesh is not None and mesh.size > 1 and not field.data_parallel):
        raise ValueError(f"the {field.name} field trains in mode {field.mode!r}"
                         + ("" if field.data_parallel else " on one device (no data parallel)"))
    mlp_apply, render = fields.hooks_or(field, mlp_apply, render_fn)
    betas = (field.adam["b1"], field.adam["b2"])
    dev = resolve_device(device)

    def draw(step: int, count: int, seed: int):
        return draw_step_inputs(nerf_cfg, train_cfg, static, step, count, seed, dev,
                                occupancy_cfg, mode, betas)

    def update_grid(params, grid, step: int, seed: int):
        if occupancy_cfg is not None and step % occupancy_cfg.update_every == 0:
            with profiling.span("nerf.train.grid_update", step):
                update_step_grid(occupancy_cfg, nerf_cfg, train_cfg.compute_dtype, params,
                                 grid, step, seed, field=field)

    def body(params, opt_state, grid, images, poses, inp):
        sampler = occ_fraction = None
        if occupancy_cfg is not None:
            words, occ_fraction = pack_step_grid(occupancy_cfg, grid, inp["force_all"])
            sampler = occ.make_occupancy_sampler(words, occupancy_cfg)
        xs, ys, uniforms = inp["xs"], inp["ys"], inp["uniforms"]
        if mesh is not None:
            xs, ys, uniforms = (shard_batch(xs, mesh), shard_batch(ys, mesh),
                                map_uniforms(lambda t: shard_batch(t, mesh), uniforms))
        batch = ray_batch_from_arrays(inp["frame"], xs.shape[0], static.height, static.width,
                                      static.focal, images, poses, coords=(xs, ys))
        metrics, grads = loss_and_grads(params, nerf_cfg, batch, train_cfg.compute_dtype,
                                        render, uniforms=uniforms, mlp_apply=mlp_apply,
                                        coarse_sampler=sampler, mode=mode)
        if mesh is not None:
            metrics, grads = _all_reduce_mean(metrics, grads, mesh)
        opt_state = adam_apply(params, grads, opt_state, inp["adam"],
                               **field.adam_options(params))
        metrics = dict(finalize_metrics(metrics, grads, mesh.size if mesh is not None else 1),
                       lr=inp["lr"])
        if occ_fraction is not None:
            metrics["occ_fraction"] = occ_fraction
        return params, opt_state, metrics

    return draw, update_grid, body


def make_train_step(nerf_cfg: NeRFConfig, train_cfg: TrainConfig, static: SceneStatic,
                    render_fn=None, device="cuda", mlp_apply=None,
                    occupancy_cfg=None, mode: str = "full", mesh=None, field=None) -> Callable:
    """The train step ``step_fn(params, opt_state, images, poses, step, seed)
    -> (params, opt_state, metrics)``: ``draw_step_inputs``, then the body
    of ``_build_step``.

    ``render_fn`` and ``mlp_apply`` are the render hooks (``kernel_hooks``).
    With neither, the ``field``'s (the NeRF MLPs': the fused kernels'
    hierarchical render with its packing cache); with ``mlp_apply`` alone,
    the plain render ``models.nerf.render_rays`` around it. The parameters
    and Adam moments are updated IN PLACE (the returned ``params`` is the
    same tree). Metrics are device scalars under the JAX names plus ``lr``
    (no host sync).

    With ``occupancy_cfg`` (``ops.occupancy.OccupancyConfig``) the step is
    ``step_fn(params, opt_state, grid, images, poses, step, seed) ->
    (params, opt_state, grid, metrics)``: ``update_step_grid`` updates the
    ``[G, G, G]`` grid in place, the body packs it, the coarse samples
    follow the packed grid, and the metrics gain ``occ_fraction``.

    ``mode="single"`` (JAX ``loss_fn=single_nerf_loss``): ``params`` is one
    MLP, the loss ``single_nerf_loss`` through ``mlp_apply`` (the point
    kernels' hook under ``--kernel pallas``, else the plain MLP), the
    metrics ``train_loss``, ``grad_2.0_norm_total`` and ``lr``.

    ``mesh`` (``parallel.mesh.Mesh``): one rank's data-parallel step, which
    every rank of the mesh runs (module doc); ``train_cfg.num_rays`` is the
    whole step's and must divide by the mesh size.

    ``field`` (``minimal_nerf_torch.fields``; None: the NeRF MLPs): the
    field trained, ``params`` its tree.
    """
    draw, update_grid, body = _build_step(nerf_cfg, train_cfg, static, render_fn, device,
                                          mlp_apply, occupancy_cfg, mode, mesh, field)

    def run(params, opt_state, grid, images, poses, step: int, seed: int):
        with profiling.span("nerf.train.call", step):
            with profiling.span("nerf.train.draw"):
                inp = inputs_on_device([draw(step, opt_state["count"], seed)], images.device)[0]
            update_grid(params, grid, step, seed)
            with profiling.span("nerf.train.body"):
                return body(params, opt_state, grid, images, poses, inp)

    if occupancy_cfg is None:
        def step_fn(params, opt_state, images, poses, step: int, seed: int):
            return run(params, opt_state, None, images, poses, step, seed)

        return step_fn

    def occ_step_fn(params, opt_state, grid, images, poses, step: int, seed: int):
        params, opt_state, metrics = run(params, opt_state, grid, images, poses, step, seed)
        return params, opt_state, grid, metrics

    return occ_step_fn


class _StepGraph:
    """One train step's body captured as a CUDA graph and replayed once per
    step (``make_multi_step`` on a CUDA device).

    The graph reads its inputs from static tensors, refilled by
    device-to-device copies before each replay, and updates in place the
    parameters, moments and grid it was captured with; a call with other
    state tensors (by address) captures again. Before a capture the call's
    first step runs eagerly, so that every kernel is built and launched once
    and every lazy initialisation is done outside the captured region: the
    warm-up is a step of the trajectory, not an extra one. The render hooks
    pack the weights inside the capture (they skip their caches while the
    stream captures), so each replay packs the weights it trains. A failed
    capture or replay raises.

    One step per graph, replayed N times, rather than N steps in one graph:
    one graph serves a call at any start step, the occupancy update runs
    eagerly between replays at any phase of its period, and the capture's
    time and the graph's memory pool are one step's.

    The capture runs the body's spans once (under ``nerf.train.capture``);
    a replay runs no Python of the body, so each replayed step is one span,
    ``nerf.train.replay`` (its input copies and ``graph.replay()``). The
    launch counters the capture raised (``utils.profiling``) stay counted
    and are added again for each replay, beside ``graph.replays``
    (``profiling.CaptureCounts``).
    """

    def __init__(self, update_grid, body):
        self.update_grid, self.body = update_grid, body
        self.graph = self.key = self.inputs = self.metrics = None
        self.counts = profiling.CaptureCounts("graph.replays")

    def _capture(self, key, params, opt_state, grid, images, poses, inp):
        self.graph = self.inputs = self.metrics = self.key = None  # release the old pool
        inputs = _clone_inputs(inp)
        graph = torch.cuda.CUDAGraph()
        # anomaly mode's checks read values on the host, which a capture forbids
        with (self.counts.capture(keep=True), torch.autograd.set_detect_anomaly(False),
              torch.cuda.graph(graph)):
            _, _, metrics = self.body(params, opt_state, grid, images, poses, inputs)
        self.graph, self.key, self.inputs, self.metrics = graph, key, inputs, metrics

    def run(self, params, opt_state, grid, images, poses, steps, inputs, seed):
        """Steps ``steps`` on their ``inputs_on_device`` inputs; returns the
        last step's metrics (copies, which later replays leave alone)."""
        key = tuple(t.data_ptr() for t in flatten_tree(
            [params, opt_state["mu"], opt_state["nu"]]) + [grid, images, poses]
            if t is not None)
        first, metrics = 0, None
        if key != self.key:
            self.update_grid(params, grid, steps[0], seed)
            with profiling.span("nerf.train.body", steps[0]):
                _, _, metrics = self.body(params, opt_state, grid, images, poses, inputs[0])
            with profiling.span("nerf.train.capture", steps[0]):
                self._capture(key, params, opt_state, grid, images, poses, inputs[0])
            first = 1
        for step, inp in zip(steps[first:], inputs[first:]):
            self.update_grid(params, grid, step, seed)
            with profiling.span("nerf.train.replay", step):
                for dst, src in zip(_input_tensors(self.inputs), _input_tensors(inp)):
                    dst.copy_(src)
                self.graph.replay()
        self.counts.replayed(len(steps) - first)
        if first < len(steps):
            metrics = {k: v.clone() for k, v in self.metrics.items()}
            # the replays changed the parameters in place behind autograd's
            # back: advance their versions, which the render hooks' packing
            # caches key on
            for leaf in flatten_tree(params):
                torch.autograd.graph.increment_version(leaf)
        return metrics


def make_multi_step(nerf_cfg: NeRFConfig, train_cfg: TrainConfig, static: SceneStatic,
                    num_inner: int, render_fn=None, device="cuda", mlp_apply=None,
                    occupancy_cfg=None, mode: str = "full", mesh=None, field=None) -> Callable:
    """``num_inner`` train steps in one call (JAX ``make_multi_step``), the
    same steps as ``make_train_step`` called ``num_inner`` times, bit for
    bit.

    ``multi_fn(params, opt_state, images, poses, start_step, seed,
    inputs=None) -> (params, opt_state, last_metrics)``; with
    ``occupancy_cfg`` ``multi_fn(params, opt_state, grid, images, poses,
    start_step, seed, inputs=None) -> (params, opt_state, grid,
    last_metrics)``. ``last_metrics`` are the last step's, ``lr`` included.
    The call first draws every step's inputs (``draw_step_inputs``, or takes
    ``inputs``, one per step), puts them on the device, then runs the body of
    ``_build_step`` once per step, each occupancy update before its step: on
    a CUDA device as replays of one captured CUDA graph (``_StepGraph``), on
    the CPU eagerly. State is updated in place, as by ``make_train_step``;
    ``mode``, ``mesh`` and ``field`` are ``make_train_step``'s. Under a mesh on CUDA
    devices the graph holds the step's NCCL all-reduce (captured after the
    eager first step has run it once); a gloo group of more than one rank
    raises there, since gloo's collectives cannot be captured.
    """
    if (mesh is not None and mesh.size > 1 and torch.device(device).type == "cuda"
            and distributed.backend() != "nccl"):
        raise ValueError(f"several steps per call on CUDA devices replay a CUDA graph, which "
                         f"cannot hold a {distributed.backend()} collective: run one step "
                         "per call (--steps-per-call 1) or use NCCL")
    draw, update_grid, body = _build_step(nerf_cfg, train_cfg, static, render_fn, device,
                                          mlp_apply, occupancy_cfg, mode, mesh, field)
    graph = _StepGraph(update_grid, body)

    def run(params, opt_state, grid, images, poses, start_step: int, seed: int, inputs):
        steps = list(range(start_step, start_step + num_inner))
        count = opt_state["count"]
        with profiling.span("nerf.train.call", start_step, num_inner):
            with profiling.span("nerf.train.draw"):
                if inputs is None:
                    inputs = [draw(step, count + i, seed) for i, step in enumerate(steps)]
                if len(inputs) != num_inner:
                    raise ValueError(f"{len(inputs)} steps' inputs for a call of {num_inner} "
                                     "steps")
                inputs = inputs_on_device(inputs, images.device)
            if images.device.type == "cuda":
                metrics = graph.run(params, opt_state, grid, images, poses, steps, inputs, seed)
            else:
                for step, inp in zip(steps, inputs):
                    update_grid(params, grid, step, seed)
                    with profiling.span("nerf.train.body", step):
                        params, opt_state, metrics = body(params, opt_state, grid, images,
                                                          poses, inp)
        return (params, dict(opt_state, count=count + num_inner),
                dict(metrics, lr=inputs[-1]["lr"]))

    if occupancy_cfg is None:
        def multi_fn(params, opt_state, images, poses, start_step: int, seed: int,
                     inputs=None):
            return run(params, opt_state, None, images, poses, start_step, seed, inputs)

        return multi_fn

    def occ_multi_fn(params, opt_state, grid, images, poses, start_step: int, seed: int,
                     inputs=None):
        params, opt_state, metrics = run(params, opt_state, grid, images, poses, start_step,
                                         seed, inputs)
        return params, opt_state, grid, metrics

    return occ_multi_fn


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
    mlp_apply, render = fields.hooks_or("xla", mlp_apply, render_fn)

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


def make_batched_eval_step_single(nerf_cfg: NeRFConfig, train_cfg: TrainConfig,
                                  val_static: SceneStatic, mlp_apply=None) -> Callable:
    """``mode="single"``'s ``make_batched_eval_step`` (JAX
    ``make_batched_eval_step_single``): every val frame's coarse-only loss.

    ``eval_all(params, images, poses, step, seed, coords=None,
    uniforms=None) -> {"val_loss"}``, the mean over frames as a device
    scalar (the caller fetches it once); ``params`` is one MLP. Frame
    ``idx`` samples ``num_rays`` pixels of the whole frame and renders them
    through ``render_single`` (``mlp_apply``, in the compute dtype, no
    gradient), its draws from ``step_generator(seed, step + idx,
    _VAL_STREAM)`` as in the full mode; ``coords[idx]`` and
    ``uniforms[idx]`` (``{"coarse": [N, S]}``) replace them.
    """
    from minimal_nerf_torch.models.nerf import render_single

    @torch.no_grad()
    def eval_all(params, images, poses, step: int, seed: int, coords=None, uniforms=None):
        losses = []
        for idx in range(val_static.num_frames):
            gen = step_generator(seed, step + idx, _VAL_STREAM, images.device)
            batch = ray_batch_from_arrays(idx, train_cfg.num_rays, val_static.height,
                                          val_static.width, val_static.focal, images, poses,
                                          generator=gen,
                                          coords=None if coords is None else coords[idx])
            out = render_single(params, nerf_cfg, batch["origin"], batch["direc"], gen,
                                compute_dtype=train_cfg.compute_dtype, mlp_apply=mlp_apply,
                                uniforms=None if uniforms is None else uniforms[idx])
            losses.append(torch.mean((out["pred_rgbs"] - batch["rgb"]) ** 2))
        return {"val_loss": torch.mean(torch.stack(losses))}

    return eval_all
