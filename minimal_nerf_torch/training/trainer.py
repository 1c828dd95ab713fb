"""The training orchestrator (epochs, validation, checkpoints, resume), and
loading a trained model for inference.

Counterpart of ``minimal_nerf_tpu/training/trainer.py``, for
``mode="full"`` (the coarse + fine network) and ``mode="single"`` (one MLP
on the coarse-only render, no occupancy), on one device or as one rank of a
data-parallel ``mesh`` (``parallel.mesh``): a plain loop around
``training/loop.py``'s train step, with the reference's semantics:

- ``steps_per_call`` steps in one call (``loop.make_multi_step``: on a card
  the replays of one captured CUDA graph of the step) whenever the next
  boundary is at least that far, single steps otherwise; the same steps as
  one per call, bit for bit;

- one epoch = one shuffled pass over the train frames, the center-crop
  warmup for the first ``cropping_epochs`` epochs;
- a ``metrics.csv`` row every ``log_every`` steps (the step's metrics
  fetched in one device-to-host copy; between rows nothing is fetched);
- every ``check_val_every_n_epoch`` epochs the val losses over every val
  frame, one reconstructed val view (every ``val_render_every``-th time) and
  a checkpoint, as one row; a checkpoint every ``ckpt_every_steps`` steps;
  a final blocking save;
- checkpoints ``model={name}-epoch={E}-step={S}.ckpt`` in the JAX format,
  written on a background thread; resume from a path or ``"auto"`` (the
  latest in the run), or in memory from a previous phase's ``final_state``;
  a ``mode="single"`` checkpoint holds one MLP's leaves and its header says
  so (``extra["mode"]``), as in JAX;
- data parallel: every rank starts from rank 0's state (a broadcast, after
  a check that every rank resumed at the same step) and runs the same
  steps; rank 0 alone logs, validates, renders and saves, the others write
  nothing (a ``NullLogger``) and meet it again at the next step's
  all-reduce.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

import torch

from minimal_nerf_torch import resolve_device
from minimal_nerf_torch.models.mlp import map_params, nerf_mlp_shapes
from minimal_nerf_torch.models.mlp import init_nerf_mlp
from minimal_nerf_torch.models.nerf import NeRFConfig, init_nerf_network, render_single
from minimal_nerf_torch.models.ngp import checkpoint_field
from minimal_nerf_torch.parallel import distributed
from minimal_nerf_torch.training import checkpoint as ckpt_lib
from minimal_nerf_torch.training import loop
from minimal_nerf_torch.training.config import TrainConfig
from minimal_nerf_torch.training.metrics import MetricsLogger, NullLogger
from minimal_nerf_torch.utils import profiling

# generator streams of the validation view: which frame, and its draws
_VIEW_STREAM, _VIEW_RENDER_STREAM = 0x71E, 0x71F


MODES = ("full", "single")


def _check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: the Trainer trains {' or '.join(MODES)}")
    return mode


def checkpoint_mode(header) -> str:
    """The training mode a checkpoint's header names (``"full"`` when it
    names none, as in JAX)."""
    return _check_mode((header.get("extra") or {}).get("mode", "full"))


def restore_to_device(header, leaves, nerf_cfg: NeRFConfig, occ_cfg, dev):
    """``(params, opt_state, grid)`` of a loaded checkpoint as fp32 tensors
    on ``dev`` (``opt_state = {"count", "mu", "nu"}``; ``grid`` None
    without ``occ_cfg``): the coarse + fine network, one MLP for a
    ``mode="single"`` checkpoint, or the tree of the field its header names
    (``models.ngp.checkpoint_field``). A layout other than the configs and
    the mode describe raises."""
    grid_shape = (occ_cfg.resolution,) * 3 if occ_cfg is not None else None
    mlp = nerf_mlp_shapes(nerf_cfg.position_dim, nerf_cfg.direction_dim)
    field = checkpoint_field(header)
    shapes = (field.shapes() if field is not None else
              mlp if checkpoint_mode(header) == "single" else {"coarse": mlp, "fine": mlp})
    params, opt, grid = ckpt_lib.restore_state(header, leaves, shapes, grid_shape)
    to_dev = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)  # noqa: E731
    opt = {"count": opt["count"], "mu": map_params(to_dev, opt["mu"]),
           "nu": map_params(to_dev, opt["nu"])}
    return map_params(to_dev, params), opt, None if grid is None else to_dev(grid)


def fetch_scalars(metrics) -> dict:
    """``{name: float}`` of a dict of scalar tensors in sorted key order (as
    JAX returns a dict from a jitted function), those on one device fetched
    in one copy (``checkpoint.host_copy``)."""
    values = ckpt_lib.host_copy(list(metrics.values()))
    return dict(sorted((k, float(v)) for k, v in zip(metrics, values)))


class Trainer:
    """End-to-end NeRF training on one device or one rank of a data mesh
    (``mode="full"`` or ``"single"``)."""

    def __init__(self, nerf_config: NeRFConfig, train_config: TrainConfig, base_dir, root_dir,
                 name: str = "nerf", resume_ckpt: Optional[str] = None, mlp_apply=None,
                 render_fn=None, logger=None, mode: str = "full",
                 wandb_project: Optional[str] = None, initial_state=None, device="cuda",
                 mesh=None, field=None):
        """``base_dir`` is a Blender-style scene tree (``train`` and, if
        present, ``val`` are loaded onto ``device``) or a dict ``{split:
        SyntheticScene}`` already on ``device``. ``resume_ckpt`` is a
        checkpoint path or ``"auto"`` (the latest in the run's checkpoint
        folder, resolved here so that the logger adopts an existing
        ``metrics.csv`` only when a run resumes). ``initial_state = (params,
        opt_state, grid, step)`` continues in memory from a previous
        Trainer's ``final_state`` and takes precedence over
        ``resume_ckpt``. ``mlp_apply`` and ``render_fn`` are the render
        hooks (``loop.kernel_hooks``); with neither, those of
        ``train_config.kernel`` on ``device``. ``mode="single"`` trains one
        MLP on the coarse-only render (``render_fn`` unused); occupancy
        then raises, as in JAX. ``mesh`` (``parallel.mesh.make_mesh``) makes
        this Trainer one rank of a data-parallel run on ``mesh.device``;
        only rank 0 writes. ``field`` (``models.ngp.NGPField``) trains one
        field for both passes in place of the coarse and fine MLPs, on one
        device; its hooks are the render's unless others are given, and its
        checkpoints name it."""
        from minimal_nerf_torch.data.synthetic import SyntheticScene

        self.mode = _check_mode(mode)
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.mesh = mesh
        self.is_primary = distributed.is_primary()
        self.nerf_config = nerf_config
        self.train_config = train_config
        self.name = name
        self.run_dir = Path(root_dir) / name
        self.ckpt_dir = self.run_dir / "checkpoints"
        self._initial_state = initial_state
        if resume_ckpt == "auto":
            latest = ckpt_lib.latest_checkpoint(self.ckpt_dir)
            resume_ckpt = str(latest) if latest else None
        self.resume_ckpt = resume_ckpt
        if self.is_primary:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
            self.logger = logger or MetricsLogger(
                self.run_dir, name=name, wandb_project=wandb_project,
                resume=resume_ckpt is not None or initial_state is not None)
        else:
            self.logger = logger or NullLogger()

        if isinstance(base_dir, dict):
            self.train_scene, self.val_scene = base_dir["train"], base_dir.get("val")
        else:
            self.train_scene = SyntheticScene.load(base_dir, "train", self.device)
            try:
                self.val_scene = SyntheticScene.load(base_dir, "val", self.device)
            except FileNotFoundError:
                self.val_scene = None
        self.static = loop.scene_static(self.train_scene)
        self.steps_per_epoch = train_config.steps_per_epoch or self.static.num_frames
        self._occ_cfg = train_config.occupancy_config
        self.field = field
        if mlp_apply is None and render_fn is None:
            mlp_apply, render_fn = (field.hooks() if field is not None else
                                    loop.kernel_hooks(train_config.kernel, self.device, mode))
        self.mlp_apply, self.render_fn = mlp_apply, render_fn
        self.step_fn = loop.make_train_step(nerf_config, train_config, self.static, render_fn,
                                            self.device, mlp_apply, self._occ_cfg, mode, mesh,
                                            field)
        self.multi_fn = None
        if train_config.steps_per_call > 1:
            self.multi_fn = loop.make_multi_step(
                nerf_config, train_config, self.static, train_config.steps_per_call, render_fn,
                self.device, mlp_apply, self._occ_cfg, mode, mesh, field)
        self._grid = None
        self._batched_eval = None
        self._val_render_chunk = None
        self._pending_save = None

    # ------------------------------------------------------------------ state

    def init_state(self):
        """``(params, opt_state, start_step)``: handed over in memory, resumed
        from ``resume_ckpt`` (the occupancy grid too; its mode must be the
        Trainer's), or fresh (``init_nerf_network``, or ``init_nerf_mlp`` in
        single mode, from a generator seeded with the config's seed, zero
        Adam state, a zero grid). Sets ``self._grid``."""
        if self._initial_state is not None:
            params, opt_state, grid, start_step = self._initial_state
            self._grid = grid
            print(f"[trainer] continuing in-memory at step {start_step}", file=sys.stderr)
            return params, opt_state, start_step
        if self.resume_ckpt:
            header, leaves = ckpt_lib.load_checkpoint(self.resume_ckpt)
            if checkpoint_mode(header) != self.mode:
                raise ValueError(f"{self.resume_ckpt} is a mode={checkpoint_mode(header)!r} "
                                 f"checkpoint; this run trains mode={self.mode!r}")
            saved = checkpoint_field(header)
            if (saved and saved.header()) != (self.field and self.field.header()):
                raise ValueError(f"{self.resume_ckpt} holds the field "
                                 f"{saved.header() if saved else 'nerf'}; this run trains "
                                 f"{self.field.header() if self.field else 'nerf'}")
            params, opt_state, self._grid = restore_to_device(
                header, leaves, self.nerf_config, self._occ_cfg, self.device)
            start_step = int(header["step"])
            print(f"[trainer] resumed from {self.resume_ckpt} at step {start_step}",
                  file=sys.stderr)
            return params, opt_state, start_step
        from minimal_nerf_torch.ops import occupancy as occ

        gen = torch.Generator(device=self.device).manual_seed(self.train_config.seed)
        cfg = self.nerf_config
        params = (self.field.init(gen, self.device) if self.field is not None else
                  init_nerf_network(gen, cfg, device=self.device) if self.mode == "full" else
                  init_nerf_mlp(gen, cfg.position_dim, cfg.direction_dim, device=self.device))
        self._grid = (occ.init_grid(self._occ_cfg, self.device)
                      if self._occ_cfg is not None else None)
        return params, loop.adam_init(params), 0

    # -------------------------------------------------------------------- fit

    def _next_boundary(self, step: int) -> int:
        """The next step after ``step`` at which logging, validation or a
        checkpoint may be due; only the train step runs strictly between
        two boundaries."""
        cfg = self.train_config
        candidates = [cfg.max_steps]
        for period in (cfg.log_every, self.steps_per_epoch, cfg.ckpt_every_steps):
            if period and period > 0:
                candidates.append((step // period + 1) * period)
        return min(c for c in candidates if c > step)

    def fit(self):
        """Train to ``max_steps``; returns the final params and leaves
        ``final_state = (params, opt_state, grid, max_steps)``. Between two
        boundaries the steps run ``steps_per_call`` to a call while at least
        that many remain (a CSV row then reports the call's last step), one
        to a call otherwise; the state tensors are updated in place (those a
        captured step graph updates), so the saves read the live state. With
        ``--debug-nans`` the loss is checked once per call, on its last
        step."""
        cfg = self.train_config
        params, opt_state, step = self.init_state()
        grid = self._grid
        if self.mesh is not None:
            # before the early return below, so that ranks resumed at
            # different steps raise here instead of leaving some ranks
            # waiting in a collective
            distributed.check_same_step(step, self.mesh)
            distributed.put_replicated(
                [t for t in (params, opt_state["mu"], opt_state["nu"], grid) if t is not None],
                self.mesh)
        if step >= cfg.max_steps:
            print(f"[trainer] resume step {step} >= max_steps {cfg.max_steps}: nothing to do",
                  file=sys.stderr)
            self.final_state = (params, opt_state, grid, step)
            return params
        images, poses = self.train_scene.images, self.train_scene.poses
        self.logger.log_hyperparams(
            {**self.nerf_config.to_dict(), **cfg.to_dict(), "name": self.name})
        timer = profiling.StepTimer(cfg.num_rays)
        t_fit_start = time.perf_counter()
        spc = cfg.steps_per_call
        while step < cfg.max_steps:
            boundary = self._next_boundary(step)
            while step < boundary:
                n = spc if self.multi_fn is not None and boundary - step >= spc else 1
                fn = self.multi_fn if n > 1 else self.step_fn
                timer.tick(n)
                if grid is not None:
                    params, opt_state, grid, metrics = fn(
                        params, opt_state, grid, images, poses, step, cfg.seed)
                else:
                    params, opt_state, metrics = fn(params, opt_state, images, poses, step,
                                                    cfg.seed)
                step += n
                profiling.check_finite("train_loss", metrics["train_loss"], step - 1)

            if not self.is_primary:
                continue
            if step % cfg.log_every == 0 or step == cfg.max_steps:
                fetched = fetch_scalars(metrics)
                rates = timer.rates()
                it_s = rates["iterations_per_sec"]
                self.logger.log_scalars(step, dict(
                    fetched, **rates, **{"train iteration speed": 1.0 / it_s},
                    wall_seconds=time.perf_counter() - t_fit_start))

            epoch = step // self.steps_per_epoch
            if step % self.steps_per_epoch == 0 and epoch % cfg.check_val_every_n_epoch == 0:
                t0 = time.perf_counter()
                val_scalars = self.validate(params, step, log=False) or {}
                t_val = time.perf_counter() - t0
                t0 = time.perf_counter()
                self.save(params, opt_state, step)
                self.logger.log_scalars(step, dict(
                    val_scalars, val_seconds=t_val, ckpt_seconds=time.perf_counter() - t0,
                    wall_seconds=time.perf_counter() - t_fit_start))
            elif step % cfg.ckpt_every_steps == 0:
                self.save(params, opt_state, step)

        if self.is_primary:
            self.save(params, opt_state, cfg.max_steps, blocking=True)
        self.final_state = (params, opt_state, grid, cfg.max_steps)
        return params

    # ------------------------------------------------------------- validation

    def validate(self, params, step: int, log: bool = True) -> Optional[dict]:
        """The val losses over every val frame (fetched in one copy), and
        every ``val_render_every``-th validation one reconstructed val view
        logged as ``recon-val{idx}``. With occupancy both go through the
        live grid, every cell forced occupied inside the warmup as the train
        step does; in single mode through the coarse-only render
        (``make_batched_eval_step_single``, ``render_single``). Returns the
        losses (None without a val split); with ``log=False`` the caller
        logs them."""
        if self.val_scene is None:
            return None
        from minimal_nerf_torch import views

        cfg, val = self.train_config, self.val_scene
        words = None
        if self._occ_cfg is not None:
            from minimal_nerf_torch.ops import occupancy as occ

            words = occ.pack_occupancy(self._grid, self._occ_cfg,
                                       force_all=step < self._occ_cfg.warmup_steps)
        if self._batched_eval is None:
            if self.mode == "single":
                self._batched_eval = loop.make_batched_eval_step_single(
                    self.nerf_config, cfg, loop.scene_static(val), self.mlp_apply)
            else:
                self._batched_eval = loop.make_batched_eval_step(
                    self.nerf_config, cfg, loop.scene_static(val), self.mlp_apply,
                    self.render_fn, self._occ_cfg)
        extra = () if self.mode == "single" else (words,)
        mean = fetch_scalars(self._batched_eval(params, val.images, val.poses, step, cfg.seed,
                                                *extra))
        if log:
            self.logger.log_scalars(step, mean)

        # the validation's index comes from the step, so the cadence holds
        # across resumes; the first validation renders
        val_period = self.steps_per_epoch * max(cfg.check_val_every_n_epoch, 1)
        if (step // val_period - 1) % max(cfg.val_render_every, 1) != 0:
            return mean
        im_idx = int(torch.randint(val.num_frames, (), generator=loop.step_generator(
            cfg.seed, step, _VIEW_STREAM, "cpu")))
        if self._val_render_chunk is None:
            if self.mode == "single":
                def render_chunk_p(p, o, d, generator):
                    return render_single(p, self.nerf_config, o, d, generator,
                                         compute_dtype=cfg.compute_dtype,
                                         mlp_apply=self.mlp_apply)["pred_rgbs"]

                self._val_render_chunk = render_chunk_p
            elif self._occ_cfg is not None:
                self._val_render_chunk = views.make_occ_param_render_chunk(
                    self.nerf_config, self._occ_cfg, cfg.compute_dtype, self.mlp_apply,
                    self.render_fn)
            else:
                self._val_render_chunk = views.make_param_render_chunk(
                    self.nerf_config, cfg.compute_dtype, self.mlp_apply, self.render_fn)
        o, d = val.frame_rays(im_idx)
        im = views.view_reconstruction_with_params(
            self._val_render_chunk, params if words is None else (params, words), o, d,
            chunk=cfg.num_rays, seed=views.mix_seed(cfg.seed, step, _VIEW_RENDER_STREAM))
        self.logger.log_image(f"recon-val{im_idx}", im, step=step)
        return mean

    # ------------------------------------------------------------ checkpoints

    def _check_pending_save(self, wait: bool = False) -> None:
        """Re-raise a failed background save (at the next boundary, or now
        with ``wait``)."""
        fut = self._pending_save
        if fut is not None and (wait or fut.done()):
            self._pending_save = None
            fut.result()

    def save(self, params, opt_state, step: int, blocking: bool = False):
        """Checkpoint the state at ``step`` on the background thread (the
        host copy is taken before this returns); ``blocking`` waits for the
        file. A failed earlier save raises here."""
        self._check_pending_save(wait=blocking)
        path = self.ckpt_dir / ckpt_lib.checkpoint_name(
            self.name, step // self.steps_per_epoch, step)
        fut = ckpt_lib.save_checkpoint_async(
            path, params, opt_state, step, self.nerf_config.to_dict(),
            self.train_config.to_dict(),
            extra=dict({"mode": self.mode}, **(self.field.header() if self.field else {})),
            grid=self._grid)
        self._pending_save = fut
        if blocking:
            self._pending_save = None
            return fut.result()
        return path


def load_state_for_inference(ckpt_path, device="cuda"):
    """``(params, nerf_cfg, train_cfg, grid, step)`` of a checkpoint.

    ``params`` are fp32 tensors on ``device``: ``{"coarse", "fine"}``, or
    one MLP for a ``mode="single"`` checkpoint (JAX
    ``load_state_for_inference``); ``grid`` is an occupancy run's ``[G, G,
    G]`` density EMA (fp32 on ``device``), else None. ``step`` is the save
    step: a checkpoint saved inside the occupancy warmup trained with every
    cell forced occupied, and inference packs its grid the same way.
    """
    dev = resolve_device(device)
    header, leaves = ckpt_lib.load_checkpoint(ckpt_path)
    nerf_cfg = NeRFConfig.from_dict(header["nerf_config"])
    train_cfg = TrainConfig.from_dict(header["train_config"])
    params, _, grid = restore_to_device(header, leaves, nerf_cfg, train_cfg.occupancy_config,
                                        dev)
    return params, nerf_cfg, train_cfg, grid, int(header["step"])


def load_model_for_inference(ckpt_path, device="cuda"):
    """``(params, nerf_cfg, train_cfg)`` of a checkpoint (JAX
    ``load_model_for_inference``, the reference's
    ``NeRFNetwork.load_from_checkpoint``): ``load_state_for_inference``
    without the grid and the step; either mode's checkpoint."""
    params, nerf_cfg, train_cfg, _, _ = load_state_for_inference(ckpt_path, device)
    return params, nerf_cfg, train_cfg
