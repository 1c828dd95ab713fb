"""Train a NeRF on a Blender-style scene tree, or the 2-D image MLP on a photo.

    python -m minimal_nerf_torch.train -n NAME -s STEPS full -b SCENE_DIR [--fast]
    python -m minimal_nerf_torch.train -n NAME -s STEPS single -b SCENE_DIR [-c 128]
    python -m minimal_nerf_torch.train -n NAME -s STEPS simple -i PHOTO.png

The port's counterpart of the JAX package's ``train_nerf.py``, with its
flags and their meaning. ``full``: ``--fast`` (``--occupancy -c 16 -f 48
--steps-per-call 20``, an explicitly passed value winning), the progressive
``--finish-steps`` / ``--budget-schedule`` phases (each later phase goes on
from the previous one's final state in memory), ``--finetune-steps``, the
occupancy flags, and ``--field ngp``: Instant-NGP's hash-grid field
(``models/ngp.py``, L 16, F 2, T 2^19) in both passes in place of the
coarse and fine MLPs, its encoding through the CUDA kernels unless
``--kernel xla``, at its own learning rate (1e-2 decaying to 1e-3); or
``--field tensorf``: TensoRF's VM field (``models/tensorf.py``, 300^3,
16 + 48 components a mode, the box [-1.5, 1.5]^3) likewise, through its
sampling kernels, at TensoRF's learning rates (0.02 on the factors, 1e-3
on the basis and the MLP, decaying to a tenth over 300 epochs) and L1 term;
or ``--field kplanes``: K-Planes' hybrid field (``models/kplanes.py``,
planes of 32 features at 64^2 to 512^2, Instant-NGP's tiny MLPs, the box
[-1.3, 1.3]^3) likewise, through its plane kernels, at K-Planes' learning
rate (0.01 decaying to a tenth over 300 epochs) and TV term on the planes;
each on one device only (``--data-parallel`` above 1 and ``--multihost``
raise). ``single``: one MLP on the coarse-only render at ``-c``
samples (``Trainer(mode="single")``, no crop warmup); ``--kernel pallas``
runs its MLP through the point kernels, any other choice through the plain
MLP, as in JAX. ``simple``: the image MLP overfit to one photo
(``training.simple.train_simple_image``). For every mode ``-l PATH`` / ``-l
auto`` resume (``full``, ``single``), ``--profile DIR`` (a
``torch.profiler`` trace with the program's ``nerf.*`` spans,
``utils.profiling``) and ``--debug-nans``. Runs on ``--device cuda``
(the default; without a card it raises) or ``--device cpu``, where the
kernels run their plain versions. ``--kernel auto`` is ``fused`` on the
card. Not ported, and raising: ``--wandb``. ``--steps-per-call N`` runs N
train steps per call between boundaries (``training.loop.make_multi_step``:
on the card, replays of one captured CUDA graph of the step), as
``train_nerf.py`` does with one dispatch; the steps are those of one per
call, bit for bit.

Data parallel (``full`` and ``single``; ``parallel/``): ``--data-parallel
N`` trains N ranks on this host over ``torch.distributed``, one card each
over NCCL (more cards than are visible raise), or with ``--device cpu`` N
gloo ranks on the CPU; N = 1 runs in this process, N > 1 spawns the ranks.
``--multihost --coordinator HOST:PORT --num-processes K --process-id I``
makes this process rank I of K started elsewhere (one card each; rank 0
listens at the coordinator's address). Every rank draws the whole step and
renders its share of the rays (``training.loop``); rank 0 alone writes the
run directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
from pathlib import Path

from minimal_nerf_torch.models.nerf import NeRFConfig
from minimal_nerf_torch.training.config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a NeRF model")
    subparsers = parser.add_subparsers(dest="type", help="Training different NeRF Versions")
    parser.add_argument("-n", "--name", type=str, required=True,
                        help="name of the model experiment")
    parser.add_argument("-s", "--steps", type=int, default=100000, help="max number of steps")
    parser.add_argument("--gpu", action="store_true",
                        help="accepted for reference-CLI compatibility; --device picks the "
                             "device")
    parser.add_argument("-p", "--position_encoding", type=int, default=10,
                        help="position encoding length")
    parser.add_argument("-d", "--direction_encoding", type=int, default=4,
                        help="direction encoding length")
    parser.add_argument("-rd", "--root_dir", type=str, default="./experiments/",
                        help="directory to save models")
    parser.add_argument("-r", "--rays", type=int, default=4096, help="number of rays per batch")
    parser.add_argument("-l", "--ckpt", type=str, default=None,
                        help="load/resume from checkpoint path, or 'auto' for latest in the "
                             "run dir")
    parser.add_argument("--precision", choices=["bf16", "fp32"], default="bf16",
                        help="matmul compute dtype (params always fp32)")
    parser.add_argument("--data-parallel", type=int, default=0,
                        help="shard the ray batch over this many ranks on this host, one card "
                             "each (gloo ranks with --device cpu); 0 = one device")
    parser.add_argument("--multihost", action="store_true",
                        help="join a multi-process run as one of its ranks "
                             "(torch.distributed); rank 0 owns the checkpoint and metric writes")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="HOST:PORT where rank 0 listens, for --multihost")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="total number of ranks, for --multihost")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank, for --multihost")
    parser.add_argument("--kernel", choices=["auto", "xla", "pallas", "fused"], default="auto",
                        help="compute path: 'xla' = plain PyTorch; 'pallas' = the point-level "
                             "MLP kernels; 'fused' = the fused ray-march kernels; 'auto' = "
                             "fused on the card, xla on the CPU")
    parser.add_argument("--steps-per-call", type=int, default=None,
                        help="fuse N train steps per dispatch: on the card, N replays of "
                             "one captured CUDA graph of the step (default: 1)")
    parser.add_argument("--log-every", type=int, default=100,
                        help="steps between metric fetches/CSV rows")
    parser.add_argument("--val-render-every", type=int, default=1,
                        help="render the validation recon image only every Nth validation "
                             "boundary (val losses always run)")
    parser.add_argument("--wandb", type=str, default=None, metavar="PROJECT",
                        help="Weights & Biases mirror (not ported)")
    parser.add_argument("--debug-nans", action="store_true",
                        help="autograd anomaly detection and a finite check of every call's "
                             "last loss (a host sync per call; a captured step runs without "
                             "anomaly detection)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of the whole run, with "
                             "the program's nerf.* spans, to DIR")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device to train on (default cuda; cpu runs the kernels' plain "
                             "versions)")

    simple_parser = subparsers.add_parser("simple")
    full_parser = subparsers.add_parser("full")
    single_parser = subparsers.add_parser("single")

    full_parser.add_argument("-b", "--base_dir", type=str,
                             default="./data/nerf_synthetic/lego/", help="directory for dataset")
    full_parser.add_argument("-c", "--coarse", type=int, default=None,
                             help="number of coarse samples (default: 64)")
    full_parser.add_argument("-f", "--fine", type=int, default=None,
                             help="number of fine samples (default: 128)")
    full_parser.add_argument("-nr", "--near", type=float, default=2.0,
                             help="near bound for dataset")
    full_parser.add_argument("-fr", "--far", type=float, default=6.0,
                             help="far bound of dataset")
    full_parser.add_argument("-cr", "--cropping_epochs", type=int, default=10,
                             help="num. epochs to crop image for ray sampling.")
    full_parser.add_argument("--fine-sampling", choices=["reference", "linterp"],
                             default="reference",
                             help="in-bin jitter (reference parity) vs linear CDF "
                                  "interpolation")
    full_parser.add_argument("--field", choices=["nerf", "ngp", "tensorf", "kplanes"],
                             default="nerf",
                             help="the radiance field: the coarse and fine NeRF MLPs, or "
                                  "Instant-NGP's hash-grid field, TensoRF's VM field or "
                                  "K-Planes' hybrid field for both passes")
    full_parser.add_argument("--fast", action="store_true",
                             help="the fast recipe in one flag: --occupancy -c 16 -f 48 "
                                  "--steps-per-call 20; explicitly passed values win")
    full_parser.add_argument("--finish-steps", type=int, default=0, metavar="N",
                             help="progressive schedule: train the LAST N steps at "
                                  "--finish-coarse/--finish-fine samples")
    full_parser.add_argument("--finish-coarse", type=int, default=64,
                             help="coarse samples for the --finish-steps phase")
    full_parser.add_argument("--finish-fine", type=int, default=128,
                             help="fine samples for the --finish-steps phase")
    full_parser.add_argument("--budget-schedule", type=str, default=None,
                             metavar="C+F:N[,C+F:N...][,C+F]",
                             help="N-phase sample-budget schedule, each phase "
                                  "'COARSE+FINE:STEPS'; the last may omit ':STEPS' to take "
                                  "the remainder of -s")
    full_parser.add_argument("--finetune-steps", type=int, default=0, metavar="N",
                             help="train exactly N steps past the resumed checkpoint (-l "
                                  "required; -s becomes ckpt_step + N)")
    full_parser.add_argument("--lr-floor", type=float, default=0.0,
                             help="lower bound on the per-epoch exponential LR decay")
    full_parser.add_argument("--occupancy", action=argparse.BooleanOptionalAction,
                             default=None,
                             help="occupancy-grid guided coarse sampling; --no-occupancy "
                                  "overrides the --fast preset")
    full_parser.add_argument("--occ-resolution", type=int, default=64,
                             help="occupancy grid cells per axis")
    full_parser.add_argument("--occ-bound", type=float, default=3.2,
                             help="occupancy grid AABB half-extent (world units)")
    full_parser.add_argument("--occ-threshold", type=float, default=1e-2,
                             help="absolute density threshold for an occupied cell")
    full_parser.add_argument("--occ-rel-threshold", type=float, default=1e-2,
                             help="scene-relative threshold: the cutoff is "
                                  "max(--occ-threshold, REL * mean(ema))")
    full_parser.add_argument("--occ-decay", type=float, default=0.9,
                             help="per-update density EMA decay")
    full_parser.add_argument("--occ-grid-source", default="coarse",
                             choices=("both", "coarse", "fine"),
                             help="which net's density feeds the grid EMA")
    full_parser.add_argument("--occ-probe-method", default="auto",
                             choices=("auto", "gather", "onehot", "pallas"),
                             help="the grid lookup (the same bits whichever: the port probes "
                                  "through its sampler kernel on the card)")
    full_parser.add_argument("--occ-update-every", type=int, default=16,
                             help="train steps between grid EMA updates")
    full_parser.add_argument("--occ-warmup-steps", type=int, default=256,
                             help="steps with every cell forced occupied")
    full_parser.add_argument("--occ-num-bins", type=int, default=64,
                             help="per-ray occupancy probe bins")
    full_parser.add_argument("--occ-floor", type=float, default=0.25,
                             help="sampling weight of unoccupied in-bounds bins")
    full_parser.add_argument("--occ-no-jitter", action="store_true",
                             help="deterministic CDF inverse instead of in-bin jitter")

    single_parser.add_argument("-b", "--base_dir", type=str, default="./dev_data/",
                               help="directory for dataset")
    single_parser.add_argument("-c", "--samples", type=int, default=128,
                               help="number of samples")
    simple_parser.add_argument("-i", "--im_path", type=str,
                               default="./tests/test_data/grad_lounge.png",
                               help="The image path to use as data")
    return parser


def apply_fast_preset(args, parser_defaults) -> None:
    """Expand ``--fast`` into ``--occupancy -c 16 -f 48 --steps-per-call 20``
    (in place). A value passed explicitly wins over the preset, even one
    equal to the normal default (``--fast -c 64``): the parser's ``None``
    sentinels tell them apart. Fields left unset get ``parser_defaults``."""
    if getattr(args, "fast", False):
        preset = {"occupancy": True, "coarse": 16, "fine": 48, "steps_per_call": 20}
        for field, value in preset.items():
            if getattr(args, field) is None:
                setattr(args, field, value)
    for field, value in parser_defaults.items():
        if getattr(args, field) is None:
            setattr(args, field, value)


_FAST_PRESET_DEFAULTS = {"occupancy": False, "coarse": 64, "fine": 128, "steps_per_call": 1}


def parse_budget_schedule(spec: str, total_steps: int):
    """``"C+F:N,...[,C+F]"`` -> ``[(coarse, fine, end_step), ...]``.

    Each phase trains to its cumulative ``end_step``; the last phase may omit
    ``:N`` and takes the remainder of ``total_steps``. The phases must tile
    ``[0, total_steps]`` exactly.
    """
    phases = []
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise SystemExit(f"--budget-schedule: empty schedule {spec!r}")
    end = 0
    for i, part in enumerate(parts):
        budget, sep, n_str = part.partition(":")
        try:
            coarse, fine = (int(x) for x in budget.split("+"))
        except ValueError:
            raise SystemExit(
                f"--budget-schedule: bad phase {part!r} (want COARSE+FINE[:STEPS])") from None
        if sep:
            try:
                n = int(n_str)
            except ValueError:
                raise SystemExit(f"--budget-schedule: bad step count in {part!r}") from None
        elif i == len(parts) - 1:
            n = total_steps - end
        else:
            raise SystemExit(
                f"--budget-schedule: only the LAST phase may omit ':STEPS' (phase {part!r})")
        if n <= 0 or coarse <= 0 or fine < 0:
            raise SystemExit(
                f"--budget-schedule: phase {part!r} resolves to {coarse}+{fine}:{n}; needs "
                "steps>0, coarse>0, fine>=0")
        end += n
        phases.append((coarse, fine, end))
    if end != total_steps:
        raise SystemExit(
            f"--budget-schedule covers {end} steps but -s is {total_steps}; phase step counts "
            "must sum to -s (omit the last ':STEPS' to take the remainder)")
    return phases


def resolve_phases(args):
    """The ``(coarse, fine, end_step)`` phases of a run: ``--budget-schedule``,
    or ``--finish-steps`` (its 2-phase case), or one phase at ``-c``/``-f``."""
    finish = getattr(args, "finish_steps", 0) or 0
    schedule = getattr(args, "budget_schedule", None)
    if schedule and finish:
        raise SystemExit("--finish-steps is the 2-phase shorthand for --budget-schedule; "
                         "pass one or the other")
    if schedule:
        return parse_budget_schedule(schedule, args.steps)
    if finish < 0 or finish >= args.steps:
        raise SystemExit(f"--finish-steps must be in [0, steps); got {finish} of {args.steps}")
    if finish:
        return [(args.coarse, args.fine, args.steps - finish),
                (args.finish_coarse, args.finish_fine, args.steps)]
    return [(args.coarse, args.fine, args.steps)]


def apply_finetune_steps(args) -> None:
    """Resolve ``--finetune-steps N`` into ``-s ckpt_step + N`` (in place),
    from the resumed checkpoint's header (``-l auto``: the run's latest)."""
    finetune = getattr(args, "finetune_steps", 0) or 0
    if not finetune:
        return
    if finetune < 0:
        raise SystemExit(f"--finetune-steps must be positive; got {finetune}")
    if getattr(args, "budget_schedule", None) or getattr(args, "finish_steps", 0):
        raise SystemExit("--finetune-steps is a single-phase resume; it cannot combine with "
                         "--finish-steps/--budget-schedule")
    if not args.ckpt:
        raise SystemExit("--finetune-steps needs a checkpoint to resume (-l PATH or -l auto)")
    from minimal_nerf_torch.training import checkpoint as ckpt_lib

    ckpt = args.ckpt
    if ckpt == "auto":
        ckpt_dir = Path(args.root_dir) / args.name / "checkpoints"
        latest = ckpt_lib.latest_checkpoint(ckpt_dir)
        if latest is None:
            raise SystemExit(f"--finetune-steps with -l auto: no checkpoint found under "
                             f"{ckpt_dir}")
        ckpt = str(latest)
    args.ckpt = ckpt
    args.steps = ckpt_lib.read_header(ckpt)["step"] + finetune


def train_full_nerf(args, mesh=None):
    """Run the phases of a ``full`` run, each a ``Trainer`` (one rank of
    ``mesh`` under data parallel); returns the last."""
    from minimal_nerf_torch import fields, resolve_device
    from minimal_nerf_torch.training.trainer import Trainer

    dev = resolve_device(args.device)
    apply_fast_preset(args, _FAST_PRESET_DEFAULTS)
    apply_finetune_steps(args)
    phases = resolve_phases(args)
    kernel = fields.resolve_kernel(args.kernel, dev)
    nerf_cfg = NeRFConfig(
        position_dim=args.position_encoding, direction_dim=args.direction_encoding,
        coarse_samples=args.coarse, fine_samples=args.fine, near=args.near, far=args.far,
        fine_sampling=args.fine_sampling)
    field = fields.make_field(args.field, nerf_cfg, kernel, dev, ngp={"bound": args.occ_bound})
    train_cfg = TrainConfig(
        num_rays=args.rays, max_steps=args.steps, cropping_epochs=args.cropping_epochs,
        precision=args.precision, seed=args.seed, steps_per_call=args.steps_per_call,
        log_every=args.log_every, val_render_every=args.val_render_every, kernel=kernel,
        occupancy=args.occupancy, occ_resolution=args.occ_resolution,
        occ_bound=args.occ_bound, occ_threshold=args.occ_threshold,
        occ_rel_threshold=args.occ_rel_threshold, occ_decay=args.occ_decay,
        occ_update_every=args.occ_update_every, occ_warmup_steps=args.occ_warmup_steps,
        occ_num_bins=args.occ_num_bins, occ_floor=args.occ_floor,
        occ_in_bin_jitter=not args.occ_no_jitter, occ_grid_source=args.occ_grid_source,
        occ_probe_method=args.occ_probe_method, lr_floor=args.lr_floor, **field.lr)
    # each phase trains to its end step at its own sample budget; phase 1
    # resumes from -l if given, every later phase goes on from the previous
    # phase's final state in memory; fit() does nothing for a phase that a
    # relaunch finds complete
    trainer, common = None, dict(name=args.name, device=dev, mesh=mesh, field=field)
    for coarse, fine, end_step in phases:
        cfgs = (dataclasses.replace(nerf_cfg, coarse_samples=coarse, fine_samples=fine),
                dataclasses.replace(train_cfg, max_steps=end_step))
        if trainer is None:
            trainer = Trainer(*cfgs, args.base_dir, args.root_dir, resume_ckpt=args.ckpt,
                              **common)
        else:
            trainer.logger.close()
            trainer = Trainer(*cfgs, args.base_dir, args.root_dir,
                              initial_state=trainer.final_state, **common)
        trainer.fit()
    return trainer


def train_single_nerf(args, mesh=None):
    """``train single`` (JAX ``train_single_nerf``): one ``Trainer(mode=
    "single")`` at ``-c`` coarse samples, no crop warmup, one step per call
    unless ``--steps-per-call`` says otherwise; returns the Trainer."""
    from minimal_nerf_torch import fields, resolve_device
    from minimal_nerf_torch.training.trainer import Trainer

    dev = resolve_device(args.device)
    kernel = fields.resolve_kernel(args.kernel, dev)
    nerf_cfg = NeRFConfig(position_dim=args.position_encoding,
                          direction_dim=args.direction_encoding, coarse_samples=args.samples)
    train_cfg = TrainConfig(
        num_rays=args.rays, max_steps=args.steps, cropping_epochs=0, precision=args.precision,
        seed=args.seed, steps_per_call=args.steps_per_call or 1, log_every=args.log_every,
        val_render_every=args.val_render_every, kernel=kernel)
    trainer = Trainer(nerf_cfg, train_cfg, args.base_dir, args.root_dir, name=args.name,
                      resume_ckpt=args.ckpt, mode="single", device=dev, mesh=mesh)
    trainer.fit()
    return trainer


def train_simple_image(args):
    """``train simple`` (JAX ``train_simple_image``): the image MLP on the
    photo ``-i``; returns its final parameters."""
    from minimal_nerf_torch.training.simple import train_simple_image as run

    return run(args.im_path, args.root_dir, args.name, args.steps,
               position_dim=args.position_encoding, batch_size=args.rays, seed=args.seed,
               device=args.device)


# simple runs on one device: main refuses a mesh for it
_MODES = {"full": train_full_nerf, "single": train_single_nerf,
          "simple": lambda args, mesh: train_simple_image(args)}


def _train(args, mesh=None):
    """The mode's run on this process (one rank of ``mesh``), inside the
    profiler (rank 0's only) and anomaly mode when asked for."""
    from minimal_nerf_torch.parallel import distributed
    from minimal_nerf_torch.utils import profiling

    with contextlib.ExitStack() as stack:
        if args.profile and distributed.is_primary():
            stack.enter_context(profiling.trace(args.profile))
        if args.debug_nans:
            stack.enter_context(profiling.debug_mode())
        return _MODES[args.type](args, mesh)


def _train_rank(rank: int, args, world: int, coordinator: str):
    """Rank ``rank`` of a ``world``-rank run meeting at ``coordinator``:
    joins the world, trains, leaves it."""
    from minimal_nerf_torch.parallel import distributed, make_mesh

    distributed.initialize(coordinator, world, rank, device=args.device)
    try:
        return _train(args, make_mesh(world, device=args.device))
    finally:
        distributed.shutdown()


def main(argv=None):
    """Parse ``argv`` and train; returns what the mode's function returns
    (``full``: the last phase's ``Trainer``; ``single``: its ``Trainer``;
    ``simple``: the image MLP's parameters), this rank's under
    ``--multihost`` or ``--data-parallel 1``; None when ``--data-parallel
    N > 1`` spawned the ranks."""
    args = build_parser().parse_args(argv)
    if args.type not in _MODES:
        build_parser().error("choose a subcommand: simple | single | full")
    if args.wandb:
        raise NotImplementedError("--wandb is not ported: it needs the wandb package and a "
                                  "network; metrics go to metrics.csv")
    if not (args.multihost or args.data_parallel):
        return _train(args)
    if args.type == "simple":
        raise ValueError("train simple runs on one device: drop --data-parallel/--multihost")
    if args.multihost:
        if args.data_parallel and args.data_parallel != args.num_processes:
            raise ValueError(f"--data-parallel {args.data_parallel} with --multihost: the "
                             f"mesh is the world of --num-processes {args.num_processes}")
        return _train_rank(args.process_id, args, args.num_processes, args.coordinator)
    from minimal_nerf_torch.parallel import distributed, local_devices

    world = args.data_parallel
    local_devices(world, args.device)  # more cards than are visible raise
    coordinator = f"127.0.0.1:{distributed.free_port()}"
    if world == 1:
        return _train_rank(0, args, 1, coordinator)
    import torch.multiprocessing as mp

    mp.spawn(_train_rank, args=(args, world, coordinator), nprocs=world, join=True)
    return None


if __name__ == "__main__":
    main()
