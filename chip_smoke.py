"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

    python3 chip_smoke.py --occ-timing [ROOT]
    python3 chip_smoke.py --path-parity [JSON]
    python3 chip_smoke.py --trajectory
    python3 chip_smoke.py --fault2
    python3 chip_smoke.py --hash-encode
    python3 chip_smoke.py --vm-sample
    python3 chip_smoke.py --tensorf-mlp

Builds every kernel of the serving and training paths from the sources in
the checkout (the fused ray-march forward and backward, the point-level MLP
forward and backward of the ``--kernel pallas`` path, the occupancy grid's
probe and the fused occupancy sampler, the hash encoding's forward and
backward, TensoRF's VM sampling forward and backward and its shading chain's
forward and backward), holds each against its plain
PyTorch version at the main paths' shapes (on weights whose outputs depend
on the input, with bounds shown to reject faulty versions; the probe's bits
and the sampler's weights, times and samples must be identical), then:

- ``[hash-encode]`` holds the hash encoding's kernels against their plain
  versions on the points and feature gradients of one step of the
  ``train.ngp`` cell's program (its coarse and fine launches, 327,680
  points at L 16, F 2, T 2^19), times them beside the plain versions and
  the bytes' bound, reads the backward's ``hash_encode_bwd.merged_share``
  by level from its counted launch, and counts their launches in one
  replayed call of that program (the counters reset just before it) and in
  a profiler trace;
- ``[vm-sample]`` holds TensoRF's VM sampling kernels against their plain
  versions on the points and output gradients of one step of the
  ``train.tensorf`` cell's program (its coarse and fine launches, 327,680
  points at N 300, 16 + 48 components a mode; the forward and its
  density-only launch on the first grid update's points bit for bit, the
  backward within the atomics' tolerance, planted wrong planes rejected),
  times them beside the plain versions and the bytes' bound, and counts
  their launches in one replayed call of that program and in a profiler
  trace;
- ``[tensorf-mlp]`` holds TensoRF's shading kernels (the basis, the
  encodings and the 150-128-128-3 MLP, forward and backward) against the
  plain chain at bf16 (autograd of ``mlp_plain``) on the products,
  directions and color gradients of the same step's coarse and fine
  launches, with a planted fault (an input column dropped) that must fail;
  checks that two backward calls give the same bits; times them beside the
  byte floor, the chain as ``torch`` calls (``library_ms``) and in fp32
  (``plain_ms``); counts their launches in one replayed call (40 and 40) and
  their kernels in a profiler trace of another, with no GEMM or bf16 kernel
  left in the step;
- ``[main]`` renders two 800x800 orbit frames from a full-width checkpoint
  written by the port and checks that the forward kernel carried the render;
- ``[reference]`` holds a small render on the card against the CPU;
- ``[render-cli]`` runs the render CLI (``render.main``) for 4 poses at
  64x64, at ``--frames-per-dispatch`` 8 and 1 (the same bytes), and walks
  the blocks of the gifs it writes;
- ``[train]`` trains 100 full-width steps on a procedural scene made on the
  card, checks the loss falls and the kernels' launch counts, saves a
  checkpoint and renders a frame from it;
- ``[train-reference]`` holds one train step on the card against the same
  step on the CPU;
- ``[train-pallas]`` trains 100 full-width steps through the point kernels
  (``TrainConfig(kernel="pallas")``) on the same scene, checks the loss and
  the launch counts (no fused launch), saves a checkpoint and renders two
  frames from it through ``--kernel auto``, which must pick the point
  kernel;
- ``[pallas-reference]`` holds a small render and one train step of that
  path on the card against the CPU;
- ``[train-occ]`` trains 100 full-width steps of the fast recipe
  (occupancy-guided coarse sampling, 16 + 48 samples, the fused kernels and
  the sampler kernel) on from the ``[train]`` weights, checks the loss, the
  grid updates, the occupied fraction and the launch counts, saves a
  checkpoint with its grid and Adam state and renders two frames from it
  through the grid, one with ``--ignore-occupancy``, and one through a grid
  baked from the ``[train]`` checkpoint;
- ``[occ-reference]`` holds one occupancy step on the card (grid update,
  packed words, loss, gradients, Adam) against the same step on the CPU;
- ``[multi-step]`` runs two calls of 20 steps of ``make_multi_step`` (one
  captured CUDA graph of the step, replayed once per step) for fused bf16,
  pallas bf16 and the fast recipe against as many eager steps: the state
  and last metrics bit-identical, the second call with the device's syncs
  made errors, the launch counters those of one eager step, its capture and
  39 replays of it, the kernels of a third, replayed call counted in a profiler
  trace, the capture's time, the device memory of eager and replayed steps,
  and the replayed call's ms/step beside the eager steps';
- ``[trainer]``, with imageio and PIL hidden, writes the ``[train]`` scene
  (20 train, 2 val and 4 test frames) as a PNG tree and reads it back exactly, then
  runs the train CLI (``train.main``) on it: 220 steps at the production
  defaults with a validation and a save at step 200, a resume with ``-l
  auto`` to step 240, and 200 steps of ``--fast`` at 1 and at 20 steps per
  call (bit-identical runs); it checks the loss, metrics.csv's columns, the
  checkpoints, the val view and every kernel's launches, and prints the
  trainer's ms/step beside ``[train]``'s and ``--fast``'s at 1 and 20;
- ``[data-parallel]`` runs ``train --data-parallel 1`` (NCCL, a world of
  one) 20 steps and 20 more at ``--steps-per-call 20`` against the same
  without the flag (rows and checkpoint bit-identical), two ranks on the
  one card over gloo (10 fp32 steps against one process, with two faulty
  all-reduces that must fail the gate; 20 timed bf16 steps per rank with
  the all-reduce's share; a ``--fast`` run whose grids stay identical
  across the ranks), and ``render``/``score`` at the default
  ``--data-parallel 1`` (each chunk split over a one-card mesh) against
  the checkpoint's unsharded chunk (identical frames and scores);
- ``[score]``, with imageio and PIL hidden, runs the score CLI
  (``score.main``) on that tree's test split for the trainer's 64+128
  checkpoint at ``--frames-per-dispatch`` 1 and 8 (the same scores; the
  card's metrics against the numpy version on the same frames), its
  ``--fast`` checkpoint, the ``[train-pallas]`` one, the ``[train]`` one
  (fused; same init, draws and steps as the pallas one) and the seeded
  init, each by launch count, times a scored frame's sweep and metrics, and runs
  one sweep with its metrics with the device's syncs made errors;
- ``[convert]`` exports the trainer's checkpoint to the reference's
  PyTorch Lightning format and back (``convert_ckpt.main``) and renders the
  same frame from both;
- ``[profile]`` profiles one frame, a 4-frame orbit at
  ``--frames-per-dispatch`` 1 and 8, one train step, one pallas train step,
  one occupancy train step (with the coarse-sampler hook's span), one
  replayed call of 20 occupancy steps and one 16+48 frame through the
  occupancy grid for the kernels' and the idle shares;
- ``[bench]`` runs ``python -m minimal_nerf_torch.bench`` (training rays/s
  of fused 64+128, pallas 64+128 and the fast recipe, 20 replayed steps per
  call) in a process of its own, checks its JSON line and each path's rate,
  loss and launches, and counts the kernels of one replayed call of each
  path in a profiler trace.

``--occ-timing [ROOT]`` instead times the occupancy path alone (steps,
frames, the sampler hook per call, the probe wrapper) for the package under
ROOT, this checkout by default: run on this checkout and on an older one
unpacked inside the repo, in turns, it compares the two in one call.
``--path-parity`` measures where the fused and the pallas train paths part;
``--trajectory`` trains the multiframe arm of
``experiments/r5-parity/trajectory_parity.py`` and holds its PSNR against
the recorded JAX runs; ``--fault2`` decides ROADMAP Queue 3 fault 2 with a
paired test over 8 seeds at 1,000 steps; ``--hash-encode`` and
``--vm-sample`` and ``--tensorf-mlp`` run the ``[hash-encode]``,
``[vm-sample]`` or ``[tensorf-mlp]`` phase alone and print its kernels' line.

Prints one line per phase, the card's name and power limit, a JSON line of
kernel timings, and as its last line ``{"ok": true, "device": {...}}``.
Exits non-zero without a card or when any phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from nerfbench import counts as model_counts

KERNELS = ["fused_raymarch_fwd", "fused_raymarch_bwd", "raymarch_mlp_fwd", "raymarch_mlp_bwd",
           "occupancy_probe", "occupancy_sampler"]
HASH_KERNELS = ["hash_encode_fwd", "hash_encode_bwd"]  # the ngp field's
VM_KERNELS = ["vm_sample_fwd", "vm_sample_bwd"]        # the tensorf field's
MLP_KERNELS = ["tensorf_mlp_fwd", "tensorf_mlp_bwd"]    # its shading chain
RAYS = 4096
SAMPLES = (64, 192)       # coarse pass, then the 64 + 128 sorted union
HW = 800                  # frame height and width
POSES = 2
PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12         # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# The kernel check's weights: He-uniform (bound sqrt(6/fan_in)), so the
# activations keep their scale through the ReLU layers and color and weights
# vary with the input; the nn.Linear-style init leaves them near constants.
HE_GAIN = math.sqrt(6.0)
# kernel vs plain version, (atol, rtol, mean_rtol): every element within
# |k - p| <= atol + rtol * |p|, and mean |k - p| <= mean_rtol * mean |p|.
# fp32: both sides round nowhere but sum 256-term dot products in another
#   order (FMA chains vs cuBLAS), through 10 layers and exp() of the
#   transmittance prefix;
# bf16: every activation is rounded to bf16 (relative step 2^-8). Another
#   fp32 summation order now and then moves a pre-activation across a
#   rounding boundary; through the He weights one such flip moves a sample's
#   outputs by up to ~0.3% (max |k - p| 1.6e-3 on an H100). The element
#   bound admits those rare flips; the mean bound holds the rest tight.
TOL = {"fp32": (1e-5, 1e-4, 1e-5), "bf16": (3e-3, 3e-3, 1e-3)}
# the point kernel, per output (sigma, rgb): fp32 as above; bf16 outputs are
# per point, with no compositing to average a flipped rounding away, and
# sigma = relu(h . dw + db) is linear in the 256 bf16-rounded h values (an
# h near 8 moves by 2^-5 when its rounding flips). H100 readings over
# 4096 x 64 and 4096 x 192 points: max |k - p| sigma 2.6e-2, rgb 7.3e-3,
# mean |k - p| 6.4e-5 and 1.6e-5. The element bounds sit 2.3x / 2.7x above
# the worst flip; the mean bounds (~30x above) keep flips rare.
POINT_TOL = {"fp32": (TOL["fp32"], TOL["fp32"]),
             "bf16": ((6e-2, 1e-2, 1e-3), (2e-2, 3e-3, 1e-3))}
# the element bound (at the outputs' median) must sit SEP_MAX times and the
# mean bound SEP_MEAN times below the outputs' spread (std), or the
# comparison could not see a fault
SEP_MAX, SEP_MEAN = 3, 100


@contextlib.contextmanager
def uncounted():
    """Launches inside do not count: the counters (``utils.profiling``) are
    restored after (nothing is restored for a package without them:
    ``--occ-timing`` may time an older checkout)."""
    from minimal_nerf_torch.utils import profiling

    saved = profiling.counters() if hasattr(profiling, "counters") else None
    try:
        yield
    finally:
        if saved is not None:
            profiling.reset()
            for name, n in saved.items():
                profiling.count(name, n)


def launched(name: str) -> int:
    """The launch counter ``name`` (a wrapper module's ``*LAUNCHES``)."""
    from minimal_nerf_torch.utils import profiling

    return profiling.counter(name)


def point_hook(device):
    """A fresh MLP hook of the point kernels (``--kernel pallas``)."""
    from minimal_nerf_torch import fields

    return fields.kernel_hooks("pallas", device)[0]


COUNTED = "fused fwd, bwd, point fwd, bwd, probe, sampler"


def counts():
    """(fused forward, fused backward, point forward, point backward, probe,
    sampler) launches (``COUNTED``)."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import occupancy_probe as op
    from minimal_nerf_torch.kernels import occupancy_sampler as osk
    from minimal_nerf_torch.kernels import raymarch as rm

    return tuple(launched(n) for n in (fr.FWD_LAUNCHES, fr.BWD_LAUNCHES, rm.FWD_LAUNCHES,
                                       rm.BWD_LAUNCHES, op.LAUNCHES, osk.LAUNCHES))


def reset_counts():
    from minimal_nerf_torch.utils import profiling

    profiling.reset()


@contextlib.contextmanager
def wrapped(module, name: str, around):
    """``module.name`` replaced by ``around(original)`` inside."""
    orig = getattr(module, name)
    setattr(module, name, around(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


# the kernel each counted wrapper launches once per call, as the profiler
# names it (``COUNTED`` order)
COUNTED_KERNELS = ("fused_fwd_", "fused_bwd_kernel", "points_fwd_", "points_bwd_kernel",
                   "probe_kernel", "sampler_kernel")


@contextlib.contextmanager
def graph_calls():
    """Inside, tally the CUDA graphs of train steps (``training.loop
    ._StepGraph``): ``{"captures", "replays", "capture_s"}``, the last the
    host seconds of each capture (the graph's instantiation included, the
    device idle before it). A wrapper counts a launch where it records it
    into a capture; a replay runs every recorded launch and no wrapper, and
    adds the capture's counts again (``training.loop._StepGraph``); the
    kernels a replay ran are also counted in a trace (``traced_launches``)."""
    from minimal_nerf_torch.training import loop

    seen = {"captures": 0, "replays": 0, "capture_s": []}

    def around_capture(capture):
        def timed(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            capture(self, *args, **kwargs)
            seen["capture_s"].append(time.perf_counter() - t0)
            seen["captures"] += 1
        return timed

    def around_replay(replay):
        def tallied(self):
            replay(self)
            seen["replays"] += 1
        return tallied

    with wrapped(loop._StepGraph, "_capture", around_capture), \
            wrapped(torch.cuda.CUDAGraph, "replay", around_replay):
        yield seen


def traced_launches(fn, tries: int = 3):
    """The launches of the counted kernels (``COUNTED`` order) that one call
    of ``fn`` ran on the card: the kernels named ``COUNTED_KERNELS`` in a
    ``torch.profiler`` trace of the call (CUPTI records the kernels of a
    CUDA-graph replay). A trace with no device activity at all is taken
    again with another call, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with uncounted(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return tuple(sum(key in name for name in names) for key in COUNTED_KERNELS)
    raise AssertionError(f"the profiler recorded no device activity in {tries} traces")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_spans(fn, reps: int, tries: int = 3):
    """(name, µs) of the device activity (kernels, copies, fills) that
    ``reps`` calls of ``fn`` record under ``torch.profiler``, after one
    call outside it. The profiler now and then records no device activity
    at all; such a capture is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with uncounted(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return spans
    raise AssertionError(f"the profiler recorded no device activity in {tries} captures")


def device_ms(fn, reps: int = 50) -> float:
    """The device time of one call of ``fn``: the summed durations of its
    device activity over ``reps`` calls, over ``reps``. For calls so short
    that CUDA events around back-to-back calls time the host's launch
    rate."""
    return sum(us for _, us in device_spans(fn, reps)) / 1e3 / reps


def device_split(fn, keys, reps: int = 3):
    """The device time of one call of ``fn`` by kernel: for each key, the
    summed durations of the device activity whose name contains it, over
    ``reps`` calls, over ``reps`` (ms)."""
    spans = device_spans(fn, reps)
    return {k: sum(us for name, us in spans if any(x in name for x in key)) / 1e3 / reps
            for k, key in keys.items()}


# the backwards' three parts by kernel name: A (per ray group or point
# tile), B (the weight products, and the fused backward's bias sums), R (the
# fixed-order sums of the slices' products and of the rows of bias sums)
BWD_PARTS = {"fused": {"A": ("fused_bwd_kernel",), "B": ("wgrad_",),
                       "R": ("reduce_slices", "reduce_rows")},
             "point": {"A": ("points_bwd_kernel",), "B": ("wgrad_",),
                       "R": ("reduce_slices", "reduce_rows")}}
SCRATCH_CHANNELS = 3944   # the backwards' scratch channels per point
MASK_BYTES = 52 * 4       # the fused backward's ReLU mask bits per point


def scratch_floor(points: int, elem: int, masks: bool):
    """(bytes of scratch a backward writes and reads again per call, their
    least time in ms at HBM_BYTES_PER_S): each byte written once and read
    once."""
    per_point = SCRATCH_CHANNELS * elem + (MASK_BYTES if masks else 0)
    total = 2 * points * per_point
    return total, 1e3 * total / HBM_BYTES_PER_S


# the published MLP at the package's depth, as ``nerfbench/counts.py`` counts it
NERF_MLP = {"position_dim": 10, "direction_dim": 4, "width": 256, "rgb_width": 128,
            "trunk_layers": 4, "feature_layers": 3}


def bound_ms(fm, n: int, s: int, peak: float, macs: int = 0, io_floats: int = 0):
    """(least time in ms, what bounds it) for one pass of n rays x s samples:
    the forward by default, else ``macs`` per point and ``io_floats`` fp32
    values in and out besides the weights."""
    ops = 2.0 * (macs or model_counts.fwd_macs(NERF_MLP)) * n * s
    weight_bytes = sum(w.numel() * w.element_size() for w in fm.ws + fm.bs)
    io_bytes = 4 * (io_floats or (n * 3 * 2 + n * s) + (n * 3 + n * s))
    t_ops, t_bytes = ops / peak, (weight_bytes + io_bytes) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_report(name: str, entry: str) -> str:
    """Registers and spills of the kernel entry whose name contains
    ``entry`` in this run's build of ``csrc/<name>.cu`` (ptxas -v)."""
    from minimal_nerf_torch.kernels import build

    lines = build.BUILD_LOGS.get(name, "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            regs = spill = "?"
            for nxt in lines[i + 1:i + 5]:
                if "spill" in nxt:
                    spill = nxt.split(",", 1)[1].strip()
                if "registers" in nxt:
                    regs = nxt.split("Used", 1)[1].split("registers")[0].strip()
            return f"{entry}: {regs} registers at launch, {spill}"
    return f"{entry}: not built in this run"


def sample_rays(n: int, s: int, gen: torch.Generator, dev):
    """Rays of an orbit view (the main path's geometry) and sorted times."""
    from minimal_nerf_torch.ops import cameras

    pose = torch.as_tensor(cameras.pose_spherical(30.0, -30.0, 4.0), device=dev)
    flat = torch.randint(0, HW * HW, (n,), generator=gen, device=dev)
    focal = cameras.focal_from_angle(HW, 0.6911112070083618)
    o, d = cameras.rays_for_pixels((flat % HW).float(), (flat // HW).float(), HW, HW,
                                   focal, pose)
    ts = torch.sort(2.0 + 4.0 * torch.rand((n, s), generator=gen, device=dev), dim=1).values
    return o.contiguous(), d.contiguous(), ts.contiguous()


def errors(k: torch.Tensor, p: torch.Tensor, tol):
    """(max |k - p|, mean |k - p|, within both bounds of ``tol``)."""
    atol, rtol, mean_rtol = tol
    diff = (k - p).abs()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    ok = (bool((diff <= atol + rtol * p.abs()).all().item())
          and mean_abs <= mean_rtol * p.abs().mean().item() and bool(torch.isfinite(k).all()))
    return max_abs, mean_abs, ok


def mutants(fm):
    """The plain version with one deliberate fault each; the comparison must
    reject every one of them."""
    def with_w(i, w):
        ws = list(fm.ws)
        ws[i] = w
        return fm._replace(ws=ws)

    return {
        "skip concat dropped": with_w(5, torch.zeros_like(fm.ws[5])),
        "trunk[2] transposed": with_w(2, fm.ws[2].t().contiguous()),
        "direction encoding dropped": with_w(10, torch.zeros_like(fm.ws[10])),
        "bf16 rounding points swapped": fm._replace(
            dtype=None if fm.dtype else torch.bfloat16),
    }


def library_chain(fm, n: int, s: int, dev):
    """The MLP's matmuls as a chain of torch.matmul calls (cuBLAS) at the
    pass's shapes: the yardstick, never used by the port."""
    dtype = fm.dtype or torch.float32
    rows = n * s
    ws = [w.to(dtype) for w in fm.ws]
    e = torch.randn(rows, ws[0].shape[0], device=dev, dtype=dtype)
    ed = torch.randn(rows, ws[10].shape[0], device=dev, dtype=dtype)

    def run():
        a = e @ ws[0]
        for w in ws[1:4]:
            a = a @ w
        a = a @ ws[4] + e @ ws[5]
        a = a @ ws[6]
        h = a @ ws[7]
        h @ ws[8]
        r = h @ ws[9] + ed @ ws[10]
        return r @ ws[11]

    return run


def phase_kernels(dev, report):
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.models.mlp import init_nerf_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_nerf_mlp(gen, device=dev, gain=HE_GAIN)
    ok_all = True
    for prec, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        fm = fr.prepare_fused_mlp(params, dtype)
        for s in SAMPLES:
            o, d, ts = sample_rays(RAYS, s, gen, dev)
            kc, kw = fr.fused_forward(fm, o, d, ts)
            pc, pw = fr.fused_forward_plain(fm, o, d, ts)
            torch.cuda.synchronize()
            tol = atol, rtol, mean_rtol = TOL[prec]
            ca, cm, cok = errors(kc, pc, tol)
            wa, wm, wok = errors(kw, pw, tol)
            # the comparison can see a fault: its bounds sit far below the
            # outputs' spread, and every faulty plain version fails them
            spread = [p.std().item() for p in (pc, pw)]
            max_at = [atol + rtol * p.abs().median().item() for p in (pc, pw)]
            mean_at = [mean_rtol * p.abs().mean().item() for p in (pc, pw)]
            sep_ok = all(SEP_MAX * a <= sp and SEP_MEAN * m <= sp
                         for a, m, sp in zip(max_at, mean_at, spread))
            missed = [name for name, bad in mutants(fm).items()
                      if all(errors(b, p, tol)[2] for b, p in
                             zip(fr.fused_forward_plain(bad, o, d, ts), (pc, pw)))]
            print(f"[kernel] {prec} S={s}: spread (std) color={spread[0]:.3e} "
                  f"weights={spread[1]:.3e}; element bound at the median color={max_at[0]:.3e} "
                  f"weights={max_at[1]:.3e} (need {SEP_MAX}x below), mean bound color="
                  f"{mean_at[0]:.3e} weights={mean_at[1]:.3e} (need {SEP_MEAN}x below); "
                  f"faulty plain versions passed: {missed or 'none'} "
                  f"{'PASS' if sep_ok and not missed else 'FAIL'}", flush=True)
            ms = cuda_ms(lambda: fr.fused_forward(fm, o, d, ts))
            plain_ms = cuda_ms(lambda: fr.fused_forward_plain(fm, o, d, ts))
            lib_ms = cuda_ms(library_chain(fm, RAYS, s, dev))
            b_ms, b_by = bound_ms(fm, RAYS, s, PEAK_BF16 if dtype else PEAK_FP32)
            ok_all &= cok and wok and sep_ok and not missed
            entry = "fused_fwd_sm90" if dtype else "fused_fwd_kernel"
            print(f"[kernel] {prec} N={RAYS} S={s}: color max_abs={ca:.3e} mean_abs={cm:.3e} "
                  f"weights max_abs={wa:.3e} mean_abs={wm:.3e} (tol atol={atol} rtol={rtol} "
                  f"mean_rtol={mean_rtol}) {'PASS' if cok and wok else 'FAIL'}; ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
                  f"({b_by}), {100 * b_ms / ms:.1f}% of the bound's rate; "
                  f"{ptxas_report('fused_raymarch_fwd', entry)}", flush=True)
            report[(prec, s)] = dict(err=max(ca, wa), ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    if not ok_all:
        raise AssertionError("kernel disagrees with its plain version")


# backward kernel vs plain version, per gradient leaf: (max_rtol, mean_rtol)
# with max |k - p| <= max_rtol * max |p| and mean |k - p| <= mean_rtol *
# mean |p|. fp32: other sum orders only, but each gradient sums up to 786k
# points' products of both signs, and a pre-activation within an ulp of 0
# can take the other side of its ReLU mask, moving one point's product
# (H100 readings at N=4096, worst over the leaves: max 8.1e-4, mean
# 2.1e-4). bf16: another fp32 sum order flips the bf16 rounding of some
# activations; downstream 5-10% of the bf16 gradient activations round to
# the other neighbour (a 2^-8 step each), and the weight gradients sum many
# such flips (H100 readings: max 1.2e-2, mean 7.7e-3). The bounds sit 2.4x
# to 3.7x above the readings; every faulty plain version fails them.
BWD_TOL = {"fp32": (3e-3, 5e-4), "bf16": (3e-2, 2e-2)}
# the point backward, per leaf: bf16 as the fused backward (H100 readings
# max 1.4e-2, mean 8.7e-3); fp32 is wider because its check draws dsig and
# drgb N(0, 1) at every point, so each gradient sums 786k products of mixed
# sign and the cancellation magnifies the sum-order differences (readings
# max 1.7e-3, mean 7.1e-4 of the leaf's max / mean; the bounds sit 2.8x
# above them and >= 12x below every leaf's spread)
POINT_BWD_TOL = {"fp32": (5e-3, 2e-3), "bf16": BWD_TOL["bf16"]}
# the grid update, card vs CPU in bf16 (max |d|, mean |d|) as shares of the
# grid's largest density, and the share of packed words that may differ
# (cells whose density lies within a bf16 rounding flip of the threshold).
# Another fp32 sum order flips the bf16 rounding of a few activations, which
# moves a few cells' densities (H100 readings on the trained weights at
# G=64: max 4.3e-4, mean 2.6e-8, 0 of 8,192 words, the same in every run).
# The max bound is one bf16 step (2^-8) of the largest density, 9x above its
# reading; the mean's admits ~600 such cells, 38x above; the words' admits
# 8 words. An update in fp32 or with decay 1.0 fails them (checked).
OCC_GRID_TOL = (4e-3, 1e-6)
OCC_WORDS_TOL = 1e-3


def bwd_errors(k, p):
    """Per leaf (max |k - p| / max |p|, mean |k - p| / mean |p|, max |k - p|)."""
    out = []
    for a, b in zip(k, p):
        diff = (a - b).abs()
        out.append((diff.max().item() / (b.abs().max().item() + 1e-30),
                    diff.mean().item() / (b.abs().mean().item() + 1e-30), diff.max().item()))
    return out


def bwd_within(errs, tol) -> bool:
    return all(mx <= tol[0] and mn <= tol[1] for mx, mn, _ in errs)


def bwd_mutants(fr, fm):
    """Plain backwards with one fault each; every one must fail the bounds."""
    def inclusive_suffix(*args):
        orig = fr._suffix_sum
        fr._suffix_sum = lambda x: orig(x) + x
        try:
            return fr.fused_backward_plain(*args)
        finally:
            fr._suffix_sum = orig

    ws = list(fm.ws)
    ws[5] = torch.zeros_like(ws[5])
    return {"inclusive suffix sum": (inclusive_suffix, fm),
            "skip concat's encoding term dropped": (fr.fused_backward_plain,
                                                    fm._replace(ws=ws))}


def library_bwd_chain(fm, n: int, s: int, dev):
    """The backward's matmuls as torch.matmul calls (cuBLAS): the forward
    chain again, the activation gradients and the weight gradients, at the
    pass's shapes. The yardstick, never used by the port."""
    dtype = fm.dtype or torch.float32
    rows = n * s
    ws = [w.to(dtype) for w in fm.ws]
    fwd = library_chain(fm, n, s, dev)
    acts = {k: torch.randn(rows, c, device=dev, dtype=dtype)
            for k, c in (("e", ws[0].shape[0]), ("ed", ws[10].shape[0]), ("a", 256),
                         ("r0", 128))}
    g256 = torch.randn(rows, 256, device=dev, dtype=dtype)
    g128 = torch.randn(rows, 128, device=dev, dtype=dtype)
    g3 = torch.randn(rows, 3, device=dev, dtype=dtype)

    def run():
        fwd()
        g = g3 @ ws[11].t()
        g = g @ ws[9].t()
        for i in (7, 6, 4, 3, 2, 1):
            g = g @ ws[i].t()
        a, e, ed, r0 = acts["a"].t(), acts["e"].t(), acts["ed"].t(), acts["r0"].t()
        for x, gg in ((e, g256), (a, g256), (a, g256), (a, g256), (a, g256), (e, g256),
                      (a, g256), (a, g256), (a, g3[:, :1]), (a, g128), (ed, g128), (r0, g3)):
            x @ gg

    return run


def phase_kernel_bwd(dev, report):
    """The backward kernel against its plain version at full width, N=4096,
    S=64 (with a weights cotangent) and S=192 (without, as in training),
    fp32 and bf16, on He-uniform weights; mutants; bitwise determinism;
    times."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.models.mlp import init_nerf_mlp

    gen = torch.Generator(device=dev).manual_seed(3)
    params = init_nerf_mlp(gen, device=dev, gain=HE_GAIN)
    ok_all = True
    for prec, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        fm = fr.prepare_fused_mlp(params, dtype)
        tol = BWD_TOL[prec]
        for s in SAMPLES:
            o, d, ts = sample_rays(RAYS, s, gen, dev)
            dc = torch.randn((RAYS, 3), generator=gen, device=dev)
            dw = (0.1 * torch.randn((RAYS, s), generator=gen, device=dev)
                  if s == SAMPLES[0] else None)
            args = (fm, o, d, ts, dc, dw)
            kw, kb = fr.fused_backward(*args)
            again = fr.fused_backward(*args)
            plain = fr.fused_backward_plain(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(kw + kb, again[0] + again[1]))
            errs = bwd_errors(kw + kb, plain[0] + plain[1])
            within = bwd_within(errs, tol)
            # the bounds against each leaf's spread (std): how far below it
            # they sit, at the least separated leaf
            seps = [(p.std().item() / (tol[0] * p.abs().max().item()),
                     p.std().item() / (tol[1] * p.abs().mean().item()))
                    for p in plain[0] + plain[1] if p.numel() > 1]
            missed = []
            for name, (fn, bad) in bwd_mutants(fr, fm).items():
                bw, bb = fn(bad, o, d, ts, dc, dw)
                if bwd_within(bwd_errors(bw + bb, plain[0] + plain[1]), tol):
                    missed.append(name)
            ms = cuda_ms(lambda: fr.fused_backward(*args), warmup=1, reps=3)
            parts = device_split(lambda: fr.fused_backward(*args), BWD_PARTS["fused"])
            plain_ms = cuda_ms(lambda: fr.fused_backward_plain(*args), warmup=1, reps=3)
            lib_ms = cuda_ms(library_bwd_chain(fm, RAYS, s, dev), warmup=1, reps=3)
            io = RAYS * 3 * 3 + RAYS * s * (2 if dw is not None else 1) + sum(
                w.numel() for w in fm.ws + fm.bs)
            b_ms, b_by = bound_ms(fm, RAYS, s, PEAK_BF16 if dtype else PEAK_FP32,
                                  macs=model_counts.kernel_bwd_macs(NERF_MLP),
                                  io_floats=io)
            sc_bytes, floor_ms = scratch_floor(RAYS * s, 2 if dtype else 4, masks=True)
            # kernel A alone: the forward recomputed and the activation
            # gradients (the weight products, kernel B's, equal the forward's
            # multiply-adds) against its stores, the scratch and mask words
            a_ms, a_by = bound_ms(fm, RAYS, s, PEAK_BF16 if dtype else PEAK_FP32,
                                  macs=model_counts.kernel_bwd_macs(NERF_MLP)
                                  - model_counts.fwd_macs(NERF_MLP),
                                  io_floats=(sc_bytes // 2) // 4)
            a_entry = "fused_bwd_kernel_sm90" if dtype else "fused_bwd_kernelIf"
            ok = within and same and not missed
            ok_all &= ok
            print(f"[kernel-bwd] {prec} N={RAYS} S={s} "
                  f"dweights={'yes' if dw is not None else 'no'}: "
                  f"22 leaves, worst over the leaves max_rel={max(e[0] for e in errs):.3e} "
                  f"mean_rel={max(e[1] for e in errs):.3e} (bounds {tol[0]} / {tol[1]}); "
                  f"max_abs={max(e[2] for e in errs):.3e}; leaf spread (std) over the "
                  f"element bound >= {min(x for x, _ in seps):.2f}x, over the mean bound >= "
                  f"{min(y for _, y in seps):.1f}x; two launches bit-identical: {same}; "
                  f"faulty plain versions passed: {missed or 'none'}; ms={ms:.4f} "
                  f"(device A={parts['A']:.4f} B={parts['B']:.4f} R={parts['R']:.4f}) "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
                  f"({b_by}); scratch and masks {sc_bytes / 1e9:.3f} GB written and read, "
                  f"byte floor {floor_ms:.4f} ms; A's bound {a_ms:.4f} ms ({a_by}), A at "
                  f"{100 * a_ms / parts['A']:.1f}% of its rate; "
                  f"{ptxas_report('fused_raymarch_bwd', a_entry)}; "
                  f"{ptxas_report('fused_raymarch_bwd', 'wgrad_mma_kernel')} "
                  f"{'PASS' if ok else 'FAIL'}", flush=True)
            report[("bwd", prec, s)] = dict(err=max(e[2] for e in errs), ms=ms,
                                            plain_ms=plain_ms, library_ms=lib_ms,
                                            bound_ms=b_ms, bound_by=b_by)
            del kw, kb, again, plain
            torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("backward kernel disagrees with its plain version")


def point_inputs(n: int, s: int, gen, dev):
    """The point kernels' inputs for n rays x s samples of an orbit view:
    positions / pi and unit directions ``[n*s, 3]``, made by the hook's own
    prologue (``raymarch.point_inputs``)."""
    from minimal_nerf_torch.kernels import raymarch as rm

    o, d, ts = sample_rays(n, s, gen, dev)
    return rm.point_inputs(o[:, None, :] + ts[..., None] * d[:, None, :], d)


def phase_kernel_mlp(dev, report):
    """The point forward kernel against ``points_forward_plain`` at full
    width, P = 4096 x 64 and 4096 x 192, fp32 and bf16, on He-uniform
    weights, with the forward kernel's bounds (same MLP, same rounding
    points, other sum orders); mutants; times."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import raymarch as rm
    from minimal_nerf_torch.models.mlp import init_nerf_mlp

    gen = torch.Generator(device=dev).manual_seed(5)
    params = init_nerf_mlp(gen, device=dev, gain=HE_GAIN)
    ok_all = True
    for prec, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        fm = fr.prepare_fused_mlp(params, dtype)
        for s in SAMPLES:
            x, d = point_inputs(RAYS, s, gen, dev)
            ks, kr = rm.points_forward(fm, x, d)
            ps, pr = rm.points_forward_plain(fm, x, d)
            torch.cuda.synchronize()
            tols = POINT_TOL[prec]
            sa, sm, sok = errors(ks, ps, tols[0])
            ra, rmean, rok = errors(kr, pr, tols[1])
            spread = [q.std().item() for q in (ps, pr)]
            max_at = [t[0] + t[1] * q.abs().median().item() for t, q in zip(tols, (ps, pr))]
            mean_at = [t[2] * q.abs().mean().item() for t, q in zip(tols, (ps, pr))]
            sep_ok = all(SEP_MAX * a <= sp and SEP_MEAN * m <= sp
                         for a, m, sp in zip(max_at, mean_at, spread))
            missed = [name for name, bad in mutants(fm).items()
                      if all(errors(b, q, t)[2] for b, q, t in
                             zip(rm.points_forward_plain(bad, x, d), (ps, pr), tols))]
            ms = cuda_ms(lambda: rm.points_forward(fm, x, d))
            plain_ms = cuda_ms(lambda: rm.points_forward_plain(fm, x, d))
            lib_ms = cuda_ms(library_chain(fm, RAYS, s, dev))
            # bytes: x and d in, sigma and rgb out, 10 floats per point
            b_ms, b_by = bound_ms(fm, RAYS, s, PEAK_BF16 if dtype else PEAK_FP32,
                                  io_floats=10 * RAYS * s)
            ok = sok and rok and sep_ok and not missed
            ok_all &= ok
            entry = "points_fwd_sm90" if dtype else "points_fwd_kernel"
            print(f"[kernel-mlp] {prec} P={RAYS}x{s}: sigma max_abs={sa:.3e} mean_abs={sm:.3e} "
                  f"(tol atol/rtol/mean_rtol {tols[0]}) rgb max_abs={ra:.3e} mean_abs="
                  f"{rmean:.3e} (tol {tols[1]}); spread (std) sigma={spread[0]:.3e} rgb="
                  f"{spread[1]:.3e}, element bound at the median sigma={max_at[0]:.3e} rgb="
                  f"{max_at[1]:.3e} (need {SEP_MAX}x below), mean bound sigma={mean_at[0]:.3e} "
                  f"rgb={mean_at[1]:.3e} (need {SEP_MEAN}x below); faulty plain versions "
                  f"passed: {missed or 'none'}; ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}), "
                  f"{100 * b_ms / ms:.1f}% of the bound's rate; "
                  f"{ptxas_report('raymarch_mlp_fwd', entry)} "
                  f"{'PASS' if ok else 'FAIL'}", flush=True)
            report[("mlp", prec, s)] = dict(err=max(sa, ra), ms=ms, plain_ms=plain_ms,
                                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            del ks, kr, ps, pr
            torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("point forward kernel disagrees with its plain version")


def phase_kernel_mlp_bwd(dev, report):
    """The point backward kernel against ``points_backward_plain`` per leaf,
    at full width, P = 4096 x 64 and 4096 x 192, fp32 and bf16, within
    POINT_BWD_TOL; mutants; bitwise determinism; times."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import raymarch as rm
    from minimal_nerf_torch.models.mlp import init_nerf_mlp

    gen = torch.Generator(device=dev).manual_seed(6)
    params = init_nerf_mlp(gen, device=dev, gain=HE_GAIN)
    ok_all = True
    for prec, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        fm = fr.prepare_fused_mlp(params, dtype)
        tol = POINT_BWD_TOL[prec]
        for s in SAMPLES:
            x, d = point_inputs(RAYS, s, gen, dev)
            dsig = torch.randn((RAYS * s, 1), generator=gen, device=dev)
            drgb = torch.randn((RAYS * s, 3), generator=gen, device=dev)
            args = (fm, x, d, dsig, drgb)
            kw, kb = rm.points_backward(*args)
            again = rm.points_backward(*args)
            plain = rm.points_backward_plain(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(u, v) for u, v in zip(kw + kb, again[0] + again[1]))
            errs = bwd_errors(kw + kb, plain[0] + plain[1])
            within = bwd_within(errs, tol)
            seps = [(q.std().item() / (tol[0] * q.abs().max().item()),
                     q.std().item() / (tol[1] * q.abs().mean().item()))
                    for q in plain[0] + plain[1] if q.numel() > 1]
            ws = list(fm.ws)
            ws[5] = torch.zeros_like(ws[5])
            missed = [name for name, bad in (
                ("skip concat's encoding term dropped",
                 rm.points_backward_plain(fm._replace(ws=ws), x, d, dsig, drgb)),
                ("dsigma ignored", rm.points_backward_plain(fm, x, d, torch.zeros_like(dsig),
                                                            drgb)))
                if bwd_within(bwd_errors(bad[0] + bad[1], plain[0] + plain[1]), tol)]
            ms = cuda_ms(lambda: rm.points_backward(*args), warmup=1, reps=3)
            parts = device_split(lambda: rm.points_backward(*args), BWD_PARTS["point"])
            plain_ms = cuda_ms(lambda: rm.points_backward_plain(*args), warmup=1, reps=3)
            lib_ms = cuda_ms(library_bwd_chain(fm, RAYS, s, dev), warmup=1, reps=3)
            # bytes: x, d, dsig, drgb in, the 22 gradients out
            io = RAYS * s * 10 + sum(w.numel() for w in fm.ws + fm.bs)
            b_ms, b_by = bound_ms(fm, RAYS, s, PEAK_BF16 if dtype else PEAK_FP32,
                                  macs=model_counts.kernel_bwd_macs(NERF_MLP),
                                  io_floats=io)
            sc_bytes, floor_ms = scratch_floor(RAYS * s, 2 if dtype else 4, masks=False)
            ok = within and same and not missed
            ok_all &= ok
            print(f"[kernel-mlp-bwd] {prec} P={RAYS}x{s}: 22 leaves, worst over the leaves "
                  f"max_rel={max(e[0] for e in errs):.3e} mean_rel={max(e[1] for e in errs):.3e} "
                  f"(bounds {tol[0]} / {tol[1]}); max_abs={max(e[2] for e in errs):.3e}; biases "
                  f"worst max_rel={max(e[0] for e in errs[12:]):.3e}; leaf spread (std) over the "
                  f"element bound >= {min(a for a, _ in seps):.2f}x, over the mean bound >= "
                  f"{min(b for _, b in seps):.1f}x; two launches bit-identical: {same}; faulty "
                  f"plain versions passed: {missed or 'none'}; ms={ms:.4f} (device A="
                  f"{parts['A']:.4f} B={parts['B']:.4f} R={parts['R']:.4f}) plain_ms="
                  f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}); "
                  f"scratch {sc_bytes / 1e9:.3f} GB written and read, byte floor "
                  f"{floor_ms:.4f} ms {'PASS' if ok else 'FAIL'}", flush=True)
            report[("mlp-bwd", prec, s)] = dict(err=max(e[2] for e in errs), ms=ms,
                                                plain_ms=plain_ms, library_ms=lib_ms,
                                                bound_ms=b_ms, bound_by=b_by)
            del kw, kb, again, plain
            torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("point backward kernel disagrees with its plain version")


# the plain probe with one fault each; the kernel's bits must differ from
# every one of them
PROBE_FAULTS = {
    "lin & 15 as the bit": lambda w, lin: (w[(lin >> 5).long()] >> (lin & 15)) & 1,
    "lin >> 4 as the word": lambda w, lin: (w[(lin >> 4).long() % w.numel()] >> (lin & 31)) & 1,
    "bits reversed in the word": lambda w, lin: (w[(lin >> 5).long()] >> (31 - (lin & 31))) & 1,
}
OCC_BINS = 64  # the occupancy config's num_bins: 4096 x 64 = 262,144 probes per chunk


def random_words(n: int, gen, dev) -> torch.Tensor:
    """``n`` int32 words with each bit set with probability 1/2."""
    w = torch.randint(0, 2 ** 32, (n,), generator=gen, device=dev, dtype=torch.int64)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def phase_kernel_occ(dev, report):
    """The occupancy probe kernel against ``probe_bits_plain`` at G=64 and
    G=128: identical bits on the cells of 4096 orbit rays x 64 bins (by
    ``query_bin_weights``' own index computation, ``bin_cells``), on a
    ragged count and on one probe in every word; faulty plain versions must
    differ; times at the main path's 262,144 probes (G=64)."""
    from minimal_nerf_torch.kernels import occupancy_probe as op
    from minimal_nerf_torch.ops import occupancy as occ

    gen = torch.Generator(device=dev).manual_seed(8)
    o, d, _ = sample_rays(RAYS, 1, gen, dev)
    ok_all, worst = True, 0
    for g in (64, 128):
        cfg = occ.OccupancyConfig(resolution=g)
        n_words = g ** 3 // 32
        words = random_words(n_words, gen, dev)
        lin, in_box = occ.bin_cells(o, d, cfg, OCC_BINS, 2.0, 6.0)
        every = (torch.arange(n_words, dtype=torch.int32, device=dev) * 32
                 + torch.randint(0, 32, (n_words,), generator=gen, device=dev, dtype=torch.int32))
        cases = {f"{RAYS}x{OCC_BINS} orbit bins": lin,
                 f"ragged {RAYS * OCC_BINS - 1}": lin.reshape(-1)[:RAYS * OCC_BINS - 1],
                 f"every word ({n_words})": every}
        msg, ok = [], True
        for name, probes in cases.items():
            k, p = op.probe_bits(words, probes), op.probe_bits_plain(words, probes)
            bad = int((k != p).sum())
            worst = max(worst, int((k - p).abs().max()))
            ok &= bad == 0 and k.shape == probes.shape and k.dtype == torch.int32
            msg.append(f"{name}: {bad} mismatches, {k.float().mean().item():.3f} set")
        faults = {name: int((fault(words, lin) != op.probe_bits(words, lin)).sum())
                  for name, fault in PROBE_FAULTS.items()}
        ok &= all(m > 0 for m in faults.values())
        ok_all &= ok
        print(f"[kernel-occ] G={g} ({n_words} words, {in_box.float().mean().item():.3f} of the "
              f"bins inside the grid's box): {'; '.join(msg)}; faulty plain versions' "
              f"mismatches {faults} (each must be > 0) {'PASS' if ok else 'FAIL'}", flush=True)
        if g == 64:
            p_count = lin.numel()
            kernel = lambda: op.probe_bits(words, lin)  # noqa: E731
            plain = lambda: op.probe_bits_plain(words, lin)  # noqa: E731
            # no single PyTorch call computes the function: the yardstick is
            # the bare indexing expression (no range check), never used
            lib = lambda: (words[(lin >> 5).long()] >> (lin & 31)) & 1  # noqa: E731
            # device time per call (the calls are too short for events: CUDA
            # events around back-to-back calls time the host instead, shown
            # as call_ms)
            ms, plain_ms, lib_ms = (device_ms(f) for f in (kernel, plain, lib))
            call_ms = cuda_ms(kernel, warmup=10, reps=200)
            # bytes: lin in and bits out (4 B each per probe), the table once
            b_ms = 1e3 * (8 * p_count + 4 * n_words) / HBM_BYTES_PER_S
            print(f"[kernel-occ] G=64 P={p_count}: device ms={ms:.5f} plain_ms={plain_ms:.5f} "
                  f"library_ms={lib_ms:.5f} (indexing expression) bound_ms={b_ms:.5f} (bytes); "
                  f"call_ms={call_ms:.5f} (CUDA events over 200 back-to-back wrapper calls)",
                  flush=True)
            report["occ"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                 bound_by="bytes")
    report["occ"]["err"] = worst
    if not ok_all:
        raise AssertionError("occupancy probe kernel disagrees with its plain version")


SAMPLER_BINS, SAMPLER_S = 64, 16  # the fast recipe's 64 bins and 16 coarse samples
# floor 0.1: the share of samples the card's plain version (a float32 cumsum)
# puts in another bin than the kernel (the exact prefix sums rounded once),
# most on the eps = 0 rays, whose u = s / S may equal an exact CDF value
# (an H100: 7.2e-4 with jitter, 9.3e-4 without)
MOVED_BIN_SHARE = 5e-3


def sampler_inputs(n: int, s: int, g: int, jitter: bool, gen, dev, floor: float = 0.25):
    """The sampler's inputs at B = 64 on the card: random words (about half
    of the bits set); rays of the main path's orbit view for half of them,
    the rest from a camera 7 units out toward the box (their first bins
    outside it, weight 0); every fourth ray tuned so one bin midpoint lies
    within a few ulp of a cell boundary (the cell then depends on every
    rounding); the last sixteenth wholly outside the box (the uniform
    fallback); eps = 0 on every eighth ray (u on the grid's edges, where a
    right-sided search differs); frac with jitter."""
    from minimal_nerf_torch.kernels import occupancy_sampler as osk
    from minimal_nerf_torch.ops import occupancy as occ

    cfg = occ.OccupancyConfig(resolution=g, num_bins=SAMPLER_BINS, floor=floor,
                              in_bin_jitter=jitter)
    consts = osk.bin_constants(cfg, SAMPLER_BINS, 2.0, 6.0)
    words = random_words(g ** 3 // 32, gen, dev)
    o, d, _ = sample_rays(n, 1, gen, dev)
    half = n // 2
    eye = torch.randn((n - half, 3), generator=gen, device=dev)
    eye = 7.0 * eye / eye.norm(dim=1, keepdim=True)
    o[half:] = eye
    d[half:] = -eye / 7.0 + 0.15 * torch.randn((n - half, 3), generator=gen, device=dev)
    tuned = torch.arange(0, n, 4, device=dev)
    b, axis, cell = (torch.randint(lo, hi, (tuned.numel(),), generator=gen, device=dev)
                     for lo, hi in ((0, SAMPLER_BINS), (0, 3), (1, g)))
    mids = consts.near + (torch.arange(SAMPLER_BINS, device=dev, dtype=torch.float32) + 0.5) \
        * consts.width
    edge = cell.double() / consts.scale - consts.bound
    o[tuned, axis] = (edge - mids[b].double() * d[tuned, axis].double()).float()
    o[n - max(1, n // 16):] += 20.0
    eps = torch.rand((n, 1), generator=gen, device=dev)
    eps[::8] = 0.0
    frac = torch.rand((n, s), generator=gen, device=dev) if jitter else None
    return cfg, words, o.contiguous(), d.contiguous(), eps, frac


def sample_bins(weights, eps, s):
    """Each sample's clamped bin, as the plain version finds it, on the
    weights' device."""
    cdf = torch.cumsum(weights, dim=1)
    cdf = cdf / (cdf[:, -1:] + 1e-10)
    u = torch.arange(s, dtype=torch.float32, device=weights.device)[None, :] / s + eps / s
    return torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous()),
                       max=weights.shape[1] - 1)


def fma_bin_cells(o_rays, d_rays, cfg, num_bins, near, far):
    """``bin_cells`` with ``o + mid * d`` rounded once, as an FMA would."""
    g = cfg.resolution
    width = (far - near) / num_bins
    mids = near + (torch.arange(num_bins, dtype=torch.float32, device=o_rays.device) + 0.5) * width
    pos = (o_rays.double()[:, None, :] + mids.double()[None, :, None]
           * d_rays.double()[:, None, :]).float()
    v = torch.floor((pos + cfg.bound) * (g / (2.0 * cfg.bound))).to(torch.int32)
    inside = torch.all((v >= 0) & (v < g), dim=-1)
    vc = torch.clamp(v, 0, g - 1)
    return ((vc[..., 0] * g + vc[..., 1]) * g + vc[..., 2]).contiguous(), inside


def sampler_faults():
    """The plain sampler with one fault each, as (module, attribute,
    replacement); the kernel must differ from every one of them."""
    from types import SimpleNamespace

    from minimal_nerf_torch.kernels import occupancy_probe as op
    from minimal_nerf_torch.ops import occupancy as occ

    search = torch.searchsorted
    return {
        "FMA-contracted cell positions": (occ, "bin_cells", fma_bin_cells),
        "searchsorted right": (torch, "searchsorted",
                               lambda a, v, right=False: search(a, v, right=True)),
        "no uniform fallback": (occ, "uniform_fallback", lambda w: w),
        "no sort": (torch, "sort", lambda t, dim: SimpleNamespace(values=t)),
        "bits reversed in the word": (
            op, "probe_bits_plain",
            lambda w, lin: ((w[(lin >> 5).long()] >> (31 - (lin & 31))) & 1).to(torch.int32)),
    }


def phase_kernel_occ_sampler(dev, report):
    """The fused occupancy sampler against its plain version
    (``occupancy_sample_plain``, the PyTorch math of ``query_bin_weights`` +
    ``occupancy_coarse_samples``) on the card: weights, ts and samples must
    be identical at floor 0.25 for G in {64, 128}, S in {16, 64}, jitter on
    and off, N in {4096, 4095, 5}; at floor 0.1 the kernel must equal the
    plain version on the CPU (both round each exact CDF prefix once) and
    the share of samples in another bin than the card's plain version puts
    them (a float32 cumsum) is shown and bounded; faulty plain versions must
    differ; times
    at the fast recipe's 4096 rays x 64 bins x 16 samples, G=64, jitter."""
    from minimal_nerf_torch.kernels import occupancy_sampler as osk
    from minimal_nerf_torch.ops import occupancy as occ

    gen = torch.Generator(device=dev).manual_seed(12)
    near, far = 2.0, 6.0
    ok_all, worst = True, 0.0
    for g in (64, 128):
        bad = {}
        for s in (16, 64):
            for jitter in (True, False):
                for n in (RAYS, RAYS - 1, 5):
                    cfg, words, o, d, eps, frac = sampler_inputs(n, s, g, jitter, gen, dev)
                    with uncounted():
                        before = launched(osk.LAUNCHES)
                        k = occ.occupancy_sample(words, o, d, eps, frac, cfg, s, near, far,
                                                 with_weights=True)
                        ran = launched(osk.LAUNCHES) - before
                    p = occ.occupancy_sample_plain(words, o, d, eps, frac, cfg, s, near, far)
                    mism = [int((a != b).sum()) for a, b in zip(k, p)]
                    worst = max(worst, *((a - b).abs().max().item() for a, b in zip(k, p)))
                    ok_all &= mism == [0, 0, 0] and ran == 1
                    if any(mism):
                        bad[(s, jitter, n)] = mism
        print(f"[kernel-occ-sampler] G={g}, B={SAMPLER_BINS}, floor 0.25: samples/ts/weights "
              f"mismatches against the plain version over S in (16, 64) x jitter on/off x N in "
              f"({RAYS}, {RAYS - 1}, 5): {bad or 'none'} (must be none) "
              f"{'PASS' if not bad else 'FAIL'}", flush=True)
    # floor 0.1: the kernel against the plain version on the CPU, bit for bit,
    # and the share of the card's plain version's times that differ
    shares, same = {}, {}
    for jitter in (True, False):
        cfg, words, o, d, eps, frac = sampler_inputs(RAYS, SAMPLER_S, 64, jitter, gen, dev, 0.1)
        with uncounted():
            k = occ.occupancy_sample(words, o, d, eps, frac, cfg, SAMPLER_S, near, far,
                                     with_weights=True)
        cpu = [None if a is None else a.cpu() for a in (words, o, d, eps, frac)]
        p_cpu = occ.occupancy_sample_plain(*cpu[:5], cfg, SAMPLER_S, near, far)
        same[jitter] = all(torch.equal(a.cpu(), b) for a, b in zip(k, p_cpu))
        shares[jitter] = (sample_bins(k[2], eps, SAMPLER_S).cpu()
                          != sample_bins(p_cpu[2], cpu[3], SAMPLER_S)).float().mean().item()
        ok_all &= same[jitter] and shares[jitter] <= MOVED_BIN_SHARE
    print(f"[kernel-occ-sampler] G=64, floor 0.1: kernel equal to the plain version on the CPU "
          f"(its cumsum rounds each exact prefix once, as the kernel's): jitter "
          f"{same[True]}, no jitter {same[False]}; share of samples in another bin than the "
          f"plain version on the card puts them (its float32 cumsum leaves a CDF value an ulp "
          f"off; u on exact fractions s/S on the eps = 0 rays): jitter {shares[True]:.2e}, no "
          f"jitter {shares[False]:.2e} (bound {MOVED_BIN_SHARE})", flush=True)
    # faulty plain versions, at the main path's shapes with jitter
    cfg, words, o, d, eps, frac = sampler_inputs(RAYS, SAMPLER_S, 64, True, gen, dev)
    with uncounted():
        k = occ.occupancy_sample(words, o, d, eps, frac, cfg, SAMPLER_S, near, far,
                                 with_weights=True)
    faults = {}
    for name, (module, attr, faulty) in sampler_faults().items():
        with wrapped(module, attr, lambda orig, f=faulty: f):
            p = occ.occupancy_sample_plain(words, o, d, eps, frac, cfg, SAMPLER_S, near, far)
        faults[name] = int((k[1] != p[1]).sum()) + int((k[2] != p[2]).sum())
    caught = all(m > 0 for m in faults.values())
    print(f"[kernel-occ-sampler] faulty plain versions' mismatches (times + weights) {faults} "
          f"(each must be > 0) {'PASS' if caught else 'FAIL'}", flush=True)

    consts = osk.bin_constants(cfg, SAMPLER_BINS, near, far)
    kernel = lambda: osk.sample(words, o, d, eps, frac, consts, SAMPLER_S)  # noqa: E731
    plain = lambda: occ.occupancy_sample_plain(  # noqa: E731
        words, o, d, eps, frac, cfg, SAMPLER_S, near, far)
    with uncounted():
        ms, plain_ms = device_ms(kernel), device_ms(plain)
        call_ms = cuda_ms(kernel, warmup=10, reps=200)
        plain_call_ms = cuda_ms(plain, warmup=3, reps=50)
    # bytes: o, d, eps and frac read once, ts and samples written once, the
    # word table once
    io = RAYS * (4 * 3 * 2 + 4 + 4 * SAMPLER_S + 4 * SAMPLER_S * 4) + 4 * words.numel()
    b_ms = 1e3 * io / HBM_BYTES_PER_S
    print(f"[kernel-occ-sampler] G=64 N={RAYS} B={SAMPLER_BINS} S={SAMPLER_S} jitter: device "
          f"ms={ms:.5f} plain_ms={plain_ms:.5f} (device time of its kernels) library_ms=none (no "
          f"single PyTorch call computes it) bound_ms={b_ms:.5f} (bytes: {io} B at 3.35 TB/s); "
          f"call_ms={call_ms:.5f} (CUDA events over 200 back-to-back wrapper calls), the plain "
          f"version's {plain_call_ms:.5f}; {ptxas_report('occupancy_sampler', 'sampler_kernel')}",
          flush=True)
    report["occ_sampler"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                                 bound_by="bytes", err=worst, call_ms=call_ms)
    if not ok_all:
        raise AssertionError("occupancy sampler kernel disagrees with its plain version")
    if not caught:
        raise AssertionError("a faulty plain sampler matched the kernel")


# the hash encoding's kernels against their plain versions (as
# tests/test_torch_ngp_cuda.py): the forward does the plain version's
# operations in its order with no FMA, so each feature agrees to fp32
# rounding of the largest (HASH_FWD_RTOL); the backward's atomics add in an
# order that changes from run to run, so each table entry's gradient is
# held within HASH_BWD_RTOL of the sum of its terms' magnitudes
HASH_FWD_RTOL, HASH_BWD_RTOL = 1e-6, 1e-5
NGP_CELL, NGP_SEED = "train.ngp", 3_000_000_019


def cell_program(dev, name: str, seed: int):
    """A train cell's program as the benchmark builds it (the field module
    its configuration names, ``nerfbench.fields.<field>``): its
    configuration, traffic, scene, grid and weights from ``seed``, and
    ``(step, state)`` of its train step."""
    from nerfbench import spec as S
    from nerfbench.traffic import generate as gen

    cell = S.load_cell(name)
    cfg, traffic = cell["config"], cell["traffic"]
    F = S.field(cfg)
    images, poses, focal = gen.scene(seed, traffic, dev)
    grid = gen.grid(seed, cfg["occupancy"], traffic["grid"], dev)
    params = F.weights(seed, cfg, traffic, dev)
    step, state = F.train_program(cfg, traffic, focal, params, dev)
    return cfg, traffic, images, poses, grid, params, step, state


def hash_fwd_errors(got, want):
    """(max |k - p| / max |p|, within ``HASH_FWD_RTOL``)."""
    err = float((got - want).abs().max()) / float(want.abs().max())
    return err, err <= HASH_FWD_RTOL


def hash_bwd_errors(got, want, scale):
    """(max |k - p| / the entry's sum of magnitudes, within
    ``HASH_BWD_RTOL`` with the same entries touched)."""
    err = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
    return err, err <= HASH_BWD_RTOL and torch.equal(got != 0, want != 0)


def phase_hash_encode(dev, report):
    from minimal_nerf_torch.kernels import hash_encode as he
    from minimal_nerf_torch.ops import encoding as enc
    from minimal_nerf_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, traffic, images, poses, grid, params, step, state = cell_program(dev, NGP_CELL,
                                                                         NGP_SEED)
    start, spc = traffic["start_step"], cfg["train"]["steps_per_call"]
    every = cfg["occupancy"]["update_every"]
    # the first (eager) step's launches: its coarse and fine passes'
    # points, then their features' gradients
    seen = {"fwd": [], "bwd": []}

    def keep_fwd(forward):
        def kept(x01, table, levels):
            if len(seen["fwd"]) < 2:
                seen["fwd"].append((x01.clone(), levels))
            return forward(x01, table, levels)
        return kept

    def keep_bwd(backward):
        def kept(x01, grad, shape, levels):
            if len(seen["bwd"]) < 2:
                seen["bwd"].append((x01.clone(), grad.float().clone(), levels))
            return backward(x01, grad, shape, levels)
        return kept

    with wrapped(he, "forward", keep_fwd), wrapped(he, "backward", keep_bwd):
        params, state, grid, _ = step(params, state, grid, images, poses, start, NGP_SEED)
    torch.cuda.synchronize()
    table = params["table"].detach()
    ok_all = True
    fwd, bwd = [], []
    for x, levels in seen["fwd"]:
        got, want = he.forward(x, table, levels), enc.hash_encode_plain(x, table, levels)
        err, ok = hash_fwd_errors(got, want)
        bad = table.clone()
        bad[levels[-1].offset:] = 0
        missed = [name for name, p in (
            ("finest level zeroed", enc.hash_encode_plain(x, bad, levels)),
            ("features x (1 + 1e-5)", want * (1 + 1e-5))) if hash_fwd_errors(got, p)[1]]
        ms = cuda_ms(lambda: he.forward(x, table, levels))
        plain_ms = cuda_ms(lambda: enc.hash_encode_plain(x, table, levels))
        b_ms = 1e3 * x.shape[0] * (12 + 4 * got.shape[1]) / HBM_BYTES_PER_S
        ok_all &= ok and not missed
        print(f"[hash-encode] forward P={x.shape[0]} L={len(levels)} F={table.shape[1]} "
              f"entries={table.shape[0]}: max |k - p| / max |p| = {err:.3e} (tol "
              f"{HASH_FWD_RTOL}); faulty plain versions passed: {missed or 'none'}; ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms=null (no single PyTorch call computes it) "
              f"bound_ms={b_ms:.5f} (bytes: positions read, features written), "
              f"{100 * b_ms / ms:.2f}% of the bound's rate "
              f"{'PASS' if ok and not missed else 'FAIL'}", flush=True)
        fwd.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                        bound_by="bytes"))
    entries = table.shape[0]
    for x, grad, levels in seen["bwd"]:
        got = he.backward(x, grad, (entries, 2), levels)
        want = enc.hash_encode_backward_plain(x, grad, entries, levels)
        scale = enc.hash_encode_backward_plain(x, grad.abs(), entries, levels)
        err, ok = hash_bwd_errors(got, want, scale)
        again = hash_bwd_errors(he.backward(x, grad, (entries, 2), levels), want, scale)[1]
        dropped = grad.clone()
        dropped[:, -2:] = 0
        missed = [name for name, p in (
            ("finest level's gradient dropped",
             enc.hash_encode_backward_plain(x, dropped, entries, levels)),
            ("gradient x (1 + 1e-4)", want * (1 + 1e-4))) if hash_bwd_errors(got, p, scale)[1]]
        # the counted launch: hash_encode_bwd.merged_share by level, its
        # gradient held to the same tolerance
        with uncounted():
            profiling.reset()
            counted = hash_bwd_errors(he.backward_counted(x, grad, (entries, 2), levels)[0],
                                      want, scale)[1]
            share = he.merged_share(len(levels))
        ms = cuda_ms(lambda: he.backward(x, grad, (entries, 2), levels))
        plain_ms = cuda_ms(lambda: enc.hash_encode_backward_plain(x, grad, entries, levels))
        b_ms = 1e3 * x.shape[0] * (12 + 4 * grad.shape[1]) / HBM_BYTES_PER_S
        ok_b = ok and again and counted and not missed
        ok_all &= ok_b
        print(f"[hash-encode] backward P={x.shape[0]}: max |k - p| / sum |terms| = {err:.3e} "
              f"(tol {HASH_BWD_RTOL}), touched {int((want != 0).sum())} of {want.numel()}, a "
              f"second launch within it too: {again}, the counted launch: {counted}; faulty "
              f"plain versions passed: {missed or 'none'}; ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms=null (no single PyTorch call computes it) bound_ms={b_ms:.5f} (bytes: "
              f"positions and the features' gradient read), {100 * b_ms / ms:.2f}% of the "
              f"bound's rate; {he.MERGED_SHARE} all {share['all']:.4f}, by level "
              f"{[round(share[f'l{lv}'], 4) for lv in range(len(levels))]} "
              f"{'PASS' if ok_b else 'FAIL'}", flush=True)
        bwd.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                        bound_by="bytes", merged_share=share))
    ok_all &= len(fwd) == 2 and len(bwd) == 2
    # a whole call of the program: the first call captured its step, so this
    # one replays it; the counters, set to 0 just before, count each
    # replay's launches again, and the grid's updates encode once each
    first = start + spc
    updates = sum(s % every == 0 for s in range(first, first + spc))
    profiling.reset()
    params, state, grid, _ = step(params, state, grid, images, poses, first, NGP_SEED)
    torch.cuda.synchronize()
    launches = (profiling.counter(he.LAUNCHES_FWD), profiling.counter(he.LAUNCHES_BWD))
    replays = profiling.counter("graph.replays")
    want_l = (2 * spc + updates, 2 * spc)
    # the kernels a replayed call ran, by name in a profiler trace (one
    # further call outside it first)
    third = first + spc
    starts = iter((third, third + spc))
    spans = device_spans(lambda: step(params, state, grid, images, poses, next(starts),
                                      NGP_SEED), 1)
    traced = tuple(sum(name.startswith(k) for name, _ in spans)
                   for k in ("hash_encode_fwd", "hash_encode_bwd"))
    want_t = (2 * spc + sum(s % every == 0 for s in range(third + spc, third + 2 * spc)),
              2 * spc)
    in_step = [sum(us for name, us in spans if name.startswith(k)) / 1e3 / spc
               for k in ("hash_encode_fwd", "hash_encode_bwd")]
    ok_l = launches == want_l and replays == spc and traced == want_t
    ok_all &= ok_l
    print(f"[hash-encode] one replayed call of {NGP_CELL}'s program ({spc} steps from "
          f"{first}, {updates} grid update(s)): launches fwd={launches[0]} bwd={launches[1]} "
          f"(want {want_l[0]} = 2 passes x {spc} steps + {updates}, {want_l[1]}), graph "
          f"replays {replays} (want {spc}); traced call: fwd={traced[0]} bwd={traced[1]} "
          f"(want {want_t[0]}, {want_t[1]}), device ms per step: hash_encode_fwd "
          f"{in_step[0]:.4f}, hash_encode_bwd {in_step[1]:.4f} {'PASS' if ok_l else 'FAIL'}",
          flush=True)
    report["hash_fwd"], report["hash_bwd"], report["hash_launches"] = fwd, bwd, launches
    del step, state, params, grid, images, poses, seen
    torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("the hash encoding's kernels disagree with their plain versions "
                             "or did not carry the train.ngp call")


# TensoRF's VM sampling kernels against their plain versions (as
# tests/test_torch_tensorf_cuda.py): the forward does the plain version's
# operations in its order with no FMA, so its outputs equal the plain
# version's bit for bit; the backward's float4 atomics add in an order that
# changes from run to run, so each factor entry's gradient is held within
# VM_BWD_RTOL of the sum of its terms' magnitudes, and an entry no term
# reaches stays 0
VM_BWD_RTOL = 1e-5
TENSORF_CELL, TENSORF_SEED = "train.tensorf", 3_260_002_101


def vm_bwd_errors(got, want, scale):
    """(max |k - p| / the entry's sum of magnitudes over the four factors,
    within ``VM_BWD_RTOL`` with no entry touched that no term reaches)."""
    err = max(float(((a - b).abs() / s.clamp_min(1e-30)).max())
              for a, b, s in zip(got, want, scale))
    untouched = all(not bool(a[s == 0].any()) for a, s in zip(got, scale))
    return err, err <= VM_BWD_RTOL and untouched


def vm_equal(got, want):
    """Both outputs (``f_sigma``, the products or None) equal bit for bit."""
    return torch.equal(got[0], want[0]) and (
        got[1] is None and want[1] is None or torch.equal(got[1], want[1]))


def phase_vm_sample(dev, report):
    from minimal_nerf_torch.kernels import vm_sample as vm
    from minimal_nerf_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, traffic, images, poses, grid, params, step, state = cell_program(dev, TENSORF_CELL,
                                                                         TENSORF_SEED)
    start, spc = traffic["start_step"], cfg["train"]["steps_per_call"]
    every, bound = cfg["occupancy"]["update_every"], cfg["tensorf"]["bound"]
    per_point = 12 + 4 * (1 + 3 * vm.KERNEL_COMPONENTS[1])  # fields/tensorf.py's 592 B
    # the first (eager) step's launches: its coarse and fine passes' points,
    # then the outputs' gradients; the first grid update's points (the
    # density-only launch)
    seen = {"fwd": [], "alone": [], "bwd": []}

    def keep_fwd(forward):
        def kept(x, factors, bound, with_app=True):
            kind = "fwd" if with_app else "alone"
            if len(seen[kind]) < (2 if with_app else 1):
                seen[kind].append(x.clone())
            return forward(x, factors, bound, with_app)
        return kept

    def keep_bwd(backward):
        def kept(x, factors, bound, g_sigma, g_prods):
            if len(seen["bwd"]) < 2:
                seen["bwd"].append((x.clone(), g_sigma.float().clone(),
                                    g_prods.float().clone()))
            return backward(x, factors, bound, g_sigma, g_prods)
        return kept

    with wrapped(vm, "forward", keep_fwd), wrapped(vm, "backward", keep_bwd):
        params, state, grid, _ = step(params, state, grid, images, poses, start, TENSORF_SEED)
    torch.cuda.synchronize()
    factors = {k: params[k].detach() for k in vm.KEYS}
    # the planted faults: one appearance plane, one density plane zeroed
    bad_app = dict(factors, app_planes=factors["app_planes"].clone())
    bad_app["app_planes"][0] = 0
    bad_density = dict(factors, density_planes=factors["density_planes"].clone())
    bad_density["density_planes"][0] = 0
    ok_all = True
    fwd, bwd = [], []
    for x in seen["fwd"]:
        got, want = vm.forward(x, factors, bound), vm.sample_plain(x, factors, bound)
        alone = vm.forward(x, factors, bound, with_app=False)
        equal = vm_equal(got, want) and vm_equal(alone, (want[0], None))
        outside = int((~torch.isfinite(want[0])).sum())
        missed = [name for name, f in (("an appearance plane zeroed", bad_app),
                                       ("a density plane zeroed", bad_density))
                  if vm_equal(got, vm.sample_plain(x, f, bound))]
        ms = cuda_ms(lambda: vm.forward(x, factors, bound))
        plain_ms = cuda_ms(lambda: vm.sample_plain(x, factors, bound))
        b_ms = 1e3 * x.shape[0] * per_point / HBM_BYTES_PER_S
        ok_all &= equal and not missed
        print(f"[vm-sample] forward P={x.shape[0]} N={factors['app_planes'].shape[1]}: f_sigma "
              f"and the {got[1].shape[1]} products equal to sample_plain bit for bit: {equal} "
              f"(the density-only launch too), outside the box {outside}; "
              f"faulty plain versions passed: {missed or 'none'}; ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms=null (no single PyTorch call computes it) "
              f"bound_ms={b_ms:.5f} (bytes: {per_point} a point, positions read, f_sigma and "
              f"products written), {100 * b_ms / ms:.2f}% of the bound's rate "
              f"{'PASS' if equal and not missed else 'FAIL'}", flush=True)
        fwd.append(dict(err=0.0 if equal else float("inf"), ms=ms, plain_ms=plain_ms,
                        library_ms=None, bound_ms=b_ms, bound_by="bytes"))
    for x in seen["alone"]:
        got = vm.forward(x, factors, bound, with_app=False)
        equal = vm_equal(got, vm.sample_plain(x, factors, bound, with_app=False))
        missed = vm_equal(got, vm.sample_plain(x, bad_density, bound, with_app=False))
        ms = cuda_ms(lambda: vm.forward(x, factors, bound, with_app=False))
        b_ms = 1e3 * x.shape[0] * 16 / HBM_BYTES_PER_S
        ok_all &= equal and not missed
        print(f"[vm-sample] density-only forward (the grid update's P={x.shape[0]} points): "
              f"equal to sample_plain bit for bit: {equal}; a density plane zeroed passed: "
              f"{missed}; ms={ms:.4f} bound_ms={b_ms:.5f} (16 B a point) "
              f"{'PASS' if equal and not missed else 'FAIL'}", flush=True)
    for x, g_s, g_p in seen["bwd"]:
        got = vm.backward(x, factors, bound, g_s, g_p)
        want = vm.backward_plain(x, factors, bound, g_s, g_p)
        scale = vm.backward_plain(x, {k: t.abs() for k, t in factors.items()}, bound,
                                  g_s.abs(), g_p.abs())
        err, ok = vm_bwd_errors(got, want, scale)
        again = vm_bwd_errors(vm.backward(x, factors, bound, g_s, g_p), want, scale)[1]
        missed = [name for name, p in (
            ("an appearance plane wrong (zeroed)", vm.backward_plain(x, bad_app, bound, g_s, g_p)),
            ("gradients x (1 + 1e-4)", tuple(t * (1 + 1e-4) for t in want)))
            if vm_bwd_errors(got, p, scale)[1]]
        ms = cuda_ms(lambda: vm.backward(x, factors, bound, g_s, g_p))
        plain_ms = cuda_ms(lambda: vm.backward_plain(x, factors, bound, g_s, g_p))
        b_ms = 1e3 * x.shape[0] * per_point / HBM_BYTES_PER_S
        ok_b = ok and again and not missed
        ok_all &= ok_b
        print(f"[vm-sample] backward P={x.shape[0]}: max |k - p| / sum |terms| = {err:.3e} (tol "
              f"{VM_BWD_RTOL}), touched {sum(int((w != 0).sum()) for w in want)} of "
              f"{sum(w.numel() for w in want)}, a second launch within it too: {again}; faulty "
              f"plain versions passed: {missed or 'none'}; ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms=null (no single PyTorch call computes it) bound_ms={b_ms:.5f} (bytes: "
              f"{per_point} a point, positions and the outputs' gradients read), "
              f"{100 * b_ms / ms:.2f}% of the bound's rate {'PASS' if ok_b else 'FAIL'}",
              flush=True)
        bwd.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                        bound_by="bytes"))
    ok_all &= len(fwd) == 2 and len(seen["alone"]) == 1 and len(bwd) == 2
    # a whole call of the program: the first call captured its step, so this
    # one replays it; the counters, set to 0 just before, count each
    # replay's launches again, and each grid update's density-only launch once
    first = start + spc
    updates = sum(s % every == 0 for s in range(first, first + spc))
    profiling.reset()
    params, state, grid, _ = step(params, state, grid, images, poses, first, TENSORF_SEED)
    torch.cuda.synchronize()
    launches = (profiling.counter(vm.LAUNCHES_FWD), profiling.counter(vm.LAUNCHES_BWD))
    replays = profiling.counter("graph.replays")
    want_l = (2 * spc + updates, 2 * spc)
    # the kernels a replayed call ran, by name in a profiler trace (one
    # further call outside it first)
    third = first + spc
    starts = iter((third, third + spc))
    spans = device_spans(lambda: step(params, state, grid, images, poses, next(starts),
                                      TENSORF_SEED), 1)
    traced = tuple(sum(k in name for name, _ in spans) for k in VM_KERNELS)
    want_t = (2 * spc + sum(s % every == 0 for s in range(third + spc, third + 2 * spc)),
              2 * spc)
    in_step = [sum(us for name, us in spans if k in name) / 1e3 / spc for k in VM_KERNELS]
    ok_l = launches == want_l and replays == spc and traced == want_t
    ok_all &= ok_l
    print(f"[vm-sample] one replayed call of {TENSORF_CELL}'s program ({spc} steps from "
          f"{first}, {updates} grid update(s)): launches fwd={launches[0]} bwd={launches[1]} "
          f"(want {want_l[0]} = 2 passes x {spc} steps + {updates}, {want_l[1]}), graph "
          f"replays {replays} (want {spc}); traced call: fwd={traced[0]} bwd={traced[1]} "
          f"(want {want_t[0]}, {want_t[1]}), device ms per step: vm_sample_fwd "
          f"{in_step[0]:.4f}, vm_sample_bwd {in_step[1]:.4f} {'PASS' if ok_l else 'FAIL'}",
          flush=True)
    report["vm_fwd"], report["vm_bwd"], report["vm_launches"] = fwd, bwd, launches
    del step, state, params, grid, images, poses, seen, factors, bad_app, bad_density
    torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("the VM sampling kernels disagree with their plain versions or "
                             "did not carry the train.tensorf call")


# TensoRF's shading kernels against the chain they replace (as
# tests/test_torch_tensorf_cuda.py): autograd of mlp_plain at bf16 on the
# same inputs. Both round every product's inputs to bf16 and sum in fp32, at
# other points in the backward (module doc of kernels/tensorf_mlp.py), so
# each output is held in relative L2 norm to MLP_RTOL; an input column of
# the first layer dropped from the plain chain (the first sine of the
# features) must fail it.
MLP_RTOL = {"rgb": 1e-3, "dprods": 2e-2, "dbasis": 2e-2, "dw1": 2e-2, "db1": 2e-2, "dw2": 2e-2,
            "db2": 2e-2, "dw3": 2e-2, "db3": 2e-2}
MLP_DROPPED = 30  # the plain input's column of sin(a_0)


def mlp_outputs(fn, prods, direc, basis, mlp, g_rgb):
    """``fn``'s rgb and autograd's gradients of the products, the basis and
    each layer's w and b for the color's gradient ``g_rgb``."""
    leaves = [prods.clone().requires_grad_(True), basis.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for layer in mlp for t in (layer["w"], layer["b"])]
    layers = [{"w": leaves[2 + 2 * i], "b": leaves[3 + 2 * i]} for i in range(3)]
    rgb = fn(leaves[0], direc, leaves[1], layers)
    return [rgb.detach()] + list(torch.autograd.grad(rgb, leaves, g_rgb))


def mlp_dropped(prods, direc, basis, mlp):
    """The plain chain at bf16 with one input column of the first layer
    zeroed (a planted fault)."""
    from minimal_nerf_torch.kernels import tensorf_mlp as tm
    from minimal_nerf_torch.models.mlp import linear, round_to

    bf = torch.bfloat16
    s = prods.shape[0] // direc.shape[0]
    a = round_to(prods, bf) @ round_to(basis, bf)
    d = direc / torch.linalg.norm(direc, dim=-1, keepdim=True)
    d = torch.cat([d, tm.frequency_encoding(d, 2)], dim=-1).repeat_interleave(s, dim=0)
    h = torch.cat([a, d[:, :3], tm.frequency_encoding(a, 2), d[:, 3:]], dim=-1)
    h = h * (torch.arange(h.shape[1], device=h.device) != MLP_DROPPED)
    for layer in mlp[:-1]:
        h = torch.relu(linear(layer, h, bf))
    return torch.sigmoid(linear(mlp[-1], h, bf))


def mlp_gaps(got, want):
    """Each output's ``|k - p| / |p|`` in L2 (``MLP_RTOL``'s order) and
    whether all are within ``MLP_RTOL``."""
    gaps = {name: float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))
            for name, a, b in zip(MLP_RTOL, got, want)}
    return gaps, all(gaps[k] <= MLP_RTOL[k] for k in gaps)


def phase_tensorf_mlp(dev, report):
    from minimal_nerf_torch.kernels import tensorf_mlp as tm
    from minimal_nerf_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, traffic, images, poses, grid, params, step, state = cell_program(dev, TENSORF_CELL,
                                                                         TENSORF_SEED)
    start, spc = traffic["start_step"], cfg["train"]["steps_per_call"]
    basis = params["basis"].detach().clone()
    mlp = [{k: t.detach().clone() for k, t in layer.items()} for layer in params["mlp"]]
    # the first (eager) step's coarse and fine launches: their products and
    # directions, then the color's gradients
    seen, grads = [], {}

    def keep_fwd(forward):
        def kept(prods, direc, *rest):
            if len(seen) < 2:
                seen.append((prods.detach().clone(), direc.clone()))
            return forward(prods, direc, *rest)
        return kept

    def keep_bwd(backward):
        def kept(prods, direc, basis, mlp, image, g_rgb):
            grads.setdefault(prods.shape[0], g_rgb.float().clone())
            return backward(prods, direc, basis, mlp, image, g_rgb)
        return kept

    with wrapped(tm, "forward", keep_fwd), wrapped(tm, "backward", keep_bwd):
        params, state, grid, _ = step(params, state, grid, images, poses, start, TENSORF_SEED)
    torch.cuda.synchronize()
    ok_all = len(seen) == 2 and len(grads) == 2
    fwd, bwd = [], []
    plain = lambda p, d, b, m: tm.mlp_plain(p, d, b, m, 2, 2, torch.bfloat16)  # noqa: E731
    fp32 = lambda p, d, b, m: tm.mlp_plain(p, d, b, m, 2, 2, None)  # noqa: E731
    for prods, direc in seen:
        p = prods.shape[0]
        g = grads[p]
        got = mlp_outputs(tm.tensorf_mlp, prods, direc, basis, mlp, g)
        want = mlp_outputs(plain, prods, direc, basis, mlp, g)
        gaps, ok = mlp_gaps(got, want)
        missed = mlp_gaps(got, mlp_outputs(mlp_dropped, prods, direc, basis, mlp, g))[1]
        rgb, image = tm.forward(prods, direc, basis, mlp)
        again = tm.backward(prods, direc, basis, mlp, image, g)
        first = tm.backward(prods, direc, basis, mlp, image, g)
        same = torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]) and all(
            torch.equal(x[k], y[k]) for x, y in zip(first[2], again[2]) for k in ("w", "b"))
        ms_f = cuda_ms(lambda: tm.forward(prods, direc, basis, mlp))
        ms_b = cuda_ms(lambda: tm.backward(prods, direc, basis, mlp, image, g))
        plain_f = cuda_ms(lambda: fp32(prods, direc, basis, mlp))
        lib_f = cuda_ms(lambda: plain(prods, direc, basis, mlp))
        plain_fb = cuda_ms(lambda: mlp_outputs(fp32, prods, direc, basis, mlp, g))
        lib_fb = cuda_ms(lambda: mlp_outputs(plain, prods, direc, basis, mlp, g))
        b_f = 1e3 * p * (4 * tm.PRODS + 12) / HBM_BYTES_PER_S
        b_b = 1e3 * p * (8 * tm.PRODS + 12 + 12) / HBM_BYTES_PER_S
        ok_k = ok and not missed and same
        ok_all &= ok_k
        print(f"[tensorf-mlp] P={p} ({direc.shape[0]} rays x {p // direc.shape[0]}): kernels "
              f"against the plain chain at bf16, |k - p| / |p|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + f" (tol {MLP_RTOL['rgb']} rgb, {MLP_RTOL['dprods']} gradients); an input column "
              f"dropped passed: {missed}; two backward calls bit-identical: {same}; forward "
              f"ms={ms_f:.4f} bound_ms={b_f:.5f} ({100 * b_f / ms_f:.2f}%) library_ms={lib_f:.4f} "
              f"plain_ms={plain_f:.4f}; backward ms={ms_b:.4f} bound_ms={b_b:.5f} "
              f"({100 * b_b / ms_b:.2f}%); forward + backward library_ms={lib_fb:.4f} "
              f"plain_ms={plain_fb:.4f} {'PASS' if ok_k else 'FAIL'}", flush=True)
        fwd.append(dict(err=max(gaps["rgb"], 0.0), ms=ms_f, plain_ms=plain_f, library_ms=lib_f,
                        bound_ms=b_f, bound_by="bytes"))
        bwd.append(dict(err=max(v for k, v in gaps.items() if k != "rgb"), ms=ms_b,
                        plain_ms=plain_fb - plain_f, library_ms=lib_fb - lib_f, bound_ms=b_b,
                        bound_by="bytes"))
    # a whole call of the program, replayed (the counters set to 0 just before)
    first = start + spc
    profiling.reset()
    params, state, grid, _ = step(params, state, grid, images, poses, first, TENSORF_SEED)
    torch.cuda.synchronize()
    launches = (profiling.counter(tm.LAUNCHES_FWD), profiling.counter(tm.LAUNCHES_BWD))
    # the kernels of a further replayed call by name in a profiler trace; no
    # fp32 GEMM and no bf16 cast left in the step
    third = first + spc
    starts = iter((third, third + spc))
    spans = device_spans(lambda: step(params, state, grid, images, poses, next(starts),
                                      TENSORF_SEED), 1)
    names = ("tensorf_mlp_fwd_kernel", "tensorf_mlp_bwd_kernel")
    traced = tuple(sum(k in name for name, _ in spans) for k in names)
    in_step = sum(us for name, us in spans if "tensorf_mlp" in name) / 1e3 / spc
    gemms = sorted({name[:60] for name, _ in spans if "gemm" in name.lower()})
    casts = sum("bfloat16" in name.lower() for name, _ in spans)
    ok_l = launches == (2 * spc, 2 * spc) and traced == (2 * spc, 2 * spc) and not gemms \
        and not casts
    ok_all &= ok_l
    print(f"[tensorf-mlp] one replayed call of {TENSORF_CELL}'s program ({spc} steps from "
          f"{first}): launches fwd={launches[0]} bwd={launches[1]} (want {2 * spc} each); traced "
          f"call: fwd kernels {traced[0]}, bwd kernels {traced[1]}, the chain's kernels "
          f"{in_step:.4f} device ms a step; GEMM kernels in the step: {gemms or 'none'}; bf16 "
          f"kernels: {casts} {'PASS' if ok_l else 'FAIL'}", flush=True)
    report["mlp_fwd"], report["mlp_bwd"], report["mlp_launches"] = fwd, bwd, launches
    del step, state, params, grid, images, poses, seen, grads
    torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("the shading kernels disagree with the plain chain or did not "
                             "carry the train.tensorf call")


def phase_main_path(dev, tmp: Path):
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.models.nerf import NeRFConfig, init_nerf_network
    from minimal_nerf_torch.render import render_views
    from minimal_nerf_torch.training.checkpoint import checkpoint_name, save_checkpoint
    from minimal_nerf_torch.training.config import TrainConfig

    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = NeRFConfig()  # 64 coarse + 128 fine
    params = init_nerf_network(gen, cfg, device=dev)
    for mlp in params.values():
        # seeded init leaves relu(sigma) at 0 everywhere (a black frame);
        # a positive density bias makes the frame show the network's colors
        mlp["density"]["b"] += 0.5
    ckpt = save_checkpoint(tmp / checkpoint_name("smoke", 0, 0), params, 0, cfg.to_dict(),
                           TrainConfig(precision="bf16", kernel="fused").to_dict())
    frames_iter = render_views(str(ckpt), rays=RAYS, num_poses=POSES, height=HW, width=HW,
                               device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = list(frames_iter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launched(fr.FWD_LAUNCHES)
    chunks = math.ceil(HW * HW / RAYS)
    want = POSES * chunks * 2
    ok = launches == want and len(frames) == POSES
    for f in frames:
        ok &= f.shape == (HW, HW, 3) and str(f.dtype) == "uint8" and int(f.max()) > int(f.min())
    ms_frame = 1e3 * wall / POSES
    print(f"[main] rendered {len(frames)} frames {HW}x{HW} from {ckpt.name}: launches="
          f"{launches} (want {want} = {POSES} frames x {chunks} chunks x 2 passes); "
          f"ms/frame={ms_frame:.1f} rays/s={HW * HW * POSES / wall:.0f}; frame means="
          f"{[round(float(f.mean()), 2) for f in frames]} {'PASS' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("main path did not render through the kernel as expected")
    return ckpt, launches


def phase_reference(dev, ckpt: Path):
    """The card's render of a small input against the plain version on the
    CPU, same weights and same draws."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.training.trainer import load_state_for_inference

    n = 256
    gen = torch.Generator(device=dev).manual_seed(2)
    o, d, _ = sample_rays(n, 1, gen, dev)
    params, cfg, tcfg, _, _ = load_state_for_inference(ckpt, device=dev)
    uniforms = train_uniforms(n, cfg, gen, dev)
    with uncounted():
        card = fr.render_rays_fused(params, cfg, o, d, compute_dtype=tcfg.compute_dtype,
                                    uniforms=uniforms)
    to_cpu = lambda tree: map_params(lambda t: t.cpu(), tree)  # noqa: E731
    ref = fr.render_rays_fused(to_cpu(params), cfg, o.cpu(), d.cpu(),
                               compute_dtype=tcfg.compute_dtype, uniforms=to_cpu(uniforms))
    # same weights, draws and rounding points: the kernel and the plain
    # version differ only in the order of fp32 sums (see TOL)
    ok = True
    msg = []
    for k in ("coarse_rgb_rays", "fine_rgb_rays"):
        diff = (card[k].cpu() - ref[k]).abs()
        ok &= bool(torch.isfinite(card[k]).all()) and diff.max().item() <= 1e-3
        msg.append(f"{k} max_abs={diff.max().item():.3e} mean_abs={diff.mean().item():.3e}")
    print(f"[reference] {n} rays, card (kernel) vs CPU (plain), shared draws: "
          f"{'; '.join(msg)} (tol 1e-3) {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("card render disagrees with the CPU reference")


def gif_blocks(data: bytes):
    """Walk a GIF89a file's blocks: ``(width, height, [(delay cs, loop or
    None, (left, top, w, h, local table entries, LZW bytes)) ...], trailer
    seen)``, one entry per image. Raises on a malformed block."""
    if data[:6] != b"GIF89a":
        raise AssertionError(f"not a GIF89a header: {data[:6]!r}")
    w, h = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    packed = data[10]
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)

    def sub_blocks(pos):
        n = 0
        while data[pos]:
            n += data[pos]
            pos += data[pos] + 1
        return pos + 1, n

    images, delay, loop = [], None, None
    while pos < len(data):
        tag = data[pos]
        if tag == 0x3B:
            return w, h, images, loop, pos == len(data) - 1
        if tag == 0x21:
            label = data[pos + 1]
            if label == 0xF9:
                delay = int.from_bytes(data[pos + 4:pos + 6], "little")
            if label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                loop = int.from_bytes(data[pos + 16:pos + 18], "little")
            # an application block's 11-byte identifier, then its sub-blocks
            start = pos + 3 + data[pos + 2] if label == 0xFF else pos + 2
            pos, _ = sub_blocks(start)
        elif tag == 0x2C:
            left, top, iw, ih = (int.from_bytes(data[pos + k:pos + k + 2], "little")
                                 for k in (1, 3, 5, 7))
            ipacked = data[pos + 9]
            entries = 2 << (ipacked & 7) if ipacked & 0x80 else 0
            pos, n = sub_blocks(pos + 10 + 3 * entries + 1)
            images.append((delay, (left, top, iw, ih, entries, n)))
        else:
            raise AssertionError(f"unknown GIF block 0x{tag:02x} at byte {pos}")
    raise AssertionError("no GIF trailer")


@contextlib.contextmanager
def hidden_modules(*names):
    """Inside, ``import`` of each named module raises ImportError, as on a
    machine without it."""
    saved = {name: sys.modules.get(name) for name in names}
    try:
        sys.modules.update({name: None for name in names})
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def phase_render_cli(dev, ckpt: Path, tmp: Path):
    """``python -m minimal_nerf_torch.render`` as a user calls it, on the
    card: 4 poses at 64x64 from the ``[main]`` checkpoint through
    ``render.main``, which writes ``{save_dir}/{epoch}-360.gif`` with
    whatever image package the machine has, else the port's own GIF
    writer; once as the machine is and twice with imageio and PIL hidden,
    at ``--frames-per-dispatch`` 8 (the default) and 1, which must write the
    same bytes; each file's blocks walked."""
    from minimal_nerf_torch import render
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.utils import imageio as mio

    poses, size = 4, 64
    hidden = lambda: hidden_modules("imageio", "imageio.v2", "PIL", "PIL.Image")  # noqa: E731
    want_launches = poses * math.ceil(size * size / RAYS) * 2
    written = {}
    for packages, fpd, context in (("as installed", 8, contextlib.nullcontext()),
                                   ("hidden", 8, hidden()), ("hidden", 1, hidden())):
        save_dir = tmp / "recons" / f"{packages.replace(' ', '_')}_{fpd}"
        with context:
            backend = mio._backend()[0]
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render.main(["-c", str(ckpt), "-r", str(RAYS), "-p", str(poses), "--height",
                               str(size), "--width", str(size), "-s", str(save_dir),
                               "--frames-per-dispatch", str(fpd)])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / poses
        launches = launched(fr.FWD_LAUNCHES)
        data = out.read_bytes()
        written[(packages, fpd)] = data
        w, h, images, loop, trailer = gif_blocks(data)
        want_path = save_dir / f"{render.epoch_tag(str(ckpt))}-360.gif"
        ok = (out == want_path and (w, h) == (size, size) and len(images) == poses
              and loop == 0 and trailer and launches == want_launches
              and (packages != "hidden" or backend == "builtin")
              and all(d == 10 and im[:4] == (0, 0, size, size) and im[5] > 0
                      for d, im in images))
        same = fpd == 8 or data == written[(packages, 8)]
        print(f"[render-cli] render.main -p {poses} --height {size} --width {size} "
              f"--frames-per-dispatch {fpd} on the card, image packages {packages} (backend: "
              f"{backend}) wrote {out.name} ({len(data)} bytes"
              + ("" if fpd == 8 else f", the same bytes as at 8: {same}")
              + f") in {ms:.1f} ms per pose (the CLI's wall: checkpoint load, render and gif): "
              f"GIF89a {w}x{h}, {len(images)} image descriptors "
              f"(want {poses}) at {[im[:4] for _, im in images]}, local tables "
              f"{[im[4] for _, im in images]} entries, LZW bytes {[im[5] for _, im in images]}, "
              f"delays {[d for d, _ in images]} cs (want 10), loop {loop} (want 0), trailer "
              f"last: {trailer}; fused forward launches {launches} (want {want_launches}) "
              f"{'PASS' if ok and same else 'FAIL'}", flush=True)
        if not (ok and same):
            raise AssertionError("the render CLI's gif is not as expected")


TRAIN_FRAMES, TRAIN_STEPS = 20, 100
# train single's default samples per ray (train_nerf.py single -c)
SINGLE_SAMPLES = 128
VAL_FRAMES, TEST_FRAMES = 2, 4
# metrics.csv's columns, in order, of the JAX Trainer's run through the fused
# kernels with a validation, uniform and with occupancy (the card has no JAX:
# tests/test_torch_trainer.py holds these against the JAX Trainer's file)
TRAINER_COLUMNS = ["step", "grad_2.0_norm_total", "lr", "train_coarse_loss", "train_fine_loss",
                   "train_loss", "iterations_per_sec", "rays_per_sec", "train iteration speed",
                   "wall_seconds", "val_coarse_loss", "val_fine_loss", "val_loss", "val_seconds",
                   "ckpt_seconds"]
TRAINER_FAST_COLUMNS = TRAINER_COLUMNS[:3] + ["occ_fraction"] + TRAINER_COLUMNS[3:]


def make_train_scene(dev):
    """The procedural ``random_object`` scene: 20 train, 2 val and 4 test
    frames at 800x800, rendered on the card by the port's
    ``data/procedural.py``; returns split -> ``SyntheticScene``. The test
    split is drawn last: the train and val frames must equal those of the
    scene made without it."""
    from minimal_nerf_torch.data.procedural import make_procedural_scene

    splits = (("train", TRAIN_FRAMES), ("val", VAL_FRAMES), ("test", TEST_FRAMES))
    make = lambda s: make_procedural_scene(s, height=HW, width=HW, scene="object",  # noqa: E731
                                           seed=0, chunk=8192, device=dev)[0]
    t0 = time.perf_counter()
    scenes = make(splits)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    without = make(splits[:2])
    same = all(torch.equal(without[k].images, scenes[k].images)
               and torch.equal(without[k].poses, scenes[k].poses) for k in without)
    scene = scenes["train"]
    print(f"[train] scene: {TRAIN_FRAMES} train, {VAL_FRAMES} val and {TEST_FRAMES} test frames "
          f"{HW}x{HW} made on the card in {secs:.1f} s; train image mean "
          f"{scene.images.float().mean().item():.2f}; train and val frames equal to those of "
          f"the scene made without the test split: {same} {'PASS' if same else 'FAIL'}",
          flush=True)
    if not same:
        raise AssertionError("the test split changed the train or val frames")
    return scenes


def init_train_params(dev, cfg, density_bias: float = 0.0):
    """``init_nerf_network(seed)``, as the JAX trainer starts, plus
    ``density_bias`` on both density heads."""
    from minimal_nerf_torch.models.nerf import init_nerf_network

    params = init_nerf_network(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    for mlp in params.values():
        mlp["density"]["b"] += density_bias
    return params


def init_density_bias(dev, cfg, tcfg, scene) -> float:
    """0, unless the seeded init renders the first train batch all black
    (relu(sigma) = 0 everywhere: no gradient flows); then the render
    phase's +0.5."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.training import loop

    batch = loop.sample_train_batch(0, scene.images, scene.poses, loop.scene_static(scene),
                                    tcfg.num_rays, TRAIN_FRAMES, tcfg.cropping_epochs, 0,
                                    generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad(), uncounted():
        out = fr.render_rays_fused(init_train_params(dev, cfg), cfg, batch["origin"],
                                   batch["direc"], torch.Generator(device=dev).manual_seed(0),
                                   compute_dtype=tcfg.compute_dtype)
    peak = max(out[k].abs().max().item() for k in out)
    print(f"[train] seeded init's largest ray color on the first batch: {peak:.3e}"
          + (" (black: density bias +0.5 applied)" if peak == 0.0 else " (not black: no bias)"),
          flush=True)
    return 0.5 if peak == 0.0 else 0.0


def phase_train(dev, tmp: Path, scene):
    """100 full-width steps of ``make_train_step`` at ``TrainConfig()``
    defaults; a checkpoint of the result rendered through the render path."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.render import render_views
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import checkpoint_name, save_checkpoint
    from minimal_nerf_torch.training.config import TrainConfig

    cfg, tcfg = NeRFConfig(), TrainConfig()  # 64+128, 4096 rays, bf16, lr 5e-4
    bias = init_density_bias(dev, cfg, tcfg, scene)
    step_fn = loop.make_train_step(cfg, tcfg, loop.scene_static(scene), device=dev)
    params = init_train_params(dev, cfg, bias)
    step_fn(params, loop.adam_init(params), scene.images, scene.poses, 0, 0)  # warm-up
    params = init_train_params(dev, cfg, bias)
    state = loop.adam_init(params)
    reset_counts()
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, scene.images, scene.poses, step, 0)
        losses.append(metrics["train_loss"].item())
        times.append(time.perf_counter() - t0)
    counts = dict(fwd=launched(fr.FWD_LAUNCHES), bwd=launched(fr.BWD_LAUNCHES),
                  wgrad=launched(fr.WGRAD_LAUNCHES))
    ms = 1e3 * sorted(times)[len(times) // 2]
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    want = 2 * TRAIN_STEPS
    ok = (all(math.isfinite(x) for x in losses) and last < first
          and counts == dict(fwd=want, bwd=want, wgrad=want))
    print(f"[train] {TRAIN_STEPS} steps, {tcfg.num_rays} rays, {tcfg.precision}, "
          f"{cfg.coarse_samples}+{cfg.fine_samples} samples, width 256/128, lr {tcfg.start_lr}: "
          f"median ms/step={ms:.2f} rays/s={tcfg.num_rays / (ms / 1e3):.0f}; loss first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}, mean of first 10 {first:.5f} > last 10 "
          f"{last:.5f}: {last < first}; launches fwd={counts['fwd']} bwd={counts['bwd']} "
          f"wgrad={counts['wgrad']} (want {want} each = 2 passes x {TRAIN_STEPS} steps) "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("training did not run through the kernels as expected")
    ckpt = save_checkpoint(tmp / checkpoint_name("train", TRAIN_STEPS // TRAIN_FRAMES,
                                                 TRAIN_STEPS),
                           params, TRAIN_STEPS, cfg.to_dict(), tcfg.to_dict())
    frames_iter = render_views(str(ckpt), rays=RAYS, num_poses=1, height=HW, width=HW,
                               device=dev)
    with uncounted():
        before = launched(fr.FWD_LAUNCHES)
        frame = next(iter(frames_iter))
        renders = launched(fr.FWD_LAUNCHES) - before
    want_r = 2 * math.ceil(HW * HW / RAYS)
    ok = frame.shape == (HW, HW, 3) and str(frame.dtype) == "uint8" and renders == want_r
    print(f"[train] checkpoint {ckpt.name} rendered through the render path: {frame.shape} "
          f"{frame.dtype}, mean {float(frame.mean()):.2f}, forward launches {renders} (want "
          f"{want_r}) {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("render from the trained checkpoint failed")
    return dict(ms=ms, losses=losses, counts=counts, bias=bias, ckpt=ckpt), step_fn, params, state


def read_csv(path: Path):
    import csv

    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def run_train_cli(argv, occ_updates=None):
    """``train.main(argv)`` with the launch counts set to 0 just before;
    returns the last Trainer, the wall seconds and the counts after
    (``counts()`` order). ``occ_updates`` collects a 1 per grid update."""
    from minimal_nerf_torch import train
    from minimal_nerf_torch.ops import occupancy as occ

    count = lambda f: lambda *a, **k: occ_updates.append(1) or f(*a, **k)  # noqa: E731
    with (wrapped(occ, "update_grid_ema", count) if occ_updates is not None
          else contextlib.nullcontext()):
        reset_counts()
        t0 = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return trainer, wall, counts()


def phase_trainer(dev, tmp: Path, scenes, train_ms: float):
    """``python -m minimal_nerf_torch.train full`` on the card, with imageio
    and PIL hidden: the ``[train]`` scene written as a PNG tree and read
    back exactly; ``-s 220`` at the production defaults (fused, 64+128,
    4096 rays, bf16; a validation at step 200, epoch 10, with both val
    frames' losses and one 800x800 view); ``-l auto -s 240``; ``--fast -s
    200`` (occupancy, 16+48) with the warmup cut to 32 steps, at 1 and at 20
    steps per call (calls of 20 between the CSV rows: CUDA-graph replays).
    Checks the loss, metrics.csv's columns (the JAX Trainer's), the
    checkpoints, the val PNG, every kernel's launches and the graphs'
    captures and replays; that the two ``--fast`` runs' rows and checkpoints
    are bit-identical; prints the trainer's ms/step from its CSV beside
    ``[train]``'s, and its boundary timings. Returns the ``--fast`` ms/step by steps per call."""
    from minimal_nerf_torch.data.procedural import save_scene_tree
    from minimal_nerf_torch.data.synthetic import SyntheticScene
    from minimal_nerf_torch.training.checkpoint import load_checkpoint, read_header
    from minimal_nerf_torch.utils import imageio as mio

    tree, root = tmp / "tree", tmp / "runs"
    chunks = math.ceil(HW * HW / RAYS)
    with hidden_modules("imageio", "imageio.v2", "PIL", "PIL.Image"):
        backend = mio._backend()[0]
        t0 = time.perf_counter()
        save_scene_tree(scenes, tree)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = {split: SyntheticScene.load(tree, split, device=dev) for split in scenes}
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        same = all(torch.equal(loaded[k].images, v.images) and torch.equal(loaded[k].poses,
                                                                           v.poses)
                   and loaded[k].focal == v.focal for k, v in scenes.items())
        size = sum(f.stat().st_size for f in tree.rglob("*.png"))
        ok = same and backend == "builtin"
        print(f"[trainer] tree of {sum(v.num_frames for v in scenes.values())} frames "
              f"{HW}x{HW} ({size / 2**20:.1f} MiB of PNG, image packages hidden: backend "
              f"{backend}) written in {write_s:.2f} s, read back onto the card in {read_s:.2f} "
              f"s; decoded pixels, poses and focal equal the scene's: {same} "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("the scene tree did not read back as written")

        base = ["-rd", str(root), "--log-every", "20"]
        steps, val_step = 220, 10 * TRAIN_FRAMES
        trainer, wall, launched = run_train_cli(
            ["-n", "trainer", "-s", str(steps)] + base + ["full", "-b", str(tree)])
        run = root / "trainer"
        head, rows = read_csv(run / "metrics.csv")
        train_rows = [r for r in rows if r["train_loss"]]
        val_row = next(r for r in rows if r["val_loss"])
        loss = [float(r["train_loss"]) for r in train_rows]
        first, last = sum(loss[:3]) / 3, sum(loss[-3:]) / 3
        ckpts = sorted(p.name for p in (run / "checkpoints").glob("*.ckpt"))
        want_ckpts = [f"model=trainer-epoch={val_step // TRAIN_FRAMES}-step={val_step}.ckpt",
                      f"model=trainer-epoch={steps // TRAIN_FRAMES}-step={steps}.ckpt"]
        views = list((run / "images").glob(f"recon-val*-{val_step}.png"))
        view_shape = mio.imread(views[0]).shape if len(views) == 1 else None
        val_fwd = 2 * VAL_FRAMES + 2 * chunks
        want = (2 * steps + val_fwd, 2 * steps, 0, 0, 0, 0)
        ok = (head == TRAINER_COLUMNS and all(math.isfinite(x) for x in loss) and last < first
              and ckpts == want_ckpts and view_shape == (HW, HW, 3) and launched == want
              and int(val_row["step"]) == val_step and trainer.final_state[3] == steps)
        # steady rows: past the first window and before the validation
        steady = [r for r in train_rows if 20 < int(r["step"]) <= val_step]
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        ms = 1e3 * med([float(r["train iteration speed"]) for r in steady])
        print(f"[trainer] train.main -s {steps} --log-every 20 full -b TREE (fused, 64+128, "
              f"4096 rays, bf16, 20 frames per epoch) in {wall:.1f} s: loss mean of the first "
              f"3 rows {first:.5f} > last 3 {last:.5f}: {last < first}; metrics.csv columns "
              f"equal the JAX Trainer's: {head == TRAINER_COLUMNS}; checkpoints {ckpts}; val "
              f"view {[v.name for v in views]} decodes to {view_shape}; launches ({COUNTED}) "
              f"{launched} (want {want}: 2 per step, + {val_fwd} forward in the validation = "
              f"{VAL_FRAMES} val frames x 2 + {chunks} chunks x 2) "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("the train CLI's run is not as expected")
        print(f"[trainer] {card_line()}: steady ms/step={ms:.2f} rays/s="
              f"{RAYS / (ms / 1e3):.0f} (median of the CSV's {len(steady)} rows of 20 steps "
              f"at steps 40-{val_step}, no sync between steps) against [train]'s "
              f"hand-driven median {train_ms:.2f} ms/step (synced per step) in this call: "
              f"trainer overhead {ms - train_ms:+.2f} ms/step; validation at step {val_step}: "
              f"val_seconds={float(val_row['val_seconds']):.3f} ckpt_seconds="
              f"{float(val_row['ckpt_seconds']):.4f}; tree write {write_s:.2f} s, read "
              f"{read_s:.2f} s", flush=True)

        resumed, wall, launched = run_train_cli(
            ["-n", "trainer", "-s", str(steps + 20), "-l", "auto"] + base
            + ["full", "-b", str(tree)])
        _, rows = read_csv(run / "metrics.csv")
        want = (40, 40, 0, 0, 0, 0)
        new_ckpt = run / "checkpoints" / (f"model=trainer-epoch={(steps + 20) // TRAIN_FRAMES}"
                                          f"-step={steps + 20}.ckpt")
        ok = (str(resumed.resume_ckpt).endswith(want_ckpts[-1]) and launched == want
              and new_ckpt.is_file() and [r["step"] for r in rows][-2:] == [str(steps),
                                                                            str(steps + 20)]
              and resumed.final_state[3] == steps + 20)
        print(f"[trainer] train.main -l auto -s {steps + 20}: resumed from "
              f"{Path(resumed.resume_ckpt).name}, {wall:.1f} s, launches {launched} (want "
              f"{want}: 20 steps), wrote {new_ckpt.name}: {new_ckpt.is_file()}, CSV history "
              f"kept ({len(rows)} rows) {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("the train CLI did not resume as expected")

        fast_steps, fast_ms, fast_runs = val_step, {}, {}
        for spc in (1, 20):
            updates, name = [], "trainer-fast" if spc == 20 else f"trainer-fast-{spc}"
            with graph_calls() as seen:
                fast, wall, launched = run_train_cli(
                    ["-n", name, "-s", str(fast_steps), "--steps-per-call", str(spc)] + base
                    + ["full", "-b", str(tree), "--fast", "--occ-warmup-steps",
                       str(OCC_WARMUP)], occ_updates=updates)
            run = root / name
            head, rows = read_csv(run / "metrics.csv")
            ckpt = run / "checkpoints" / f"model={name}-epoch=10-step={fast_steps}.ckpt"
            leaves = read_header(ckpt)["num_leaves"] if ckpt.is_file() else None
            cfg = fast.train_config
            want_updates = len(range(0, fast_steps, cfg.occ_update_every))
            # at 20 per call the first step of the first call runs eagerly
            # and is captured once; the rest are replays, each counting the
            # launches its capture counted (``[multi-step]`` also counts a
            # replayed call's kernels in a trace)
            graphs = (1, fast_steps - 1) if spc > 1 else (0, 0)
            wrapped_steps = fast_steps + graphs[0]
            want = (2 * wrapped_steps + val_fwd, 2 * wrapped_steps, 0, 0, 0,
                    wrapped_steps + VAL_FRAMES + chunks)
            fracs = [float(r["occ_fraction"]) for r in rows if r["occ_fraction"]]
            ok = (head == TRAINER_FAST_COLUMNS and launched == want
                  and (seen["captures"], seen["replays"]) == graphs
                  and len(updates) == want_updates and leaves == 123
                  and (fast.nerf_config.coarse_samples, fast.nerf_config.fine_samples) == (16, 48)
                  and cfg.occupancy and cfg.steps_per_call == spc
                  and all(0.0 < f <= 1.0 for f in fracs))
            steady = [r for r in rows if r["train_loss"] and 20 < int(r["step"]) <= fast_steps]
            fast_ms[spc] = ms = 1e3 * med([float(r["train iteration speed"]) for r in steady])
            val_row = next(r for r in rows if r["val_loss"])
            fast_runs[spc] = (ckpt, rows)
            print(f"[trainer] train.main -s {fast_steps} full --fast --occ-warmup-steps "
                  f"{OCC_WARMUP} --steps-per-call {spc} (occupancy G={cfg.occ_resolution}, "
                  f"16+48{', 20 steps per call: one CUDA-graph replay per step' if spc > 1 else ''}"
                  f") in {wall:.1f} s: grid updates {len(updates)} (want {want_updates}); "
                  f"occ_fraction per row {[round(f, 4) for f in fracs]}; captures, replays "
                  f"({seen['captures']}, {seen['replays']}) (want {graphs}); wrapper launches "
                  f"({COUNTED}) {launched} (want {want}: {wrapped_steps} steps eager, captured "
                  f"or replayed x 2 passes, the sampler once per such step and per "
                  f"validation chunk, "
                  f"{VAL_FRAMES} + {chunks}); {ckpt.name}: {leaves} leaves "
                  f"(want 123); columns equal the JAX Trainer's: "
                  f"{head == TRAINER_FAST_COLUMNS}; steady ms/step={ms:.2f} rays/s="
                  f"{RAYS / (ms / 1e3):.0f}; val_seconds={float(val_row['val_seconds']):.3f} "
                  f"ckpt_seconds={float(val_row['ckpt_seconds']):.4f} "
                  f"{'PASS' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError("the train CLI's --fast run is not as expected")
        timing = {"iterations_per_sec", "rays_per_sec", "train iteration speed", "wall_seconds",
                  "val_seconds", "ckpt_seconds"}
        untimed = lambda rows: [{k: v for k, v in r.items() if k not in timing}  # noqa: E731
                                for r in rows]
        (ck1, rows1), (ck20, rows20) = fast_runs[1], fast_runs[20]
        _, l1 = load_checkpoint(ck1)
        _, l20 = load_checkpoint(ck20)
        same = (untimed(rows1) == untimed(rows20) and len(l1) == len(l20)
                and all((l1[i] == l20[i]).all() for i in range(len(l1))))
        print(f"[trainer] {card_line()}: --fast at 1 and 20 steps per call in this call: "
              f"steady ms/step {fast_ms[1]:.2f} -> {fast_ms[20]:.2f} (x"
              f"{fast_ms[1] / fast_ms[20]:.2f}); metrics.csv rows (timing columns aside) and "
              f"the step-{fast_steps} checkpoints' {len(l20)} leaves bit-identical: {same} "
              f"{'PASS' if same else 'FAIL'}", flush=True)
        if not same:
            raise AssertionError("--fast at 20 steps per call left the trajectory of 1 per call")
        return fast_ms


# [data-parallel] (b): two ranks share the one card over gloo, which takes
# CUDA tensors (NCCL takes one card per rank); its fp32 gate on a 10-step
# run against one process on the same draws, every leaf's L2 gap as a share
# of its change since the init and every step's loss and grad norm:
# an all-reduce that skips the division by the world size doubles the loss
# (Adam hides it in the leaves), one that drops rank 1's rows moves both
DP_STEPS, DP_FP32_STEPS, DP_FAST_STEPS = 20, 10, 40
DP_LEAF_SHARE, DP_METRIC_RTOL = 5e-2, 1e-3
DP_FAULTS = ("divide", "drop")


@contextlib.contextmanager
def faulty_reduce(fault):
    """Inside, ``parallel.distributed.all_reduce_mean`` is faulty: ``"divide"``
    sums without dividing by the world size, ``"drop"`` puts zeros in the
    place of rank 1's shard; ``None`` leaves it as it is."""
    import torch.distributed as dist

    from minimal_nerf_torch.parallel import distributed

    def around(orig):
        def faulty(tensors, mesh):
            flat = torch.cat([t.reshape(-1).float() for t in tensors])
            if fault == "drop" and mesh.rank == 1:
                flat = torch.zeros_like(flat)
            dist.all_reduce(flat)
            if fault == "drop":
                flat = flat / mesh.size
            out, offset = [], 0
            for t in tensors:
                out.append(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            return out
        return faulty

    with (wrapped(distributed, "all_reduce_mean", around) if fault
          else contextlib.nullcontext()):
        yield


def dp_steps(dev, scene, tcfg, steps: int, bias: float, mesh=None, timed=False):
    """``steps`` full-width steps of ``make_train_step`` (fused, 64+128,
    4096 rays) from the seeded init on the draws of seed 0, as one rank of
    ``mesh`` or alone: the final leaves, each step's loss and grad norm, and
    with ``timed`` each step's ms (synced) and its all-reduce's ms (CUDA
    events around ``all_reduce_mean``)."""
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.parallel import distributed
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    cfg = NeRFConfig()
    step_fn = loop.make_train_step(cfg, tcfg, loop.scene_static(scene), device=dev, mesh=mesh)
    params = init_train_params(dev, cfg, bias)
    state = loop.adam_init(params)
    spans, metrics, ms = [], [], []

    def around(orig):
        def timed_reduce(tensors, m):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(tensors, m)
            end.record()
            spans.append((start, end))
            return out
        return timed_reduce

    with (wrapped(distributed, "all_reduce_mean", around) if timed and mesh is not None
          else contextlib.nullcontext()):
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, scene.images, scene.poses, step, 0)
            metrics.append(torch.stack([m["train_loss"], m["grad_2.0_norm_total"]]))
            if timed:
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    reduce_ms = [s.elapsed_time(e) for s, e in spans]
    return ([t.detach().cpu() for t in flatten_tree(params)], torch.stack(metrics).cpu(), ms,
            reduce_ms)


def dp_worker(rank: int, world: int, coordinator: str, tree: str, out_dir: str, bias: float):
    """Rank ``rank`` of ``[data-parallel]`` (b): ``world`` ranks on card 0
    over gloo. The fp32 steps (TF32 off) with the all-reduce as it is and
    with each fault; 20 timed bf16 steps; a ``--fast`` Trainer run over three
    grid updates. Writes its results to ``out_dir/rank{rank}.pt``."""
    import dataclasses as dc

    from minimal_nerf_torch.data.synthetic import SyntheticScene
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.parallel import distributed, make_mesh
    from minimal_nerf_torch.training.config import TrainConfig
    from minimal_nerf_torch.training.trainer import Trainer

    distributed.initialize(coordinator, world, rank, backend="gloo", device="cuda")
    try:
        mesh = make_mesh(world, device="cuda:0")
        dev = mesh.device
        scene = SyntheticScene.load(tree, "train", dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = {"backend": distributed.backend(), "device": str(dev)}
        for fault in (None, *DP_FAULTS):
            with faulty_reduce(fault), uncounted():
                out[fault or "ok"] = dp_steps(dev, scene, TrainConfig(precision="fp32"),
                                              DP_FP32_STEPS, bias, mesh)[:2]
        dp_steps(dev, scene, TrainConfig(), 2, bias, mesh)  # warm-up
        reset_counts()
        _, _, ms, reduce_ms = dp_steps(dev, scene, TrainConfig(), DP_STEPS, bias, mesh,
                                       timed=True)
        out["bf16"] = dict(ms=ms, reduce_ms=reduce_ms, counts=counts())
        tcfg = TrainConfig(occupancy=True, occ_warmup_steps=OCC_WARMUP, max_steps=DP_FAST_STEPS,
                           log_every=DP_FAST_STEPS)
        reset_counts()
        trainer = Trainer(dc.replace(NeRFConfig(), coarse_samples=16, fine_samples=48), tcfg,
                          tree, Path(out_dir) / f"runs{rank}", name="dpfast", device=dev,
                          mesh=mesh)
        trainer.fit()
        out["fast"] = dict(grid=trainer.final_state[2].cpu(), counts=counts(),
                           wrote=(Path(out_dir) / f"runs{rank}").exists())
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


def leaf_share(got, want, init):
    """The largest ``|got - want| / |want - init|`` (L2) over the leaves."""
    return max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b - c).clamp_min(1e-30))
               for a, b, c in zip(got, want, init))


def phase_data_parallel(dev, tmp: Path, bias: float):
    """``[data-parallel]``: (a) ``train --data-parallel 1 full`` over NCCL
    (a world of one in this process) at the published widths, 20 steps
    then 20 more at ``--steps-per-call 20`` (one CUDA graph holding the NCCL
    all-reduce), against the same two runs without the flag: rows and final
    checkpoint bit-identical; (b) two ranks on the one card over gloo (CUDA
    tensors, 4096 rays = 2048 per rank, 64+128, fused): 10 fp32 steps held
    against one process on the same draws with a gate that both faulty
    all-reduces fail, 20 timed bf16 steps per rank with the all-reduce's
    share, a ``--fast`` run whose grids stay bit-identical across the ranks;
    (c) ``render`` and ``score`` at the default ``--data-parallel 1`` (each
    chunk split over a one-card mesh) against the checkpoint's unsharded
    chunk: identical frames and scores."""
    import torch.multiprocessing as mp

    from minimal_nerf_torch.data.synthetic import SyntheticScene
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.parallel import distributed
    from minimal_nerf_torch.render import render_views
    from minimal_nerf_torch.score import calculate_scores
    from minimal_nerf_torch.training.checkpoint import (flatten_tree, latest_checkpoint,
                                                        load_checkpoint)
    from minimal_nerf_torch.training.config import TrainConfig

    card = card_line()
    tree, root = tmp / "tree", tmp / "dp"
    timing = {"iterations_per_sec", "rays_per_sec", "train iteration speed", "wall_seconds",
              "val_seconds", "ckpt_seconds"}
    untimed = lambda rows: [{k: v for k, v in r.items() if k not in timing}  # noqa: E731
                            for r in rows]

    # (a) a world of one over NCCL against no mesh
    runs = {}
    for name, flag in (("dp1", ["--data-parallel", "1"]), ("nodp", [])):
        base = ["-n", name, "-rd", str(root), "--log-every", "20"] + flag
        _, wall1, launched1 = run_train_cli(base + ["-s", "20", "full", "-b", str(tree)])
        with graph_calls() as seen:
            _, wall2, launched2 = run_train_cli(base + ["-s", "40", "-l", "auto",
                                                        "--steps-per-call", "20", "full",
                                                        "-b", str(tree)])
        _, rows = read_csv(root / name / "metrics.csv")
        ckpt = latest_checkpoint(root / name / "checkpoints")
        runs[name] = dict(rows=rows, ckpt=ckpt, leaves=load_checkpoint(ckpt)[1],
                          launched=(launched1, launched2), graphs=(seen["captures"],
                                                                   seen["replays"]),
                          ms=[1e3 * float(r["train iteration speed"]) for r in rows])
    a, b = runs["dp1"], runs["nodp"]
    same = (untimed(a["rows"]) == untimed(b["rows"]) and len(a["leaves"]) == len(b["leaves"])
            and all((a["leaves"][i] == b["leaves"][i]).all() for i in a["leaves"]))
    # the second run: its first step eager, its capture, 19 replays
    want = ((40, 40, 0, 0, 0, 0), (42, 42, 0, 0, 0, 0))
    ok = (same and a["launched"] == b["launched"] == want and a["graphs"] == (1, 19)
          and not torch.distributed.is_initialized())
    print(f"[data-parallel] (a) {card}: train --data-parallel 1 (NCCL, a world of one) -s 20, "
          f"then -l auto -s 40 --steps-per-call 20 (one CUDA graph with the all-reduce, "
          f"captures/replays {a['graphs']}), against the same without the flag: rows "
          f"(timings aside) and the step-40 checkpoint's {len(a['leaves'])} leaves "
          f"bit-identical: {same}; wrapper launches ({COUNTED}) per run dp1 {a['launched']} "
          f"no-mesh {b['launched']} (want {want}); ms/step from the CSV (steps 1-20 eager, "
          f"21-40 replayed) dp1 {[round(x, 2) for x in a['ms']]} no-mesh "
          f"{[round(x, 2) for x in b['ms']]} {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("--data-parallel 1 left the run without a mesh")

    # (b) two gloo ranks on the one card against one process
    out_dir = tmp / "dp2"
    out_dir.mkdir()
    coord = f"127.0.0.1:{distributed.free_port()}"
    t0 = time.perf_counter()
    mp.spawn(dp_worker, args=(2, coord, str(tree), str(out_dir), bias), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt") for r in (0, 1)]
    scene = SyntheticScene.load(tree, "train", dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with uncounted():
        init = [t.cpu() for t in flatten_tree(init_train_params(dev, NeRFConfig(), bias))]
        want_leaves, want_metrics, _, _ = dp_steps(dev, scene, TrainConfig(precision="fp32"),
                                                   DP_FP32_STEPS, bias)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    gaps = {}
    for name in ("ok", *DP_FAULTS):
        leaves, metrics = ranks[0][name]
        rel = float(((metrics - want_metrics).abs() / want_metrics.abs()).max())
        gaps[name] = (leaf_share(leaves, want_leaves, init), rel)
    passes = {k: g[0] <= DP_LEAF_SHARE and g[1] <= DP_METRIC_RTOL for k, g in gaps.items()}
    agree = all(torch.equal(x, y) for x, y in zip(ranks[0]["ok"][0], ranks[1]["ok"][0]))
    ok = passes["ok"] and not any(passes[f] for f in DP_FAULTS) and agree and all(
        r["backend"] == "gloo" for r in ranks)
    print(f"[data-parallel] (b) {card}: 2 ranks on {ranks[0]['device']} over "
          f"{ranks[0]['backend']} (CUDA tensors), {RAYS} rays = {RAYS // 2} per rank, 64+128, "
          f"fused, fp32 (TF32 off), {DP_FP32_STEPS} steps against one process on the same "
          f"draws: largest leaf L2 gap / its change since the init, largest relative gap of a "
          f"step's loss or grad norm: as built {gaps['ok'][0]:.3e}, {gaps['ok'][1]:.3e}; no "
          f"division by the world size {gaps['divide'][0]:.3e}, {gaps['divide'][1]:.3e}; "
          f"rank 1's rows dropped {gaps['drop'][0]:.3e}, {gaps['drop'][1]:.3e} (gate "
          f"{DP_LEAF_SHARE}, {DP_METRIC_RTOL}: {passes}); both ranks' leaves bit-identical: "
          f"{agree}; the spawn took {spawn_s:.1f} s {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("two gloo ranks left the one-process step, or a fault passed")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    per_rank = [(med(r["bf16"]["ms"]), med(r["bf16"]["reduce_ms"]), r["bf16"]["counts"])
                for r in ranks]
    want = (2 * DP_STEPS, 2 * DP_STEPS, 0, 0, 0, 0)
    ok = all(c == want for _, _, c in per_rank)
    print(f"[data-parallel] (b) {card}: {DP_STEPS} bf16 steps per rank (synced per step): "
          + "; ".join(f"rank {i} median ms/step={m:.2f} all-reduce {r:.2f} ms "
                      f"({100 * r / m:.1f}% of the step), wrapper launches ({COUNTED}) {c}"
                      for i, (m, r, c) in enumerate(per_rank))
          + f" (want {want} on every rank) {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("a rank did not launch the fused kernels on every step")
    grids = [r["fast"]["grid"] for r in ranks]
    updates = len(range(0, DP_FAST_STEPS, 16))
    ok = (torch.equal(grids[0], grids[1]) and float(grids[0].max()) > 0
          and ranks[0]["fast"]["wrote"] and not ranks[1]["fast"]["wrote"]
          and all(r["fast"]["counts"][5] >= DP_FAST_STEPS for r in ranks))
    print(f"[data-parallel] (b) {card}: Trainer --fast (occupancy G=64, 16+48) on 2 ranks, "
          f"{DP_FAST_STEPS} steps, {updates} grid updates: the ranks' grids bit-identical: "
          f"{torch.equal(grids[0], grids[1])} (max density {float(grids[0].max()):.3e}); "
          f"wrapper launches per rank {[r['fast']['counts'] for r in ranks]}; rank 0 wrote "
          f"its run: {ranks[0]['fast']['wrote']}, rank 1 wrote nothing: "
          f"{not ranks[1]['fast']['wrote']} {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the --fast ranks' grids parted or rank 1 wrote files")

    # (c) render and score split each chunk over a mesh of local cards (one
    # here, the default), held against the checkpoint's unsharded chunk
    from minimal_nerf_torch import fields, views
    from minimal_nerf_torch.ops.image_metrics import psnr, ssim
    from minimal_nerf_torch.training.trainer import load_state_for_inference

    ckpt = a["ckpt"]
    params, nerf_cfg, train_cfg, grid, _ = load_state_for_inference(str(ckpt), device=dev)
    if grid is not None:
        raise AssertionError(f"{ckpt.name} holds an occupancy grid: (c) wants none")
    unsharded = views.make_fine_render_chunk(params, nerf_cfg,
                                             compute_dtype=train_cfg.compute_dtype,
                                             render_fn=fields.kernel_hooks("fused", dev)[1])
    sweeps = {"mesh": render_views(str(ckpt), rays=RAYS, num_poses=2, height=HW, width=HW,
                                   device=dev),
              "unsharded": views.orbit_views(unsharded, height=HW, width=HW, chunk=RAYS,
                                             num_poses=2, device=dev)}
    frames, launched, ms = {}, {}, {}
    for name, sweep in sweeps.items():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames[name] = list(sweep)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0) / 2
        launched[name] = counts()
    with contextlib.redirect_stdout(io.StringIO()):
        scores = calculate_scores(str(ckpt), tree, RAYS, device=dev)
    test = SyntheticScene.load(tree, "test", dev)
    psnr_sum = ssim_sum = torch.zeros((), dtype=torch.float64, device=dev)
    for idx, recon in enumerate(views.render_poses_batched(
            unsharded, test.poses, test.height, test.width, test.focal, chunk=RAYS,
            device=dev, device_frames=True)):
        ssim_sum = ssim_sum + ssim(test.images[idx], recon)
        psnr_sum = psnr_sum + psnr(test.images[idx], recon)
    want_scores = tuple(v / test.num_frames for v in torch.stack([psnr_sum, ssim_sum]).tolist())
    same = (all((x == y).all() for x, y in zip(frames["mesh"], frames["unsharded"]))
            and scores == want_scores)
    want = (2 * 2 * math.ceil(HW * HW / RAYS), 0, 0, 0, 0, 0)
    ok = same and launched["mesh"] == launched["unsharded"] == want
    print(f"[data-parallel] (c) {card}: render of 2 {HW}x{HW} frames and score of the "
          f"{TEST_FRAMES} test frames from {ckpt.name} at the default --data-parallel 1 (each "
          f"chunk's uniforms drawn once, the chunk rendered on card 0 through the one-card "
          f"mesh) against the checkpoint's unsharded chunk: frames and scores (psnr, ssim) "
          f"{scores} identical: {same}; render launches {launched['mesh']} / "
          f"{launched['unsharded']} (want {want}); ms/frame {ms['mesh']:.1f} / "
          f"{ms['unsharded']:.1f} {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the one-card mesh changed the rendered frames or scores")


# the torch metrics on the card against the numpy version on the host, on
# the same frames: both sum integer-valued float64 window terms exactly, so
# they differ only in the order of the final means (~1e-16 relative)
METRIC_RTOL = 1e-9


def phase_score(dev, tmp: Path, init_ckpt: Path, pallas_ckpt: Path, fused_ckpt: Path):
    """``python -m minimal_nerf_torch.score`` as a user calls it, on the
    card, with imageio and PIL hidden, on the tree ``[trainer]`` wrote (its
    4-frame 800x800 test split): the trainer's 220-step 64+128 checkpoint
    at ``--frames-per-dispatch`` 1 and 8 (the same scores and frames; the
    card's metrics against the numpy version on those frames), its ``--fast``
    checkpoint (the sampler kernel), the ``[train-pallas]`` checkpoint (the
    point forward kernel) and the ``[train]`` one (fused, from the same init
    and draws, the same 100 steps: the pallas one's PSNR beside it), each by
    launch count; the seeded init ``[main]`` wrote must score a lower PSNR
    than the trained checkpoint.
    Then the time per scored frame split into the sweep alone and the
    metrics, and one sweep with its metrics under
    ``torch.cuda.set_sync_debug_mode("error")``: no wait for the device
    from the first chunk to the last metric."""
    import numpy as np

    from minimal_nerf_torch import score, views
    from minimal_nerf_torch.data.synthetic import SyntheticScene
    from minimal_nerf_torch.inference import build_render_chunk
    from minimal_nerf_torch.ops import image_metrics as im

    tree, runs = tmp / "tree", tmp / "runs"
    trained = runs / "trainer" / "checkpoints" / "model=trainer-epoch=11-step=220.ckpt"
    fast = runs / "trainer-fast" / "checkpoints" / "model=trainer-fast-epoch=10-step=200.ckpt"
    chunks, n = math.ceil(HW * HW / RAYS), TEST_FRAMES

    def scored(ckpt, fpd=8, kernel="auto"):
        """``score.main`` with the counts set to 0 just before and read just
        after; returns the scores, the frames, the counts and the wall s."""
        frames = []

        def around(sweep):
            def capturing(*args, **kwargs):
                for frame in sweep(*args, **kwargs):
                    frames.append(frame)
                    yield frame
            return capturing

        with wrapped(views, "render_poses_batched", around):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = score.main(["-c", str(ckpt), "-r", str(RAYS), "-b", str(tree),
                                 "--frames-per-dispatch", str(fpd), "--kernel", kernel])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return scores, frames, counts(), wall

    with hidden_modules("imageio", "imageio.v2", "PIL", "PIL.Image"):
        scene = SyntheticScene.load(tree, "test", dev)
        gts = scene.images.cpu().numpy()
        results = {fpd: scored(trained, fpd) for fpd in (1, 8)}
        (s1, f1, c1, w1), (s8, f8, c8, w8) = results[1], results[8]
        same_frames = len(f1) == len(f8) == n and all(torch.equal(a, b) for a, b in zip(f1, f8))
        plain = (float(np.mean([im.peak_signal_noise_ratio(g, f.cpu().numpy())
                                for g, f in zip(gts, f8)])),
                 float(np.mean([im.structural_similarity(g, f.cpu().numpy())
                                for g, f in zip(gts, f8)])))
        gaps = [abs(a - b) / abs(b) for a, b in zip(s8, plain)]
        want = (2 * chunks * n, 0, 0, 0, 0, 0)
        ok = (s1 == s8 and same_frames and c1 == c8 == want and max(gaps) <= METRIC_RTOL
              and all(math.isfinite(x) for x in s8))
        print(f"[score] score.main -r {RAYS} -b TREE ({n} test frames {HW}x{HW}) on "
              f"{trained.name} (64+128, fused): --frames-per-dispatch 1 psnr={s1[0]!r} "
              f"ssim={s1[1]!r}, 8 psnr={s8[0]!r} ssim={s8[1]!r}, identical: {s1 == s8}; frames "
              f"identical: {same_frames}; numpy version on the host on the same frames "
              f"psnr={plain[0]!r} ssim={plain[1]!r}, relative gaps {gaps[0]:.2e} / "
              f"{gaps[1]:.2e} (bound {METRIC_RTOL}); launches ({COUNTED}) {c1} and {c8} (want "
              f"{want}: {n} frames x {chunks} chunks x 2 passes) {'PASS' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError("the score of the trained checkpoint is not as expected")

        cases = {"--fast": (fast, (2 * chunks * n, 0, 0, 0, 0, chunks * n)),
                 "pallas": (pallas_ckpt, (0, 0, 2 * chunks * n, 0, 0, 0)),
                 "[train] fused": (fused_ckpt, want),
                 "seeded init": (init_ckpt, want)}
        other = {}
        for label, (ckpt, want_c) in cases.items():
            s, frames, c, wall = scored(ckpt)
            other[label] = s
            ok = c == want_c and len(frames) == n and all(math.isfinite(x) for x in s)
            if label == "seeded init":
                ok &= s[0] < s8[0]
            print(f"[score] score.main on the {label} checkpoint {Path(ckpt).name}: psnr="
                  f"{s[0]!r} ssim={s[1]!r} in {wall:.2f} s; launches ({COUNTED}) {c} (want "
                  f"{want_c})" + (f"; below the trained checkpoint's psnr {s8[0]:.4f}: "
                                  f"{s[0] < s8[0]}" if label == "seeded init" else "")
                  + f" {'PASS' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"the score of the {label} checkpoint is not as expected")
        # each of the two 100-step checkpoints through the other's render
        # path too, which tells a gap in the weights from one in the render
        crossed = {}
        for label, ckpt, kernel, want_c in (
                ("pallas", pallas_ckpt, "fused", want),
                ("[train] fused", fused_ckpt, "pallas", (0, 0, 2 * chunks * n, 0, 0, 0))):
            s_x, _, c, _ = scored(ckpt, kernel=kernel)
            crossed[label] = s_x
            if c != want_c or not all(math.isfinite(x) for x in s_x):
                raise AssertionError(f"the score of the {label} checkpoint through --kernel "
                                     f"{kernel} is not as expected: launches {c}")
        gap = other["pallas"][0] - other["[train] fused"][0]
        print(f"[score] 100 steps from one init and one set of draws: pallas psnr "
              f"{other['pallas'][0]!r} - fused psnr {other['[train] fused'][0]!r} = {gap:+.4f} "
              f"dB (ssim {other['pallas'][1] - other['[train] fused'][1]:+.5f}); rendered "
              f"through the other path: the pallas checkpoint through --kernel fused psnr "
              f"{crossed['pallas'][0]!r}, the fused one through --kernel pallas psnr "
              f"{crossed['[train] fused'][0]!r}", flush=True)

        render_chunk, _, _ = build_render_chunk(str(trained), RAYS, device=dev)
        sweep = lambda fpd: list(views.render_poses_batched(  # noqa: E731
            render_chunk, scene.poses, HW, HW, scene.focal, chunk=RAYS,
            frames_per_dispatch=fpd, device=dev, device_frames=True))
        pairs = list(zip(scene.images, f8))
        with uncounted():
            sweep_ms = {fpd: cuda_ms(lambda: sweep(fpd), warmup=1, reps=2) / n for fpd in (1, 8)}
            metric_ms = cuda_ms(lambda: [(im.psnr(g, f), im.ssim(g, f)) for g, f in pairs],
                                warmup=1, reps=3) / n
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                sums = [(im.psnr(g, f), im.ssim(g, f)) for g, f in zip(scene.images, sweep(8))]
            finally:
                torch.cuda.set_sync_debug_mode("default")
        again = [0.0, 0.0]
        for pair in sums:  # in order, as score.main sums them (no compensated sum())
            again = [a + x.item() for a, x in zip(again, pair)]
        again = tuple(a / n for a in again)
        print(f"[score] {card_line()}: per scored frame, --frames-per-dispatch 1: "
              f"{1e3 * w1 / n:.1f} ms of score.main's wall (checkpoint and test split load "
              f"included), the sweep alone {sweep_ms[1]:.1f} ms; 8: {1e3 * w8 / n:.1f} ms, the "
              f"sweep alone {sweep_ms[8]:.1f} ms; the metrics (PSNR + SSIM, float64 on the card) "
              f"{metric_ms:.2f} ms (CUDA events over 3 x {n} frames); one sweep with its metrics "
              f"under sync debug mode 'error' raised nothing and gives the same scores: "
              f"{again == s8} {'PASS' if again == s8 else 'FAIL'}", flush=True)
        if again != s8:
            raise AssertionError("the sync-free sweep's scores differ from score.main's")


def phase_convert(dev, tmp: Path):
    """``python -m minimal_nerf_torch.convert_ckpt``: the trainer's 220-step
    checkpoint exported to the reference's PyTorch Lightning format and
    converted back; the round trip's weights equal the original's, and its
    frame through the fused kernel is bit-identical."""
    from minimal_nerf_torch import convert_ckpt
    from minimal_nerf_torch.training.checkpoint import load_checkpoint

    src = tmp / "runs" / "trainer" / "checkpoints" / "model=trainer-epoch=11-step=220.ckpt"
    pl, back = tmp / "convert" / "pl.ckpt", tmp / "convert" / "model=back-epoch=11-step=220.ckpt"
    pl.parent.mkdir()
    t0 = time.perf_counter()
    convert_ckpt.main(["--reverse", "-i", str(src), "-o", str(pl)])
    convert_ckpt.main(["-i", str(pl), "-o", str(back)])
    secs = time.perf_counter() - t0
    payload = torch.load(pl, map_location="cpu", weights_only=False)
    (_, a), (hb, b) = load_checkpoint(src), load_checkpoint(back)
    # the last 40 leaves are the params (before them the Adam state)
    same = all((a[len(a) - 40 + i] == b[len(b) - 40 + i]).all() for i in range(40))
    chunks = math.ceil(HW * HW / RAYS)
    frames = [render_counted(p, dev) for p in (src, back)]
    equal = all(f[0].shape == (HW, HW, 3) for f in frames) and (frames[0][0] ==
                                                                frames[1][0]).all()
    want = (2 * chunks, 0, 0, 0, 0, 0)
    ok = bool(same and equal and hb["num_leaves"] == 122 and hb["step"] == 220
              and payload["global_step"] == 220 and len(payload["state_dict"]) == 40
              and all(f[1] == want for f in frames))
    print(f"[convert] convert_ckpt --reverse {src.name} -> PL (40 tensors, global_step "
          f"{payload['global_step']}, epoch {payload['epoch']}) and back -> {back.name} "
          f"({hb['num_leaves']} leaves, step {hb['step']}) in {secs:.2f} s: weights equal: "
          f"{bool(same)}; a frame {HW}x{HW} of each through the fused kernel (launches "
          f"{[f[1] for f in frames]}, want {want} each) bit-identical: {bool(equal)} "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the checkpoint's round trip through the PL format changed it")


def train_uniforms(n: int, cfg, gen, dev, occupancy: bool = False):
    """Shared draws of one render: the coarse sampler's (uniform jitter, or
    the occupancy sampler's eps and in-bin jitter) and the fine sampler's."""
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    coarse = (rand(n, 1), rand(n, cfg.coarse_samples)) if occupancy else rand(
        n, cfg.coarse_samples)
    return {"coarse": coarse, "eps": rand(n, 1), "jitter": rand(n, cfg.fine_samples, 1)}


def hold_step(tag: str, dev, cfg, tcfg, kernel: str, params, batch, uniforms, want,
              coarse_sampler=None, note: str = "", mode: str = "full"):
    """One train step (loss and gradients through ``kernel``'s render hooks,
    then Adam) on the card against the same step on the CPU (plain
    versions), from copies of ``params`` on shared batch and draws.
    ``coarse_sampler(device)`` gives each side's coarse sampler; ``want`` is
    the card's launch counts (the CPU's must be none); ``mode="single"``
    holds the coarse-only step of one MLP."""
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    to_cpu = lambda tree: map_params(lambda t: t.detach().cpu(), tree)  # noqa: E731
    lr = loop.make_lr_schedule(tcfg, TRAIN_FRAMES)(0)
    results, ran = [], []
    for device, p, b, u in (
            (dev, map_params(lambda t: t.detach().clone(), params), batch, uniforms),
            ("cpu", to_cpu(params), to_cpu(batch), to_cpu(uniforms))):
        mlp_apply, render_fn = loop.kernel_hooks(kernel, device, mode)
        with uncounted():
            before = counts()
            metrics, grads = loop.loss_and_grads(
                p, cfg, b, tcfg.compute_dtype, render_fn, uniforms=u, mlp_apply=mlp_apply,
                coarse_sampler=coarse_sampler(device) if coarse_sampler else None, mode=mode)
            ran.append(tuple(a - c for a, c in zip(counts(), before)))
        loop.adam_update(p, grads, loop.adam_init(p), lr)
        results.append((metrics["train_loss"].item(), flatten_tree(to_cpu(grads)),
                        flatten_tree(to_cpu(p))))
    (card_loss, card_g, card_p), (cpu_loss, cpu_g, cpu_p) = results
    errs = bwd_errors(card_g, cpu_g)
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    lr = float(lr)
    moved = [(a - b).abs() for a, b in zip(card_p, cpu_p)]
    p_max = max(m.max().item() for m in moved)
    p_mean = sum(m.sum().item() for m in moved) / sum(m.numel() for m in moved)
    # loss: bf16 rounding flips between kernel and plain move it by ~1e-4;
    # gradients: the backward kernel's bf16 bounds; Adam's first step moves
    # each weight by lr * g / (|g| + eps), so a gradient near 0 may move the
    # two sides by up to 2 lr, while on average they agree far closer
    ok = (loss_rel <= 1e-3 and bwd_within(errs, BWD_TOL["bf16"])
          and p_max <= 2.0 * lr * 1.001 and p_mean <= 0.05 * lr
          and ran == [want, (0,) * len(want)])
    print(f"[{tag}] one step, {batch['origin'].shape[0]} rays, bf16, --kernel {kernel}{note}, "
          f"card (kernels) vs CPU (plain), shared weights, batch and draws: launches "
          f"({COUNTED}) card {ran[0]} cpu {ran[1]} (want {want}, none); "
          f"loss card {card_loss:.6f} cpu {cpu_loss:.6f} (rel {loss_rel:.2e}, tol 1e-3); "
          f"gradients worst over the leaves max_rel={max(e[0] for e in errs):.3e} mean_rel="
          f"{max(e[1] for e in errs):.3e} (bounds {BWD_TOL['bf16'][0]} / {BWD_TOL['bf16'][1]}); "
          f"params after Adam max |d|={p_max:.3e} (tol 2 lr = {2 * lr:.1e}) mean |d|="
          f"{p_mean:.3e} (tol 0.05 lr) {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{tag}] train step on the card disagrees with the CPU reference")


def phase_train_reference(dev, scene, bias: float, kernel: str = "fused"):
    """One train step on the card (kernels) against the same step on the
    CPU (plain versions): shared weights, a 256-ray batch and shared draws,
    full width, bf16, through the render hooks of ``kernel``."""
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.config import TrainConfig

    cfg, tcfg = NeRFConfig(), TrainConfig(kernel=kernel)
    n = 256
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = loop.sample_train_batch(0, scene.images, scene.poses, loop.scene_static(scene), n,
                                    TRAIN_FRAMES, tcfg.cropping_epochs, 0, generator=gen)
    batch = {k: batch[k] for k in ("origin", "direc", "rgb")}
    # the card's step went through this path's kernels (2 passes each way),
    # the CPU's through none
    want = (2, 2, 0, 0, 0, 0) if kernel == "fused" else (0, 0, 2, 2, 0, 0)
    hold_step("train-reference" if kernel == "fused" else f"{kernel}-reference", dev, cfg, tcfg,
              kernel, init_train_params(dev, cfg, bias), batch,
              train_uniforms(n, cfg, gen, dev), want)


def phase_train_pallas(dev, tmp: Path, scene, bias: float):
    """100 full-width steps of the ``--kernel pallas`` path
    (``kernel_hooks("pallas")``: the point kernels under the plain render)
    at ``TrainConfig(kernel="pallas")``, otherwise the defaults; a
    checkpoint of the result rendered through ``--kernel auto``."""
    from minimal_nerf_torch import fields
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import raymarch as rm
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import checkpoint_name, save_checkpoint
    from minimal_nerf_torch.training.config import TrainConfig

    cfg, tcfg = NeRFConfig(), TrainConfig(kernel="pallas")
    mlp_apply, render_fn = loop.kernel_hooks(tcfg.kernel, dev)
    step_fn = loop.make_train_step(cfg, tcfg, loop.scene_static(scene), render_fn=render_fn,
                                   device=dev, mlp_apply=mlp_apply)
    params = init_train_params(dev, cfg, bias)
    with uncounted():
        step_fn(params, loop.adam_init(params), scene.images, scene.poses, 0, 0)  # warm-up
    params = init_train_params(dev, cfg, bias)
    state = loop.adam_init(params)
    reset_counts()
    losses, times, metrics = [], [], {}
    for step in range(TRAIN_STEPS):
        if step == TRAIN_STEPS - 1:
            with uncounted():
                before_last = cloned(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, scene.images, scene.poses, step, 0)
        losses.append(metrics["train_loss"].item())
        times.append(time.perf_counter() - t0)
    counts = dict(fwd=launched(rm.FWD_LAUNCHES), bwd=launched(rm.BWD_LAUNCHES),
                  fused=launched(fr.FWD_LAUNCHES) + launched(fr.BWD_LAUNCHES))
    ms = 1e3 * sorted(times)[len(times) // 2]
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    want = 2 * TRAIN_STEPS
    density = {k: round(v.item(), 2) for k, v in metrics.items() if k.endswith(
        ("_density_norms", "_density_non_zeros"))}
    ok = (all(math.isfinite(x) for x in losses) and last < first and len(density) == 4
          and counts == dict(fwd=want, bwd=want, fused=0))
    print(f"[train-pallas] {TRAIN_STEPS} steps, {tcfg.num_rays} rays, {tcfg.precision}, "
          f"{cfg.coarse_samples}+{cfg.fine_samples} samples, width 256/128, --kernel pallas: "
          f"median ms/step={ms:.2f} rays/s={tcfg.num_rays / (ms / 1e3):.0f}; loss first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}, mean of first 10 {first:.5f} > last 10 "
          f"{last:.5f}: {last < first}; last step's density metrics {density}; launches point "
          f"fwd={counts['fwd']} bwd={counts['bwd']} (want {want} each = 2 passes x "
          f"{TRAIN_STEPS} steps), fused={counts['fused']} (want 0) {'PASS' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("pallas training did not run through the point kernels as expected")
    path_gradient_gate(dev, scene, cfg, init_train_params(dev, cfg, bias), params, before_last)
    ckpt = save_checkpoint(tmp / checkpoint_name("pallas", TRAIN_STEPS // TRAIN_FRAMES,
                                                 TRAIN_STEPS),
                           params, TRAIN_STEPS, cfg.to_dict(), tcfg.to_dict())
    resolved = fields.resolve_kernel("auto", dev, trained=tcfg.kernel)
    # the frame is timed after a warm-up frame (the checkpoint load and the
    # weights' packing)
    frame, ran, ms_frame = render_counted(ckpt, dev, timed=True, kernel="auto")
    renders, fused = ran[2], ran[0]
    want_r = 2 * math.ceil(HW * HW / RAYS)
    ok = (resolved == "pallas" and frame.shape == (HW, HW, 3) and str(frame.dtype) == "uint8"
          and renders == want_r and fused == 0)
    print(f"[train-pallas] checkpoint {ckpt.name} (trained under --kernel pallas) rendered "
          f"through --kernel auto -> {resolved!r}: a frame {frame.shape} {frame.dtype}, mean "
          f"{float(frame.mean()):.2f}, ms/frame={ms_frame:.1f} (after a warm-up frame) rays/s="
          f"{HW * HW / (ms_frame / 1e3):.0f}, point forward launches {renders} (want {want_r} "
          f"= 157 chunks x 2 passes), fused launches {fused} (want 0) "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("render from the pallas-trained checkpoint failed")
    return dict(ms=ms, ms_frame=ms_frame, counts=counts, frame_launches=renders,
                ckpt=ckpt), step_fn, params, state


def path_gradient_gate(dev, scene, cfg, init, trained, stale):
    """``[train-pallas]``'s gate (ROADMAP Queue 3 fault 2): the fused and the
    pallas path's bf16 gradients at the seeded init (step 0's batch and
    draws) and at the pallas path's step-100 parameters (step 100's), every
    leaf's relative L2 gap within ``PATH_GRAD_TOL``; and the pallas path's
    gradients at its step-99 parameters (weights packed one step late)
    must fail that bound against the fused path's at step 100."""
    from minimal_nerf_torch.training.config import TrainConfig

    tcfg = TrainConfig()
    names = leaf_names(init)
    at0, _ = grad_gaps(dev, scene, cfg, tcfg, init, 0, 0)
    at100, _ = grad_gaps(dev, scene, cfg, tcfg, trained, TRAIN_STEPS, 0)
    g_f, _ = step_grads(dev, scene, cfg, tcfg, "fused", trained, TRAIN_STEPS, 0)
    g_s, _ = step_grads(dev, scene, cfg, tcfg, "pallas", stale, TRAIN_STEPS, 0)
    late = max(torch.stack([torch.linalg.norm(a - b) / torch.linalg.norm(a)
                            for a, b in zip(g_f, g_s)]).tolist())
    ok = max(at0 + at100) <= PATH_GRAD_TOL < late
    print(f"[train-pallas] gradients of both paths at shared parameters, bf16, "
          f"|g_fused - g_pallas| / |g_fused| per leaf (bound {PATH_GRAD_TOL}): at the seeded "
          f"init {gap_summary(names, at0)}; at the pallas path's step {TRAIN_STEPS} "
          f"{gap_summary(names, at100)}; the pallas gradients at step {TRAIN_STEPS - 1}'s "
          f"weights (packed one step late) against the fused ones: worst leaf {late:.3e}, "
          f"beyond the bound: {late > PATH_GRAD_TOL} {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the fused and pallas paths' gradients part at shared parameters")


def phase_pallas_reference(dev, scene, bias: float):
    """The ``--kernel pallas`` path on the card against the CPU: a 256-ray
    render (shared weights and draws), then one 256-ray train step."""
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.nerf import NeRFConfig, render_rays

    cfg, n = NeRFConfig(), 256
    gen = torch.Generator(device=dev).manual_seed(7)
    o, d, _ = sample_rays(n, 1, gen, dev)
    uniforms = train_uniforms(n, cfg, gen, dev)
    params = init_train_params(dev, cfg, bias)
    to_cpu = lambda tree: map_params(lambda t: t.cpu(), tree)  # noqa: E731
    with torch.no_grad(), uncounted():
        before = counts()
        card = render_rays(params, cfg, o, d, compute_dtype=torch.bfloat16,
                           mlp_apply=point_hook(dev), uniforms=uniforms)
        ran = tuple(a - c for a, c in zip(counts(), before))
        ref = render_rays(to_cpu(params), cfg, o.cpu(), d.cpu(), compute_dtype=torch.bfloat16,
                          mlp_apply=point_hook("cpu"), uniforms=to_cpu(uniforms))
    # same weights, draws and rounding points: the kernel and the plain
    # version differ only in the order of fp32 sums (see TOL)
    ok, msg = ran == (0, 0, 2, 0, 0, 0), [f"card launches ({COUNTED}) {ran}"]
    for k in ("coarse_rgb_rays", "fine_rgb_rays"):
        diff = (card[k].cpu() - ref[k]).abs()
        ok &= bool(torch.isfinite(card[k]).all()) and diff.max().item() <= 1e-3
        msg.append(f"{k} max_abs={diff.max().item():.3e} mean_abs={diff.mean().item():.3e}")
    print(f"[pallas-reference] {n} rays, bf16, card (point kernel) vs CPU (plain), shared "
          f"weights and draws: {'; '.join(msg)} (tol 1e-3) {'PASS' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("pallas render on the card disagrees with the CPU reference")
    phase_train_reference(dev, scene, bias, kernel="pallas")


def phase_single_reference(dev, scene, bias: float):
    """``mode="single"`` under ``--kernel pallas`` on the card against the
    CPU: a 256-ray ``render_single`` at 128 samples (shared weights and
    draws; the bounds of ``[pallas-reference]``), then one 256-ray single
    step (``hold_step``: loss, gradients, Adam)."""
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.nerf import NeRFConfig, render_single
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.config import TrainConfig

    cfg, tcfg, n = NeRFConfig(coarse_samples=SINGLE_SAMPLES), TrainConfig(kernel="pallas"), 256
    params = init_train_params(dev, cfg, bias)["coarse"]
    gen = torch.Generator(device=dev).manual_seed(17)
    o, d, _ = sample_rays(n, 1, gen, dev)
    uniforms = {"coarse": torch.rand((n, SINGLE_SAMPLES), generator=gen, device=dev)}
    to_cpu = lambda tree: map_params(lambda t: t.detach().cpu(), tree)  # noqa: E731
    with torch.no_grad(), uncounted():
        before = counts()
        card = render_single(params, cfg, o, d, compute_dtype=torch.bfloat16,
                             mlp_apply=point_hook(dev), uniforms=uniforms)
        ran = tuple(a - c for a, c in zip(counts(), before))
        ref = render_single(to_cpu(params), cfg, o.cpu(), d.cpu(), compute_dtype=torch.bfloat16,
                            mlp_apply=point_hook("cpu"), uniforms=to_cpu(uniforms))
    diff = (card["pred_rgbs"].cpu() - ref["pred_rgbs"]).abs()
    spread = ref["pred_rgbs"].std().item()
    ok = (ran == (0, 0, 1, 0, 0, 0) and bool(torch.isfinite(card["pred_rgbs"]).all())
          and diff.max().item() <= 1e-3)
    print(f"[single-reference] render_single {n} rays x {SINGLE_SAMPLES} samples, bf16, card "
          f"(point kernel) vs CPU (plain), shared weights and draws: card launches ({COUNTED}) "
          f"{ran} (want (0, 0, 1, 0, 0, 0)); pred_rgbs max_abs={diff.max().item():.3e} "
          f"mean_abs={diff.mean().item():.3e} (tol 1e-3; the CPU's std {spread:.3e}) "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("render_single on the card disagrees with the CPU reference")
    batch = loop.sample_train_batch(0, scene.images, scene.poses, loop.scene_static(scene), n,
                                    TRAIN_FRAMES, 0, 0, generator=gen)
    batch = {k: batch[k] for k in ("origin", "direc", "rgb")}
    hold_step("single-reference", dev, cfg, tcfg, "pallas", params, batch,
              {"coarse": torch.rand((n, SINGLE_SAMPLES), generator=gen, device=dev)},
              (0, 0, 1, 1, 0, 0), note=f", mode single at {SINGLE_SAMPLES} samples",
              mode="single")


def phase_single(dev, tmp: Path):
    """``python -m minimal_nerf_torch.train single`` on the card, with
    imageio and PIL hidden, on the tree ``[trainer]`` wrote: ``--kernel
    pallas -c 128 -r 4096`` in bf16 for 200 steps (a validation, its val
    view and a checkpoint at step 200, epoch 10), then ``-l auto -s 220``,
    then 20 steps under ``--kernel auto`` (the plain MLP, as in JAX).
    Gates: the point kernels' launches (forward = steps + val chunks,
    backward = steps, fused none; none at all under auto), a falling loss,
    a val loss below the seeded init's at the same draws, the resume from
    the step-200 checkpoint to step 220. Prints ms/step from the CSV.
    Returns the launch counts of the pallas run."""
    from minimal_nerf_torch.data.synthetic import SyntheticScene
    from minimal_nerf_torch.models.mlp import init_nerf_mlp
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import read_header
    from minimal_nerf_torch.utils import imageio as mio

    tree, root = tmp / "tree", tmp / "runs"
    chunks = math.ceil(HW * HW / RAYS)
    steps, val_step = 200, 10 * TRAIN_FRAMES
    base = ["-rd", str(root), "--log-every", "20"]
    cli = lambda *extra: (list(extra) + base + ["single", "-b", str(tree), "-c",  # noqa: E731
                                                str(SINGLE_SAMPLES)])
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    with hidden_modules("imageio", "imageio.v2", "PIL", "PIL.Image"):
        trainer, wall, launched = run_train_cli(cli("-n", "single", "-s", str(steps),
                                                    "--kernel", "pallas"))
        run = root / "single"
        head, rows = read_csv(run / "metrics.csv")
        train_rows = [r for r in rows if r["train_loss"]]
        val_row = next(r for r in rows if r["val_loss"])
        loss = [float(r["train_loss"]) for r in train_rows]
        first, last = sum(loss[:3]) / 3, sum(loss[-3:]) / 3
        ckpts = sorted(p.name for p in (run / "checkpoints").glob("*.ckpt"))
        want_ckpts = [f"model=single-epoch={val_step // TRAIN_FRAMES}-step={val_step}.ckpt"]
        header = read_header(run / "checkpoints" / want_ckpts[0]) if ckpts == want_ckpts else {}
        views = list((run / "images").glob(f"recon-val*-{val_step}.png"))
        view_shape = mio.imread(views[0]).shape if len(views) == 1 else None
        # the seeded init's val loss at the validation's own draws
        val = SyntheticScene.load(tree, "val", dev)
        cfg, tcfg = trainer.nerf_config, trainer.train_config
        init = init_nerf_mlp(torch.Generator(device=dev).manual_seed(tcfg.seed), device=dev)
        with uncounted():
            init_val = loop.make_batched_eval_step_single(
                cfg, tcfg, loop.scene_static(val), point_hook(dev))(
                init, val.images, val.poses, val_step, 0)["val_loss"].item()
        val_loss = float(val_row["val_loss"])
        want = (0, 0, steps + VAL_FRAMES + chunks, steps, 0, 0)
        ok = (all(math.isfinite(x) for x in loss) and last < first and ckpts == want_ckpts
              and header.get("extra") == {"mode": "single"} and header.get("num_leaves") == 62
              and view_shape == (HW, HW, 3) and launched == want and val_loss < init_val
              and int(val_row["step"]) == val_step and trainer.final_state[3] == steps
              and trainer.train_config.kernel == "pallas"
              and trainer.train_config.cropping_epochs == 0)
        steady = [r for r in train_rows if 20 < int(r["step"]) <= val_step]
        ms = 1e3 * med([float(r["train iteration speed"]) for r in steady])
        print(f"[single] train.main -s {steps} --kernel pallas single -c {SINGLE_SAMPLES} "
              f"(bf16, {RAYS} rays, 20 frames per epoch) in {wall:.1f} s: loss mean of the "
              f"first 3 rows {first:.5f} > last 3 {last:.5f}: {last < first}; val_loss at step "
              f"{val_step} {val_loss:.5f} < the seeded init's {init_val:.5f} at the same draws: "
              f"{val_loss < init_val}; checkpoints {ckpts} (mode single, "
              f"{header.get('num_leaves')} leaves); val view {[v.name for v in views]} "
              f"decodes to {view_shape}; launches ({COUNTED}) {launched} (want {want}: point "
              f"forward {steps} steps + {VAL_FRAMES} val frames + {chunks} view chunks, "
              f"backward {steps}) {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("train single is not as expected")
        print(f"[single] {card_line()}: steady ms/step={ms:.2f} rays/s={RAYS / (ms / 1e3):.0f} "
              f"(median of the CSV's {len(steady)} rows of 20 steps at steps 40-{val_step}); "
              f"validation at step {val_step}: val_seconds={float(val_row['val_seconds']):.3f} "
              f"ckpt_seconds={float(val_row['ckpt_seconds']):.4f}", flush=True)

        resumed, wall, r_launched = run_train_cli(cli("-n", "single", "-s", str(steps + 20),
                                                      "-l", "auto", "--kernel", "pallas"))
        _, rows = read_csv(run / "metrics.csv")
        want_r = (0, 0, 20, 20, 0, 0)
        new_ckpt = run / "checkpoints" / (f"model=single-epoch={(steps + 20) // TRAIN_FRAMES}"
                                          f"-step={steps + 20}.ckpt")
        ok = (str(resumed.resume_ckpt).endswith(want_ckpts[-1]) and r_launched == want_r
              and new_ckpt.is_file() and [r["step"] for r in rows][-2:] == [str(steps),
                                                                            str(steps + 20)]
              and resumed.final_state[3] == steps + 20)
        print(f"[single] train.main -l auto -s {steps + 20} single: resumed from "
              f"{Path(resumed.resume_ckpt).name}, {wall:.1f} s, launches {r_launched} (want "
              f"{want_r}: 20 steps), wrote {new_ckpt.name}: {new_ckpt.is_file()}, CSV history "
              f"kept ({len(rows)} rows) {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("train single did not resume as expected")

        auto, wall, a_launched = run_train_cli(cli("-n", "single-auto", "-s", "20", "--kernel",
                                                   "auto"))
        _, rows = read_csv(root / "single-auto" / "metrics.csv")
        a_loss = [float(r["train_loss"]) for r in rows if r["train_loss"]]
        ok = (a_launched == (0,) * 6 and auto.mlp_apply is None
              and auto.train_config.kernel == "fused" and a_loss
              and all(math.isfinite(x) for x in a_loss) and auto.final_state[3] == 20)
        print(f"[single] train.main -s 20 --kernel auto single: resolved to "
              f"{auto.train_config.kernel!r} = the plain MLP (as in JAX), {wall:.1f} s, loss at "
              f"step 20 {a_loss[-1] if a_loss else None}; launches {a_launched} (want none) "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("train single --kernel auto is not as expected")
    return dict(launched=launched, ms=ms)


def phase_simple(dev, tmp: Path):
    """``python -m minimal_nerf_torch.train simple`` on the card, with
    imageio and PIL hidden: ``-i`` an 800x800 train PNG of the ``[trainer]``
    tree, ``-r 4096``, 300 steps (a CSV row every 100, the reconstruction at
    the last). Gates: a falling loss, the reconstruction PNG, and its PSNR
    against the photo above the seeded init's. Prints ms/step: the median
    interval between two steps' calls (no sync between them but at the CSV
    rows), and the run's wall over its steps."""
    import numpy as np

    from minimal_nerf_torch import views
    from minimal_nerf_torch.models.image_nerf import image_nerf_apply, init_image_nerf
    from minimal_nerf_torch.ops import image_metrics as im
    from minimal_nerf_torch.utils import imageio as mio

    from minimal_nerf_torch.training import simple

    photo, root, steps = tmp / "tree" / "train" / "r_0.png", tmp / "runs", 300
    recon_s, calls = [], []

    def stamped(fn):
        def run(*args, **kwargs):
            calls.append(time.perf_counter())
            return fn(*args, **kwargs)
        return run

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            recon_s.append(time.perf_counter() - t0)
            return out
        return run

    with hidden_modules("imageio", "imageio.v2", "PIL", "PIL.Image"), \
            wrapped(views, "photo_nerf_to_image", timed), wrapped(simple, "simple_step", stamped):
        params, wall, launched = run_train_cli(["-n", "simple", "-s", str(steps), "-r", str(RAYS),
                                                "-rd", str(root), "simple", "-i", str(photo)])
        run = root / "simple"
        _, rows = read_csv(run / "metrics.csv")
        loss = [float(r["train_loss"]) for r in rows]
        recons = sorted(p.name for p in (run / "images").glob("recon-*.png"))
        gt = mio.imread(photo)
        recon = mio.imread(run / "images" / f"recon-{steps}.png") if recons else None
        init = init_image_nerf(torch.Generator(device=dev).manual_seed(0), 10, dev)
        init_im = views.photo_nerf_to_image(lambda c: image_nerf_apply(init, c, 10), HW, HW,
                                            device=dev)
    init_psnr = im.peak_signal_noise_ratio(gt, (np.clip(init_im, 0, 1) * 255).astype(np.uint8))
    psnr = im.peak_signal_noise_ratio(gt, recon) if recon is not None else float("nan")
    wall_ms = 1e3 * (wall - recon_s[0]) / steps if recon_s else float("nan")
    gaps = sorted(b - a for a, b in zip(calls[10:], calls[11:]))
    ms = 1e3 * gaps[len(gaps) // 2] if gaps else float("nan")
    ok = (len(calls) == steps and len(loss) == steps // 100 and all(math.isfinite(x) for x in loss)
          and loss[-1] < loss[0] and recons == [f"recon-{steps}.png"]
          and recon.shape == (HW, HW, 3) and psnr > init_psnr and launched == (0,) * 6)
    print(f"[simple] train.main -s {steps} -r {RAYS} simple -i {photo.parent.name}/{photo.name} "
          f"({HW}x{HW}, position_dim 10, 10-layer MLP, Adam 5e-4) in {wall:.1f} s: loss per "
          f"row {[round(x, 5) for x in loss]} falls: {loss[-1] < loss[0]}; {recons} "
          f"{None if recon is None else recon.shape}; its psnr against the photo {psnr:.4f} > "
          f"the seeded init's {init_psnr:.4f}: {psnr > init_psnr}; kernel launches {launched} "
          f"(want none: no TPU kernel computes this model) {'PASS' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("train simple is not as expected")
    print(f"[simple] {card_line()}: steady ms/step={ms:.3f} (the median interval between two "
          f"steps' calls from step 10), {RAYS / (ms / 1e3):.0f} pixels/s; train.main's wall "
          f"less the reconstruction's {recon_s[0]:.3f} s over {steps} steps: {wall_ms:.3f} "
          f"ms/step (the photo's decode and the init included)", flush=True)
    return dict(ms=ms, psnr=psnr)


OCC_WARMUP = 32  # the fast recipe's 256 warmup steps, cut so 100 steps leave the warmup


def render_counted(ckpt, dev, frames: int = 1, timed: bool = False, **options):
    """Render ``frames`` 800x800 orbit frames from ``ckpt`` through
    ``render_views``; returns the last frame, the launch counts of the
    frames (``counts()`` order) and their ms per frame, the checkpoint load
    outside the timing (with ``timed``, after one warm-up frame of a render
    of its own, whose launches do not count)."""
    from minimal_nerf_torch.render import render_views

    if timed:
        with uncounted():
            list(render_views(str(ckpt), rays=RAYS, num_poses=1, height=HW, width=HW,
                              device=dev, **options))
    frames_iter = render_views(str(ckpt), rays=RAYS, num_poses=frames, height=HW, width=HW,
                               device=dev, **options)
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for frame in frames_iter:
        pass
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / frames
    return frame, tuple(a - b for a, b in zip(counts(), before)), ms


def phase_train_occ(dev, tmp: Path, scene, start_params, uniform_ckpt: Path):
    """100 full-width steps of the fast recipe (``TrainConfig(occupancy=True)``
    at 16 coarse + 48 fine samples, bf16, ``--kernel auto`` -> fused, the
    probe method ``auto`` -> the probe kernel; warmup cut to 32 steps) from
    the weights ``[train]`` reached and a fresh Adam state and grid; a
    checkpoint with its grid and Adam state, and frames rendered through its
    grid, with ``--ignore-occupancy``, and through a grid baked from the
    uniform ``[train]`` checkpoint.

    From the seeded init the coarse net's density is positive almost
    everywhere, and the grid's EMA (``max(0.9 ema, sigma)`` every 16 steps)
    keeps every cell occupied for hundreds of steps after the field has
    emptied: 100 steps from there would never show the grid guiding a
    sample. The ``[train]`` weights' field is already sparse."""
    from minimal_nerf_torch.fields import NeRFField
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import occupancy_probe as op
    from minimal_nerf_torch.kernels import occupancy_sampler as osk
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.ops import occupancy as occ
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import (checkpoint_name, load_checkpoint,
                                                        save_checkpoint)
    from minimal_nerf_torch.training.config import TrainConfig

    cfg = NeRFConfig(coarse_samples=16, fine_samples=48)
    tcfg = TrainConfig(occupancy=True, occ_warmup_steps=OCC_WARMUP)
    occ_cfg = tcfg.occupancy_config
    mlp_apply, render_fn = loop.kernel_hooks(tcfg.kernel, dev)
    step_fn = loop.make_train_step(cfg, tcfg, loop.scene_static(scene), render_fn=render_fn,
                                   device=dev, mlp_apply=mlp_apply, occupancy_cfg=occ_cfg)
    copy = lambda: map_params(lambda t: t.detach().clone(), start_params)  # noqa: E731
    params = copy()
    with uncounted():  # warm-up
        step_fn(params, loop.adam_init(params), occ.init_grid(occ_cfg, dev), scene.images,
                scene.poses, 0, 0)
    params = copy()
    state, grid = loop.adam_init(params), occ.init_grid(occ_cfg, dev)

    def live_share():
        """The occupied share of the coarse net's density field as it is now
        (one jittered probe per cell, no EMA)."""
        sigma = occ.update_grid_ema(occ.init_grid(occ_cfg, dev), NeRFField(cfg), params,
                                    occ_cfg, torch.Generator(device=dev).manual_seed(0),
                                    compute_dtype=tcfg.compute_dtype)
        return occ.occupancy_mask(sigma, occ_cfg).float().mean().item()

    live_start = live_share()
    updates = []
    count_updates = lambda f: lambda *a, **k: updates.append(1) or f(*a, **k)  # noqa: E731
    losses, fractions, times = [], [], []
    with wrapped(occ, "update_grid_ema", count_updates):
        reset_counts()
        for step in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, grid, metrics = step_fn(params, state, grid, scene.images,
                                                   scene.poses, step, 0)
            losses.append(metrics["train_loss"].item())
            times.append(time.perf_counter() - t0)
            fractions.append(metrics["occ_fraction"].item())
    step_launches = dict(fwd=launched(fr.FWD_LAUNCHES), bwd=launched(fr.BWD_LAUNCHES),
                         wgrad=launched(fr.WGRAD_LAUNCHES), probe=launched(op.LAUNCHES),
                         sampler=launched(osk.LAUNCHES))
    live_end = live_share()
    ms = 1e3 * sorted(times)[len(times) // 2]
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    want_updates = len(range(0, TRAIN_STEPS, occ_cfg.update_every))
    want = dict(fwd=2 * TRAIN_STEPS, bwd=2 * TRAIN_STEPS, wgrad=2 * TRAIN_STEPS, probe=0,
                sampler=TRAIN_STEPS)
    ok = (all(math.isfinite(x) for x in losses) and last < first
          and len(updates) == want_updates and step_launches == want
          and all(f == 1.0 for f in fractions[:OCC_WARMUP]) and 0.0 < fractions[-1] < 1.0)
    print(f"[train-occ] {TRAIN_STEPS} steps, {tcfg.num_rays} rays, {tcfg.precision}, "
          f"{cfg.coarse_samples}+{cfg.fine_samples} samples, width 256/128, occupancy G="
          f"{occ_cfg.resolution} (warmup {OCC_WARMUP} steps, cut from 256; an update every "
          f"{occ_cfg.update_every}), --kernel {tcfg.kernel}, probe {occ_cfg.probe_method}: "
          f"median ms/step={ms:.2f} rays/s={tcfg.num_rays / (ms / 1e3):.0f}; loss first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}, mean of first 10 {first:.5f} > last 10 "
          f"{last:.5f}: {last < first}; grid updates {len(updates)} (want {want_updates}); "
          f"occ_fraction {fractions[0]:.4f} at step 0, {fractions[OCC_WARMUP - 1]:.4f} at "
          f"step {OCC_WARMUP - 1}, {fractions[OCC_WARMUP]:.4f} at step {OCC_WARMUP}, "
          f"{fractions[-1]:.4f} at the end (want 1 in the warmup, strictly between 0 and 1 at "
          f"the end; the live density field's occupied share {live_start:.4f} at the start, "
          f"{live_end:.4f} at the end); launches {step_launches} (want {want}) "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("occupancy training did not run as expected")

    ckpt = save_checkpoint(tmp / checkpoint_name("occ", TRAIN_STEPS // TRAIN_FRAMES, TRAIN_STEPS),
                           params, TRAIN_STEPS, cfg.to_dict(), tcfg.to_dict(), opt_state=state,
                           grid=grid)
    header, leaves = load_checkpoint(ckpt)
    saved_ok = (header["num_leaves"] == len(leaves) == 123 and int(leaves[1]) == TRAIN_STEPS
                and leaves[0].shape == grid.shape and (leaves[0] == grid.cpu().numpy()).all())
    chunks = math.ceil(HW * HW / RAYS)
    frame, ran, ms_frame = render_counted(ckpt, dev, timed=True)
    frame_ok = ran == (2 * chunks, 0, 0, 0, 0, chunks)
    frame_means = [float(frame.mean())]
    for options, want_ran in (
            (dict(ignore_occupancy=True), (2 * chunks, 0, 0, 0, 0, 0)),
            (dict(bake_occupancy=True, coarse=16, fine=48, ckpt=uniform_ckpt),
             (2 * chunks, 0, 0, 0, 0, chunks))):
        other, other_ran, _ = render_counted(options.pop("ckpt", ckpt), dev, **options)
        frame_ok &= other_ran == want_ran and other.shape == (HW, HW, 3)
        frame_means.append(float(other.mean()))
        ran += other_ran
    ok = saved_ok and frame_ok and frame.shape == (HW, HW, 3) and str(frame.dtype) == "uint8"
    print(f"[train-occ] checkpoint {ckpt.name}: {header['num_leaves']} leaves (want 123: the "
          f"grid at leaf 0), Adam count {int(leaves[1])} (want {TRAIN_STEPS}); a frame "
          f"{HW}x{HW} through its grid (--kernel auto): ms/frame={ms_frame:.1f} (after a "
          f"warm-up frame) rays/s={HW * HW / (ms_frame / 1e3):.0f}, its launches ({COUNTED}) "
          f"{ran[:6]} (want sampler {chunks} = 1 per chunk, probe 0, fused fwd {2 * chunks}); "
          f"then one frame with --ignore-occupancy {ran[6:12]} (want sampler 0) and one with "
          f"--bake-occupancy -c 16 -f 48 from {uniform_ckpt.name} {ran[12:]}; frame "
          f"means {[round(m, 2) for m in frame_means]} {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("render from the occupancy checkpoint failed")
    return (dict(ms=ms, ms_frame=ms_frame, counts=step_launches, frame_samplers=ran[5], ckpt=ckpt),
            step_fn, params, state, grid, cfg, tcfg)


def phase_occ_reference(dev, scene, params, grid, cfg, tcfg):
    """One occupancy step on the card against the same step on the CPU, on
    the trained weights and grid of ``[train-occ]`` and shared draws: the
    grid update (plain MLP in bf16) and its packed words, then loss,
    gradients and Adam with the CPU's words on both sides. An update in fp32
    and one with decay 1.0 must fail the grid's bounds."""
    import dataclasses

    from minimal_nerf_torch.fields import NeRFField
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.ops import occupancy as occ
    from minimal_nerf_torch.training import loop

    occ_cfg = tcfg.occupancy_config
    n, g = 256, occ_cfg.resolution
    gen = torch.Generator(device=dev).manual_seed(9)
    batch = loop.sample_train_batch(0, scene.images, scene.poses, loop.scene_static(scene), n,
                                    TRAIN_FRAMES, tcfg.cropping_epochs, 0, generator=gen)
    batch = {k: batch[k] for k in ("origin", "direc", "rgb")}
    jitter = torch.rand((g ** 3, 3), generator=gen, device=dev)
    cpu_p = map_params(lambda t: t.detach().cpu(), params)
    want = occ.update_grid_ema(grid.cpu(), NeRFField(cfg), cpu_p, occ_cfg,
                               compute_dtype=tcfg.compute_dtype, jitter=jitter.cpu())
    cpu_words = occ.pack_occupancy(want, occ_cfg)
    scale = want.abs().max().item()

    def held(ucfg, dtype):
        """The card's update under ``ucfg`` in ``dtype`` against the CPU's:
        (max |d|, mean |d|) as shares of the largest density, the share of
        differing words, the cells of other occupancy, and whether all three
        stay within their bounds."""
        new = occ.update_grid_ema(grid, NeRFField(cfg), params, ucfg, compute_dtype=dtype,
                                  jitter=jitter).cpu()
        diff = (new - want).abs()
        words_differ = (occ.pack_occupancy(new, occ_cfg) != cpu_words).float().mean().item()
        cells = int((occ.occupancy_mask(new, occ_cfg) != occ.occupancy_mask(want, occ_cfg)).sum())
        errs = (diff.max().item() / scale, diff.mean().item() / scale, words_differ)
        return errs, cells, (errs[0] <= OCC_GRID_TOL[0] and errs[1] <= OCC_GRID_TOL[1]
                             and errs[2] <= OCC_WORDS_TOL)

    errs, cells, ok = held(occ_cfg, tcfg.compute_dtype)
    controls = {"fp32 update": held(occ_cfg, None),
                "decay 1.0": held(dataclasses.replace(occ_cfg, decay=1.0), tcfg.compute_dtype)}
    caught = not any(c[2] for c in controls.values())
    fmt = lambda e: f"max {e[0]:.2e} mean {e[1]:.2e} words {e[2]:.2e}"  # noqa: E731
    faulty = ", ".join(f"{k}: {fmt(c[0])}, {c[1]} cells" for k, c in controls.items())
    print(f"[occ-reference] grid update at G={g} on the trained weights, bf16, card vs CPU, "
          f"shared jitter, as shares of the largest density {scale:.3e}: {fmt(errs)} (bounds "
          f"{OCC_GRID_TOL[0]} / {OCC_GRID_TOL[1]} / {OCC_WORDS_TOL}); cells of other occupancy "
          f"{cells} of {g ** 3}; faulty updates {{{faulty}}} "
          f"(each must fail a bound) {'PASS' if ok and caught else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("occupancy grid update on the card disagrees with the CPU")
    if not caught:
        raise AssertionError("a faulty occupancy grid update passed the bounds")
    hold_step("occ-reference", dev, cfg, tcfg, "fused", params, batch,
              train_uniforms(n, cfg, gen, dev, occupancy=True), (2, 2, 0, 0, 0, 1),
              coarse_sampler=lambda device: occ.make_occupancy_sampler(cpu_words.to(device),
                                                                       occ_cfg),
              note=", occupancy sampler on the CPU's words")



# steps per call of [multi-step]: the fast recipe's --steps-per-call
MULTI_STEPS = 20


def kept_memory():
    """``(reserved, allocated)`` device bytes after ``torch.cuda.empty_cache``
    has released every cached block it can: what stays reserved beyond the
    allocated bytes is held by live segments, among them a live CUDA graph's
    private pool, which the cache cannot release."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()


def phase_multi_step(dev, scene, bias: float, trained_params):
    """Several train steps per call (``loop.make_multi_step``), as one
    captured CUDA graph of the step replayed once per step: for fused bf16
    and pallas bf16 at 64+128 from the seeded init, and the fast recipe
    (occupancy G=64, 16+48) from the ``[train]`` weights, two calls of
    ``MULTI_STEPS`` against as many eager steps from the same state. The
    parameters, Adam moments, grid and last metrics must be bit-identical;
    the second call runs under ``torch.cuda.set_sync_debug_mode("error")``.
    The wrappers' counts over the two calls must be two eager steps' (the
    first step runs eagerly, then is captured: a capture records each launch
    once); a third call's kernels, counted by name in a profiler trace
    (``traced_launches``), must be ``MULTI_STEPS`` eager steps'. The fast
    case starts at step 4 with its warmup cut to 30, so both calls hold a
    grid update between replays and the second the warmup's end. Prints the
    capture's host time, the peak device memory of the eager steps, of the
    first call (its capture) and of the replayed call, and the memory kept
    with the cache emptied after the eager steps and after the first call
    (``kept_memory``: the graph's private pool stays reserved), and times the
    second call beside the eager steps of the same span, each as one block
    ended by a sync. Returns each case's counts and the fast case's call for
    ``[profile]``."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.ops import occupancy as occ
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree
    from minimal_nerf_torch.training.config import TrainConfig

    cases = {"fused": (NeRFConfig(), TrainConfig(), None, 0),
             "pallas": (NeRFConfig(), TrainConfig(kernel="pallas"), None, 0),
             "--fast": (NeRFConfig(coarse_samples=16, fine_samples=48),
                        TrainConfig(occupancy=True, occ_warmup_steps=30), trained_params, 4)}
    mib = lambda b: f"{b / 2 ** 20:.1f}"  # noqa: E731
    out = {}
    for label, (cfg, tcfg, start_params, start) in cases.items():
        occ_cfg = tcfg.occupancy_config
        static = loop.scene_static(scene)
        mlp_apply, render_fn = loop.kernel_hooks(tcfg.kernel, dev)

        def fresh():
            params = (map_params(lambda t: t.detach().clone(), start_params)
                      if start_params is not None else init_train_params(dev, cfg, bias))
            return [params, loop.adam_init(params),
                    occ.init_grid(occ_cfg, dev) if occ_cfg is not None else None]

        def call(fn, st, step):
            if st[2] is None:
                st[0], st[1], metrics = fn(st[0], st[1], scene.images, scene.poses, step, 0)
            else:
                st[0], st[1], st[2], metrics = fn(st[0], st[1], st[2], scene.images,
                                                  scene.poses, step, 0)
            return metrics

        def block(fn, st, steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for step in steps:
                metrics = call(fn, st, step)
            torch.cuda.synchronize()
            return metrics, 1e3 * (time.perf_counter() - t0) / MULTI_STEPS

        step_fn = loop.make_train_step(cfg, tcfg, static, render_fn, dev, mlp_apply, occ_cfg)
        eager = fresh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        block(step_fn, eager, range(start, start + MULTI_STEPS))
        eager_metrics, eager_ms = block(step_fn, eager, range(start + MULTI_STEPS,
                                                               start + 2 * MULTI_STEPS))
        eager_launches = counts()
        eager_sm90 = launched(fr.BWD_SM90_LAUNCHES)
        eager_peak = torch.cuda.max_memory_allocated()
        eager_kept = kept_memory()
        per_step = tuple(x // (2 * MULTI_STEPS) for x in eager_launches)

        multi_fn = loop.make_multi_step(cfg, tcfg, static, MULTI_STEPS, render_fn, dev,
                                        mlp_apply, occ_cfg)
        multi = fresh()
        with graph_calls() as seen:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            block(multi_fn, multi, [start])
            first_peak = torch.cuda.max_memory_allocated()
            graph_kept = kept_memory()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.set_sync_debug_mode("error")
            try:
                multi_metrics, multi_ms = block(multi_fn, multi, [start + MULTI_STEPS])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            replay_peak = torch.cuda.max_memory_allocated()
            multi_launches = counts()
            multi_sm90 = launched(fr.BWD_SM90_LAUNCHES)
            replays = launched("graph.replays")
            calls = dict(seen)
        same = (eager[1]["count"] == multi[1]["count"] == 2 * MULTI_STEPS
                and all((a is None and b is None) or torch.equal(a, b) for a, b in zip(
                    flatten_tree([eager[0], eager[1]["mu"], eager[1]["nu"], eager[2]]),
                    flatten_tree([multi[0], multi[1]["mu"], multi[1]["nu"], multi[2]])))
                and eager_metrics.keys() == multi_metrics.keys()
                and all(torch.equal(eager_metrics[k].cpu(), multi_metrics[k].cpu())
                        for k in eager_metrics))
        with graph_calls() as third:
            traced = traced_launches(lambda: call(multi_fn, multi, start + 2 * MULTI_STEPS))
        want_traced = tuple(MULTI_STEPS * p for p in per_step)
        # the eager first step, its capture and 2 * MULTI_STEPS - 1 replays
        want_multi = tuple((2 * MULTI_STEPS + 1) * p for p in per_step)
        ok = (same and eager_launches == tuple(2 * MULTI_STEPS * p for p in per_step)
              and any(per_step) and multi_launches == want_multi
              and calls["captures"] == 1 and calls["replays"] == 2 * MULTI_STEPS - 1
              and replays == calls["replays"] and third["captures"] == 0
              and traced == want_traced
              # every bf16 fused backward ran kernel A on wgmma, replayed or not
              and (eager_sm90, multi_sm90) == (eager_launches[1], multi_launches[1]))
        loss = float(multi_metrics["train_loss"])
        print(f"[multi-step] {label} ({cfg.coarse_samples}+{cfg.fine_samples}, {tcfg.num_rays} "
              f"rays, {tcfg.precision}, --kernel {tcfg.kernel}"
              + (f", occupancy G={occ_cfg.resolution}" if occ_cfg else "")
              + f"): steps {start}-{start + 2 * MULTI_STEPS - 1} as 2 calls of {MULTI_STEPS} "
              f"(captures {calls['captures']}, replays {calls['replays']}: the first call's "
              f"first step eager) against as many eager steps: params, Adam moments, "
              + ("grid, " if occ_cfg else "") + f"last metrics bit-identical: {same} (last "
              f"loss {loss:.6f}); the second call under sync debug mode 'error' raised nothing; "
              f"wrapper launches ({COUNTED}) over the 2 calls {multi_launches} (want "
              f"{want_multi}: the eager first step, its capture and {replays} replays counted "
              f"as graph.replays), over the eager steps {eager_launches}; of the fused "
              f"backward's, on wgmma (fused_raymarch_bwd_sm90.launches) {multi_sm90} over the "
              f"2 calls, {eager_sm90} over the eager steps; a third call's "
              f"{MULTI_STEPS} replays ran "
              f"{traced} (profiler trace; want {want_traced} = {MULTI_STEPS} x an eager "
              f"step's) {'PASS' if ok else 'FAIL'}", flush=True)
        print(f"[multi-step] {label} {card_line()}: ms/step over the second call "
              f"{multi_ms:.3f}, eager steps {start + MULTI_STEPS}-{start + 2 * MULTI_STEPS - 1} "
              f"{eager_ms:.3f} (each block ended by one sync); capture "
              f"{[round(1e3 * t, 1) for t in calls['capture_s']]} ms of host time "
              f"(instantiation included); "
              f"peak device memory (torch.cuda.max_memory_allocated) over the eager steps "
              f"{mib(eager_peak)} MiB, the first call (eager step, capture, replays) "
              f"{mib(first_peak)} MiB, the second call (replays alone) {mib(replay_peak)} "
              f"MiB; reserved and allocated with the cache emptied (torch.cuda.empty_cache) "
              f"after the eager steps {mib(eager_kept[0])} / {mib(eager_kept[1])} MiB, after "
              f"the first call {mib(graph_kept[0])} / {mib(graph_kept[1])} MiB: reserved "
              f"beyond allocated {mib(eager_kept[0] - eager_kept[1])} MiB without a graph, "
              f"{mib(graph_kept[0] - graph_kept[1])} MiB with the graph alive (its private "
              f"pool)", flush=True)
        if not ok:
            raise AssertionError(f"[multi-step] {label}: the replayed steps are not the eager "
                                 "ones")
        out[label] = dict(launches=multi_launches, traced=traced, ms=multi_ms,
                          eager_ms=eager_ms)
        if occ_cfg is not None:
            out["fast_call"] = lambda fn=multi_fn, st=multi: call(fn, st, start)
        multi_fn = multi = None  # this case's graph goes before the next case's eager steps
    return out


FUSED_GROUPS = {"forward kernel": ("fused_fwd_sm90",),
                "backward kernels": ("fused_bwd_kernel", "wgrad_", "reduce_slices",
                                     "reduce_rows")}
POINT_GROUPS = {"point forward kernel": ("points_fwd_sm90",),
                "point backward kernels": ("points_bwd_kernel", "wgrad_", "reduce_slices",
                                           "reduce_rows")}


OCC_GROUPS = dict(FUSED_GROUPS, **{"sampler kernel": ("sampler_kernel",)})
# a frame through the grid: the forward kernel and the occupancy kernels of
# this checkout or an older one (``--occ-timing``)
FRAME_OCC_GROUPS = {"forward kernel": ("fused_fwd_sm90",), "sampler kernel": ("sampler_kernel",),
                    "probe kernel": ("probe_kernel",)}


@contextlib.contextmanager
def timed_sampler_hooks():
    """Time every call of every coarse-sampler hook that
    ``ops.occupancy.make_occupancy_sampler`` makes inside: CUDA events
    around the call (its device span, which includes the device's waits for
    the host's launches) and the host's clock (the call's host time, no
    synchronisation). Yields the list of ``(start, end, host seconds)``. A
    call inside a CUDA graph's capture (the view sweep's, whose replays run
    the hook's kernels and no Python) is not timed."""
    from minimal_nerf_torch.ops import occupancy as occ

    calls = []

    def around(make):
        def make_timed(*args, **kwargs):
            hook = make(*args, **kwargs)

            def timed(*a, **k):
                if torch.cuda.is_current_stream_capturing():
                    return hook(*a, **k)
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                t0 = time.perf_counter()
                start.record()
                out = hook(*a, **k)
                end.record()
                calls.append((start, end, time.perf_counter() - t0))
                return out
            return timed
        return make_timed

    with wrapped(occ, "make_occupancy_sampler", around):
        yield calls


def hook_stats(calls):
    """(median device span ms, median host ms, summed device span ms) of
    ``timed_sampler_hooks``' calls."""
    torch.cuda.synchronize()
    spans = sorted(a.elapsed_time(b) for a, b, _ in calls)
    hosts = sorted(1e3 * h for _, _, h in calls)
    return spans[len(spans) // 2], hosts[len(hosts) // 2], sum(spans)


def profile_shares(label: str, fn, groups=FUSED_GROUPS):
    """Run ``fn`` under ``torch.profiler``: print each group of kernels'
    time and share of the wall time (the backward's split by kernel), other
    device work and the device's idle share (wall time covered by no device
    activity). A capture with no device activity at all is taken again (up
    to three times), then fails. Returns the wall time and each group's
    device time (us)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with uncounted(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    else:
        raise AssertionError(f"[profile] {label}: the profiler recorded no device activity")
    kernel_us = lambda key: sum(b - a for a, b, name in spans if key in name)  # noqa: E731
    parts, kernels_us, group_us = [], 0.0, {}
    for group, keys in groups.items():
        each = [kernel_us(k) for k in keys]
        kernels_us += sum(each)
        group_us[group] = sum(each)
        split = (" (" + ", ".join(f"{k.strip('_')} {u / 1e3:.2f}" for k, u in zip(keys, each))
                 + ")") if len(keys) > 1 else ""
        parts.append(f"{group}={sum(each) / 1e3:.{3 if sum(each) < 1e3 else 1}f} ms "
                     f"({100 * sum(each) / wall_us:.1f}% of wall){split}")
    busy_us, end = 0.0, -math.inf
    for a, b, _ in spans:  # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    print(f"[profile] {label} under torch.profiler: wall={wall_us / 1e3:.1f} ms, device "
          f"busy={busy_us / 1e3:.1f} ms, {', '.join(parts)}, other device work="
          f"{(busy_us - kernels_us) / 1e3:.1f} ms, device idle share="
          f"{100 * (1 - busy_us / wall_us):.1f}%", flush=True)
    return wall_us, group_us


def event_spans(events):
    """The summed ms between recorded pairs of CUDA events."""
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events)


def phase_profile(ckpt: Path, dev, train_step, pallas_step, occ_step, occ_ckpt: Path,
                  fast_call):
    """One more frame of the render path, one more train step, one more
    step of the pallas path and one more occupancy step (one without a grid
    update, as 15 of every 16 are); for the last, also the device span of
    the coarse-sampler hook (CUDA events around each call) beside the
    sampler kernel's time; one more replayed call of ``MULTI_STEPS`` steps
    of the fast recipe (``[multi-step]``'s); then one 16+48 frame through
    the ``[train-occ]`` checkpoint's grid, with its hook calls (the eager
    first and last chunks; the other 155 chunks are graph replays)."""
    from minimal_nerf_torch.render import render_views

    profile_shares(f"1 frame {HW}x{HW}",
                   lambda: list(render_views(str(ckpt), rays=RAYS, num_poses=1, height=HW,
                                             width=HW, device=dev)))
    orbit = lambda fpd: render_views(str(ckpt), rays=RAYS, num_poses=4,  # noqa: E731
                                     height=HW, width=HW, device=dev, frames_per_dispatch=fpd)
    for fpd in (1, 8):
        profile_shares(f"4-frame orbit {HW}x{HW} at --frames-per-dispatch {fpd} (checkpoint "
                       "load included)", lambda: list(orbit(fpd)))
    # the same orbits without the profiler, in turns (the load outside the timing)
    walls = {1: [], 8: []}
    for fpd in (1, 8, 8, 1):
        frames = orbit(fpd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        list(frames)
        torch.cuda.synchronize()
        walls[fpd].append(1e3 * (time.perf_counter() - t0) / 4)
    print(f"[profile] {card_line()}: 4-frame orbits {HW}x{HW} without the profiler, in turns "
          f"1, 8, 8, 1: ms/frame at --frames-per-dispatch 1 "
          f"{[round(w, 1) for w in walls[1]]}, at 8 {[round(w, 1) for w in walls[8]]}",
          flush=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[profile] 1 train step ({RAYS} rays): peak device memory {peak / 2 ** 20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated), {(peak - base) / 2 ** 20:.1f} MiB above the "
          f"{base / 2 ** 20:.1f} MiB held before the step (scene, weights, Adam state)",
          flush=True)
    profile_shares(f"1 train step ({RAYS} rays)", train_step)
    profile_shares(f"1 pallas train step ({RAYS} rays)", pallas_step, POINT_GROUPS)
    with timed_sampler_hooks() as calls:
        wall_us, group_us = profile_shares(f"1 occupancy train step ({RAYS} rays, 16+48)",
                                           occ_step, OCC_GROUPS)
    span_ms, host_ms, _ = hook_stats(calls)
    kernel_ms, wall_ms = group_us["sampler kernel"] / 1e3, wall_us / 1e3
    print(f"[profile] that occupancy step's coarse-sampler hook: {len(calls)} call(s), device "
          f"span {span_ms:.3f} ms ({100 * span_ms / wall_ms:.2f}% of wall; CUDA events around "
          f"the call, its two draws included), host {host_ms:.3f} ms; sampler kernel "
          f"{kernel_ms:.4f} ms ({100 * kernel_ms / wall_ms:.3f}% of wall)", flush=True)
    wall_us, _ = profile_shares(
        f"1 replayed call of {MULTI_STEPS} occupancy train steps ({RAYS} rays, 16+48; one "
        "CUDA-graph replay per step, one eager grid update)", fast_call, OCC_GROUPS)
    print(f"[profile] that call: {wall_us / 1e3 / MULTI_STEPS:.3f} ms of wall per step under "
          "the profiler", flush=True)
    with timed_sampler_hooks() as calls:
        wall_us, group_us = profile_shares(
            f"1 frame {HW}x{HW} at 16+48 through the grid (checkpoint load included)",
            lambda: list(render_views(str(occ_ckpt), rays=RAYS, num_poses=1, height=HW,
                                      width=HW, device=dev)), FRAME_OCC_GROUPS)
    span_ms, host_ms, total_ms = hook_stats(calls)
    print(f"[profile] that frame's coarse-sampler hook: {len(calls)} calls, median device span "
          f"{span_ms:.4f} ms and host {host_ms:.4f} ms per call, {total_ms:.2f} ms of span in "
          f"all ({100 * total_ms / (wall_us / 1e3):.1f}% of wall); sampler kernel "
          f"{group_us['sampler kernel'] / 1e3:.3f} ms in all", flush=True)


BENCH_TIMEOUT = 480
# the keys of the JSON line bench.py prints, plus the card's
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "config",
              "production_64_128_rays_per_sec", "production_vs_baseline", "device",
              "power_limit"}
# per path, in the bench's order: each counted kernel's launches in one step
# (``COUNTED`` order)
BENCH_STEP_LAUNCHES = ((2, 2, 0, 0, 0, 0), (0, 0, 2, 2, 0, 0), (2, 2, 0, 0, 0, 1))


def phase_bench(dev):
    """``python -m minimal_nerf_torch.bench`` as a user runs it, in a process of
    its own (this one's cached device memory released first): the bench.py
    measurements of the port (training rays/s of fused 64+128, pallas 64+128
    and the fast recipe, 20 replayed steps per call, on the 100-frame 800x800
    random scene). Gates: rc 0, the JSON line's keys exactly ``BENCH_KEYS``,
    the fast metric, each path a finite rate above 0 and a finite loss, its
    wrapper launches (above 0 for its kernels, 0 for the others,
    ``BENCH_STEP_LAUNCHES``); then, in
    this process, one replayed call of each path through the bench's own
    call (``bench.TrainCalls``) after its warm-up call, its kernels counted
    by name in a profiler trace (``traced_launches``): 20 steps' worth."""
    from minimal_nerf_torch import bench
    from minimal_nerf_torch.training.config import TrainConfig

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "minimal_nerf_torch.bench"],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    seconds = time.perf_counter() - t0
    results = []
    for line in proc.stderr.splitlines():
        if line.startswith("[bench] result "):
            results.append(json.loads(line[len("[bench] result "):]))
        elif line.startswith("[bench]"):
            print(line, flush=True)
    if proc.returncode != 0 or not proc.stdout.strip():
        print(proc.stderr[-4000:], flush=True)
        raise AssertionError(f"[bench] python -m minimal_nerf_torch.bench exited "
                             f"{proc.returncode} after {seconds:.1f} s")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    for r in results:
        print(f"[bench] windows {r['label']}: {[round(x, 1) for x in r['rates']]} rays/s, "
              f"median {r['median']:.1f}, best {r['best']:.1f}; loss {r['loss']:.6f}; build "
              f"{r['build_s']:.2f} s, warm-up {r['warmup_s']:.2f} s; peak "
              f"{r['peak_bytes'] / 2 ** 20:.1f} MiB", flush=True)
    finite = lambda x: isinstance(x, float) and math.isfinite(x)  # noqa: E731
    launched = [tuple(r["launches"][k] for k in KERNELS) for r in results]
    ok = (set(line) == BENCH_KEYS and line["metric"] == "train_rays_per_sec_per_chip_fast"
          and len(results) == 3
          and all(finite(r["best"]) and r["best"] > 0 and finite(r["loss"])
                  and all(finite(x) and x > 0 for x in r["rates"]) for r in results)
          and all((n > 0) == (w > 0) for c, per_step in zip(launched, BENCH_STEP_LAUNCHES)
                  for n, w in zip(c, per_step)))
    print(f"[bench] {card_line()}: python -m minimal_nerf_torch.bench rc {proc.returncode} in "
          f"{seconds:.1f} s; keys as bench.py's plus device and power_limit: "
          f"{set(line) == BENCH_KEYS}; wrapper launches per path ({COUNTED}) {launched} "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("[bench] the bench's line or a path's launches are wrong")

    images, poses, static = bench.bench_scene(device=dev)
    tcfg = TrainConfig(num_rays=RAYS, cropping_epochs=0, precision="bf16")
    for (_, label, nerf_cfg, kernel, occ_cfg), per_step in zip(bench.bench_paths(),
                                                               BENCH_STEP_LAUNCHES):
        calls = bench.TrainCalls(nerf_cfg, tcfg, static, kernel, bench.bench_init(nerf_cfg, dev),
                                 dev, occ_cfg, MULTI_STEPS)
        calls(images, poses, 0)
        with graph_calls() as seen:
            traced = traced_launches(lambda: calls(images, poses, MULTI_STEPS))
        want = tuple(MULTI_STEPS * n for n in per_step)
        good = traced == want and seen["captures"] == 0 and seen["replays"] > 0
        print(f"[bench] {label}: one replayed call of {MULTI_STEPS} steps (steps "
              f"{MULTI_STEPS}-{2 * MULTI_STEPS - 1}, after the warm-up call) ran {traced} "
              f"({COUNTED}; profiler trace; want {want}), captures {seen['captures']} "
              f"{'PASS' if good else 'FAIL'}", flush=True)
        ok = ok and good
    print(f"[bench] phase in {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok:
        raise AssertionError("[bench] a replayed call of the bench ran other kernels")


OCC_TIMING_STEPS = 64


def occ_timing(dev, root: Path) -> int:
    """``python3 chip_smoke.py --occ-timing [ROOT]``: the fast recipe's
    occupancy path of the package under ROOT (this checkout by default; an
    older checkout unpacked in the repo, such as the parent commit's) timed
    alone, so that two checkouts compare in one call, in turns: its kernels
    built, OCC_TIMING_STEPS occupancy steps at 16+48 from the seeded init
    (density bias +0.5, warmup cut to 32) with the median ms/step and the
    coarse-sampler hook's span per call, then a checkpoint and three 16+48
    frames through its grid (the last two timed), the hook per frame, one
    profiled frame, and the probe wrapper's call time. Prints one
    ``[occ-timing]`` line per measurement."""
    from minimal_nerf_torch.kernels import build
    from minimal_nerf_torch.kernels import occupancy_probe as op
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.ops import occupancy as occ
    from minimal_nerf_torch.render import render_views
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import checkpoint_name, save_checkpoint
    from minimal_nerf_torch.training.config import TrainConfig

    tree = Path(occ.__file__).resolve().parents[2]
    if tree != root:
        raise AssertionError(f"imported the package from {tree}, not {root}")
    names = [k for k in KERNELS if (build.CSRC / f"{k}.cu").is_file()]
    t0 = time.perf_counter()
    build.build_all(names)
    print(f"[occ-timing] tree {root}: built {names} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    scene = make_train_scene(dev)
    cfg = NeRFConfig(coarse_samples=16, fine_samples=48)
    tcfg = TrainConfig(occupancy=True, occ_warmup_steps=OCC_WARMUP)
    occ_cfg = tcfg.occupancy_config
    params = init_train_params(dev, cfg, 0.5)
    mlp_apply, render_fn = loop.kernel_hooks(tcfg.kernel, dev)
    step_fn = loop.make_train_step(cfg, tcfg, loop.scene_static(scene), render_fn=render_fn,
                                   device=dev, mlp_apply=mlp_apply, occupancy_cfg=occ_cfg)
    state, grid = loop.adam_init(params), occ.init_grid(occ_cfg, dev)
    times = []
    with timed_sampler_hooks() as calls:
        for step in range(OCC_TIMING_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, grid, _ = step_fn(params, state, grid, scene.images, scene.poses,
                                             step, 0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    steady = sorted(times[8:])
    span_ms, host_ms, _ = hook_stats(calls[8:])
    print(f"[occ-timing] {OCC_TIMING_STEPS} occupancy steps ({RAYS} rays, 16+48, bf16): median "
          f"ms/step={1e3 * steady[len(steady) // 2]:.3f} over steps 8.., min "
          f"{1e3 * steady[0]:.3f}; coarse-sampler hook per call: device span {span_ms:.4f} ms, "
          f"host {host_ms:.4f} ms (median)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(Path(tmp) / checkpoint_name("occ", 1, OCC_TIMING_STEPS), params,
                               OCC_TIMING_STEPS, cfg.to_dict(), tcfg.to_dict(), opt_state=state,
                               grid=grid)
        chunks = math.ceil(HW * HW / RAYS)
        with timed_sampler_hooks() as calls:
            # a warm-up frame, then two timed ones of a render of their own
            # (its checkpoint load outside the timing)
            list(render_views(str(ckpt), rays=RAYS, num_poses=1, height=HW, width=HW,
                              device=dev))
            frames = render_views(str(ckpt), rays=RAYS, num_poses=2, height=HW, width=HW,
                                  device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for frame in frames:
                pass
            torch.cuda.synchronize()
            frame_ms = 1e3 * (time.perf_counter() - t0) / 2
        span_ms, host_ms, total_ms = hook_stats(calls[-2 * chunks:])
        print(f"[occ-timing] 16+48 frames {HW}x{HW} through the grid: ms/frame={frame_ms:.1f} "
              f"(2 frames after a warm-up frame), mean {float(frame.mean()):.2f}; "
              f"coarse-sampler hook: {len(calls)} calls in 3 frames, per call device span "
              f"{span_ms:.4f} ms and host "
              f"{host_ms:.4f} ms (median), {total_ms / 2:.2f} ms of span per frame", flush=True)
        profile_shares(f"occ-timing: 1 frame {HW}x{HW} at 16+48 through the grid",
                       lambda: list(render_views(str(ckpt), rays=RAYS, num_poses=1, height=HW,
                                                 width=HW, device=dev)), FRAME_OCC_GROUPS)
    o, d, _ = sample_rays(RAYS, 1, torch.Generator(device=dev).manual_seed(8), dev)
    words = random_words(64 ** 3 // 32, torch.Generator(device=dev).manual_seed(9), dev)
    lin, _ = occ.bin_cells(o, d, occ.OccupancyConfig(), OCC_BINS, 2.0, 6.0)
    with uncounted():
        call_ms = cuda_ms(lambda: op.probe_bits(words, lin), warmup=10, reps=200)
    print(f"[occ-timing] probe wrapper call_ms={call_ms:.5f} ({RAYS}x{OCC_BINS} probes, G=64; "
          f"CUDA events over 200 back-to-back calls)", flush=True)
    return 0


# --path-parity: the shared points of each path's own 100-step trajectory,
# the draw seeds of the bf16 spread, and the fp32 trajectories' bound on a
# leaf's gap between the paths as a share of its own change since the init
PARITY_POINTS = (0, 25, 50, 100)
PARITY_SEEDS = tuple(range(8))
PARITY_EDGE = 1e-3
PATHS = ("fused", "pallas")
# [train-pallas]'s gate: every leaf's relative L2 gap between the fused and
# the pallas path's bf16 gradients at the seeded init and at the pallas
# path's step-100 parameters. H100 readings (--path-parity, 8 shared points
# in bf16): worst leaf 2.0e-3, at steps 0 and 100 2.5e-4 and 8.5e-5
PATH_GRAD_TOL = 1e-2


def leaf_names(tree, prefix: str = ""):
    """``coarse/trunk[0]/w``-style names of a params tree's leaves in
    ``flatten_tree`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix.lstrip("/")]


def cloned(params):
    from minimal_nerf_torch.models.mlp import map_params

    return map_params(lambda t: t.detach().clone(), params)


def train_path(dev, scene, cfg, tcfg, kernel: str, init, seed: int, steps: int,
               points=()):
    """``steps`` eager train steps of ``make_train_step`` through ``kernel``'s
    hooks (built once, as a run builds them) from a copy of ``init`` on the
    draws of ``seed``, uncounted: ``(params, {step: params after it}, the
    per-step losses)``."""
    from minimal_nerf_torch.training import loop

    mlp_apply, render_fn = loop.kernel_hooks(kernel, dev)
    step_fn = loop.make_train_step(cfg, tcfg, loop.scene_static(scene), render_fn=render_fn,
                                   device=dev, mlp_apply=mlp_apply)
    params = cloned(init)
    state, snaps, losses = loop.adam_init(params), {}, []
    if 0 in points:
        snaps[0] = cloned(params)
    with uncounted():
        for step in range(steps):
            params, state, metrics = step_fn(params, state, scene.images, scene.poses, step,
                                             seed)
            losses.append(metrics["train_loss"])
            if step + 1 in points:
                snaps[step + 1] = cloned(params)
    return params, snaps, torch.stack(losses).tolist()


def step_grads(dev, scene, cfg, tcfg, kernel: str, params, step: int, seed: int):
    """One train step's gradients (``flatten_tree`` order) and metrics
    through ``kernel``'s hooks at a copy of ``params``, on the batch and
    draws of step ``step`` of seed ``seed`` (``draw_step_inputs``), uncounted."""
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    static = loop.scene_static(scene)
    inp = loop.inputs_on_device([loop.draw_step_inputs(cfg, tcfg, static, step, step, seed,
                                                       dev)], dev)[0]
    batch = loop.ray_batch_from_arrays(inp["frame"], tcfg.num_rays, static.height, static.width,
                                       static.focal, scene.images, scene.poses,
                                       coords=(inp["xs"], inp["ys"]))
    mlp_apply, render_fn = loop.kernel_hooks(kernel, dev)
    with uncounted():
        metrics, grads = loop.loss_and_grads(cloned(params), cfg, batch, tcfg.compute_dtype,
                                             render_fn, uniforms=inp["uniforms"],
                                             mlp_apply=mlp_apply)
    return flatten_tree(grads), metrics


def grad_gaps(dev, scene, cfg, tcfg, params, step: int, seed: int):
    """The relative L2 gap ``|g_fused - g_pallas| / |g_fused|`` of every
    leaf between the two paths' gradients at ``params`` on one step's batch
    and draws, and the pallas path's density statistics there."""
    g_f, _ = step_grads(dev, scene, cfg, tcfg, "fused", params, step, seed)
    g_p, metrics = step_grads(dev, scene, cfg, tcfg, "pallas", params, step, seed)
    gaps = torch.stack([torch.linalg.norm(a - b) / torch.linalg.norm(a)
                        for a, b in zip(g_f, g_p)]).tolist()
    stats = {k: float(v) for k, v in metrics.items() if k.endswith("_non_zeros")}
    return gaps, stats


def gap_summary(names, gaps) -> str:
    """The worst leaf's gap beside the median of the others'."""
    order = sorted(range(len(gaps)), key=lambda i: gaps[i])
    worst = order[-1]
    rest = [gaps[i] for i in order[:-1]]
    return (f"worst {names[worst]} {gaps[worst]:.3e}, median of the others "
            f"{rest[len(rest) // 2]:.3e}, max of the others {rest[-1]:.3e}")


def scored_psnr(ckpt: Path, tree: Path, dev) -> float:
    """``score.calculate_scores`` of ``ckpt`` on ``tree``'s test split (its
    printout dropped): the mean PSNR."""
    import io

    from minimal_nerf_torch import score

    with contextlib.redirect_stdout(io.StringIO()):
        psnr, _ = score.calculate_scores(str(ckpt), tree, RAYS, device=dev)
    return psnr


def lockstep(dev, scene, cfg, tcfg, runs, names):
    """Two trajectories of ``TRAIN_STEPS`` eager steps on the draws of seed
    0, ``runs = ((kernel, init), (kernel, init))``, side by side: after each
    step every leaf's gap between them as a share of the first one's change
    since its init, by the max element (max |gap| / max |change|) and by the
    L2 norm (|gap| / |change|). Returns ``({"max": (step, leaf, share) of
    the first step past PARITY_EDGE or None, "l2": likewise, "l2_at":
    {step: largest L2 share} at PARITY_POINTS}, the final params)``."""
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    fns, params, states = [], [], []
    for kernel, init in runs:
        mlp_apply, render_fn = loop.kernel_hooks(kernel, dev)
        fns.append(loop.make_train_step(cfg, dataclasses.replace(tcfg, kernel=kernel),
                                        loop.scene_static(scene), render_fn=render_fn,
                                        device=dev, mlp_apply=mlp_apply))
        params.append(cloned(init))
        states.append(loop.adam_init(params[-1]))
    leaves0 = flatten_tree(runs[0][1])
    out = {"max": None, "l2": None, "l2_at": {}}
    with uncounted():
        for step in range(TRAIN_STEPS):
            for i, fn in enumerate(fns):
                params[i], states[i], _ = fn(params[i], states[i], scene.images, scene.poses,
                                             step, 0)
            pairs = list(zip(flatten_tree(params[0]), flatten_tree(params[1]), leaves0))
            shares = {
                "max": torch.stack([(a - b).abs().max() / (a - a0).abs().max().clamp_min(1e-30)
                                    for a, b, a0 in pairs]).tolist(),
                "l2": torch.stack([torch.linalg.norm(a - b) / torch.linalg.norm(
                    a - a0).clamp_min(1e-30) for a, b, a0 in pairs]).tolist()}
            for kind, v in shares.items():
                worst = max(range(len(v)), key=v.__getitem__)
                if out[kind] is None and v[worst] > PARITY_EDGE:
                    out[kind] = (step, names[worst], v[worst])
            if step + 1 in PARITY_POINTS:
                out["l2_at"][step + 1] = max(shares["l2"])
    return out, params


def path_parity(dev, out_json=None) -> int:
    """``python3 chip_smoke.py --path-parity [JSON]``: where the eager fused
    and ``--kernel pallas`` train paths part, at 64+128, 4096 rays, on the
    ``[train]`` scene from its seeded init.

    1. Gradients at shared parameters: each path trains 100 bf16 steps on
       the draws of seed 0 (as ``[train]`` and ``[train-pallas]`` do); at the
       parameters after steps 0, 25, 50 and 100 of each trajectory, one
       step's gradients through both paths on the same batch and draws, in
       bf16 and in fp32 with TF32 off: the relative L2 gap of every leaf
       (trunk 0-3, feature 0-2, density, rgb 0-1; w and b; coarse and fine).
    2. Trajectories: both paths 100 steps in fp32 (TF32 off) from the same
       init on the same draws; the first step at which a leaf's max |gap|
       (or its L2 gap) exceeds ``PARITY_EDGE`` of its own change since the
       init, and each final checkpoint's PSNR on the test split
       (``score``); as a control the same for the fused path against itself
       from the init moved by one ulp per weight, which shows how fast
       rounding-level differences grow in this training by themselves.
    3. The bf16 spread: each path 100 steps on the draws of each seed of
       ``PARITY_SEEDS``, each checkpoint's PSNR: each path's range over the
       first three seeds beside the seed-0 gap, and over all the seeds each
       path's mean and standard deviation and the difference of the means
       with its standard error.

    Writes every leaf's gaps to ``JSON`` when given."""
    from minimal_nerf_torch.data.procedural import save_scene_tree
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training.checkpoint import checkpoint_name, save_checkpoint
    from minimal_nerf_torch.training.config import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scenes = make_train_scene(dev)
    scene = scenes["train"]
    cfg, bf16, fp32 = NeRFConfig(), TrainConfig(), TrainConfig(precision="fp32")
    bias = init_density_bias(dev, cfg, bf16, scene)
    init = init_train_params(dev, cfg, bias)
    names = leaf_names(init)
    record = {"card": card_line(), "leaves": names, "gaps": {}, "psnr": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tree = save_scene_tree({"test": scenes["test"]}, tmp / "tree")

        def psnr_of(label, params, tcfg, kernel):
            path = save_checkpoint(tmp / checkpoint_name(label, 5, TRAIN_STEPS), params,
                                   TRAIN_STEPS, cfg.to_dict(),
                                   dataclasses.replace(tcfg, kernel=kernel).to_dict())
            record["psnr"][label] = scored_psnr(path, tree, dev)
            return record["psnr"][label]

        init_psnr = psnr_of("init", init, bf16, "fused")
        print(f"[path-parity] {card_line()}; seeded init (density bias {bias}) psnr "
              f"{init_psnr!r} on the {TEST_FRAMES} test frames", flush=True)

        # 1 and 3: the bf16 trajectories of every seed; seed 0's shared points
        finals, spread = {}, {k: [] for k in PATHS}
        for seed in PARITY_SEEDS:
            for kernel in PATHS:
                t0 = time.perf_counter()
                params, snaps, losses = train_path(
                    dev, scene, cfg, dataclasses.replace(bf16, kernel=kernel), kernel, init,
                    seed, TRAIN_STEPS, PARITY_POINTS if seed == 0 else ())
                psnr = psnr_of(f"{kernel}-s{seed}", params, bf16, kernel)
                spread[kernel].append(psnr)
                if seed == 0:
                    finals[kernel] = snaps
                print(f"[path-parity] bf16 {kernel} seed {seed}: {TRAIN_STEPS} steps in "
                      f"{time.perf_counter() - t0:.1f} s, loss first {losses[0]:.5f} mean of "
                      f"the last 10 {sum(losses[-10:]) / 10:.5f}; psnr {psnr!r}", flush=True)
        ok = True
        for owner in PATHS:
            for point in PARITY_POINTS:
                for label, tcfg in (("bf16", bf16), ("fp32", fp32)):
                    gaps, stats = grad_gaps(dev, scene, cfg, tcfg, finals[owner][point],
                                            point, 0)
                    record["gaps"][f"{owner}@{point}/{label}"] = gaps
                    finite = all(math.isfinite(g) for g in gaps)
                    ok &= finite
                    extra = (f"; fp32 leaves beyond 1e-4: "
                             f"{[n for n, g in zip(names, gaps) if g > 1e-4]}"
                             if label == "fp32" else "")
                    print(f"[path-parity] gradients at {owner}'s step {point}, {label}: "
                          f"|g_fused - g_pallas| / |g_fused| per leaf: "
                          f"{gap_summary(names, gaps)}; pallas density non-zeros "
                          f"{stats}{extra}", flush=True)

        # 2: fp32 trajectories side by side; as a control, the fused path
        # against itself from the init moved by one ulp per weight
        t0 = time.perf_counter()
        nudged = map_params(lambda t: torch.nextafter(t, torch.full_like(t, math.inf)), init)
        pair, p_fp32 = lockstep(dev, scene, cfg, fp32, (("fused", init), ("pallas", init)),
                                names)
        control, _ = lockstep(dev, scene, cfg, fp32, (("fused", init), ("fused", nudged)), names)
        fp32_psnr = {k: psnr_of(f"{k}-fp32", p_fp32[i], fp32, k) for i, k in enumerate(PATHS)}
        for label, r in (("fused and pallas from one init", pair),
                         ("control: fused and fused from the init moved by one ulp", control)):
            print(f"[path-parity] fp32 (TF32 off) trajectories, {TRAIN_STEPS} steps on the draws "
                  f"of seed 0, {label}: first step (from 0) with a leaf's max |gap| above "
                  f"{PARITY_EDGE} of its max change since the init: {r['max']}; with a leaf's "
                  f"|gap| above {PARITY_EDGE} of |change| (L2): {r['l2']}; the largest L2 share "
                  f"after steps {list(r['l2_at'])}: {[f'{v:.3e}' for v in r['l2_at'].values()]}",
                  flush=True)
        print(f"[path-parity] fp32 psnr after {TRAIN_STEPS} steps: fused {fp32_psnr['fused']!r} "
              f"pallas {fp32_psnr['pallas']!r} ({time.perf_counter() - t0:.1f} s for the fp32 "
              f"runs)", flush=True)
        record["fp32"] = {"paths": pair, "control": control, "psnr": fp32_psnr}

    stats = {}
    for k in PATHS:
        v = spread[k]
        mean = sum(v) / len(v)
        std = math.sqrt(sum((x - mean) ** 2 for x in v) / (len(v) - 1))
        stats[k] = (mean, std)
        print(f"[path-parity] bf16 spread, {k}: psnr over seeds {list(PARITY_SEEDS)} "
              f"{[round(x, 4) for x in v]}; seeds 0-2 range {max(v[:3]) - min(v[:3]):.4f} dB; "
              f"all seeds mean {mean:.4f} std {std:.4f} min {min(v):.4f} max {max(v):.4f} dB",
              flush=True)
    gap0 = spread["pallas"][0] - spread["fused"][0]
    ranges = {k: max(v[:3]) - min(v[:3]) for k, v in spread.items()}
    diff = stats["pallas"][0] - stats["fused"][0]
    se = math.sqrt(sum(sd ** 2 for _, sd in stats.values()) / len(PARITY_SEEDS))
    print(f"[path-parity] seed 0: pallas - fused = {gap0:+.4f} dB; ranges over seeds 0-2: fused "
          f"{ranges['fused']:.4f}, pallas {ranges['pallas']:.4f} dB; a range at least |gap|: "
          f"{[k for k in PATHS if ranges[k] >= abs(gap0)]}; over all {len(PARITY_SEEDS)} seeds "
          f"the mean psnr of pallas - fused = {diff:+.4f} dB, standard error {se:.4f} dB "
          f"({diff / se:+.2f} standard errors)", flush=True)
    record["spread"] = {"psnr": spread, "gap0": gap0, "ranges_0_2": ranges,
                        "mean_diff": diff, "se": se}
    if out_json:
        Path(out_json).parent.mkdir(parents=True, exist_ok=True)
        Path(out_json).write_text(json.dumps(record, indent=1))
    return 0 if ok else 1


# ``--trajectory``: the multiframe arm of experiments/r5-parity/
# trajectory_parity.py on its committed scene (tests/torch_data/
# r5_mf_scene, JAX's ensure_scene tree); the gate of PERFORMANCE.md:260-291
# and ROADMAP item 1.4: on seeds 0 and 1 the mean of PSNR_port - PSNR_jax
# over steps 300-600 within 0.5 dB of the recorded jax.csv, per fp32 path
TRAJ_TREE = Path(__file__).resolve().parent / "tests" / "torch_data" / "r5_mf_scene"
TRAJ_CSV = Path(__file__).resolve().parent / "experiments" / "r5-parity" / "results"
TRAJ_RAYS, TRAJ_SAMPLES, TRAJ_STEPS, TRAJ_EVERY, TRAJ_FRAMES = 512, (12, 24), 600, 100, 5
TRAJ_CROP_EPOCHS, TRAJ_SEEDS, TRAJ_GATE = 4, (0, 1, 2), 0.5
TRAJ_RUNS = (("fp32", ("xla", "fused", "pallas")), ("bf16", ("fused", "pallas")))


def psnr_u8(pred, gt) -> float:
    """PSNR of uint8 frames (``experiments/r4-parity/overfit_parity.py::psnr``)."""
    import numpy as np

    mse = np.mean((pred.astype(np.float64) - gt.astype(np.float64)) ** 2)
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def trajectory(dev) -> int:
    """``python3 chip_smoke.py --trajectory``: the port's ``Trainer`` on the
    arm (5 train frames of 100x100, 512 rays, 12+24 samples, 5 steps per
    epoch, the crop handoff after 4 epochs, the LR 5e-4 * 0.1^(epoch/1200)
    staircased per epoch, JAX's init ``init_nerf_network(PRNGKey(seed))``
    made by ``utils.threefry``), 600 steps, the PSNR of train frame 0 every
    100 steps rendered through the run's own path; fp32 (TF32 off) under
    xla, fused and pallas and bf16 under fused and pallas, seeds 0-2, each
    beside the recorded JAX run. Returns 1 if an fp32 path misses the gate
    on seed 0 or 1."""
    import numpy as np

    from minimal_nerf_torch import views
    from minimal_nerf_torch.data.synthetic import SyntheticScene
    from minimal_nerf_torch.models.mlp import params_from_jax
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.config import TrainConfig
    from minimal_nerf_torch.training.metrics import NullLogger
    from minimal_nerf_torch.training.trainer import Trainer
    from minimal_nerf_torch.utils import threefry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    cfg = NeRFConfig(coarse_samples=TRAJ_SAMPLES[0], fine_samples=TRAJ_SAMPLES[1])
    scene = SyntheticScene.load(TRAJ_TREE, "train", dev)
    gt0 = scene.images[0].cpu().numpy()
    o0, d0 = scene.frame_rays(0)
    black = psnr_u8(np.zeros_like(gt0), gt0)
    evals = list(range(TRAJ_EVERY, TRAJ_STEPS + 1, TRAJ_EVERY))
    late = [s for s in evals if s >= TRAJ_STEPS // 2]
    record, ok = {}, True
    print(f"[trajectory] {card}: the multiframe arm on {TRAJ_TREE.name} ({scene.num_frames} "
          f"train frames {scene.height}x{scene.width}), {TRAJ_RAYS} rays, "
          f"{cfg.coarse_samples}+{cfg.fine_samples}, {TRAJ_STEPS} steps; an all-black frame 0 "
          f"scores {black:.4f} dB", flush=True)
    for precision, kernels in TRAJ_RUNS:
        for seed in TRAJ_SEEDS:
            jax_csv = {int(r["step"]): float(r["psnr"])
                       for r in read_csv(TRAJ_CSV / f"mf_s{seed}" / "jax.csv")[1]}
            for kernel in kernels:
                t0 = time.perf_counter()
                tcfg = TrainConfig(num_rays=TRAJ_RAYS, cropping_epochs=TRAJ_CROP_EPOCHS,
                                   steps_per_epoch=TRAJ_FRAMES, precision=precision,
                                   kernel=kernel, log_every=TRAJ_EVERY, seed=seed,
                                   check_val_every_n_epoch=10 ** 9)
                params = params_from_jax(threefry.init_nerf_network(seed), dev)
                state = (params, loop.adam_init(params), None, 0)
                mlp_apply, render_fn = loop.kernel_hooks(kernel, dev)
                render_chunk = views.make_param_render_chunk(cfg, tcfg.compute_dtype,
                                                             mlp_apply, render_fn)
                psnr = {}
                with tempfile.TemporaryDirectory() as root, uncounted():
                    for stop in evals:
                        trainer = Trainer(cfg, dataclasses.replace(tcfg, max_steps=stop),
                                          {"train": scene}, root, name="traj",
                                          mlp_apply=mlp_apply, render_fn=render_fn,
                                          logger=NullLogger(), initial_state=state, device=dev)
                        with contextlib.redirect_stderr(io.StringIO()):
                            trainer.fit()
                        state = trainer.final_state
                        pred = views.view_reconstruction_with_params(
                            render_chunk, state[0], o0, d0, chunk=TRAJ_RAYS, seed=1)
                        psnr[stop] = psnr_u8(pred, gt0)
                delta = [psnr[s] - jax_csv[s] for s in evals]
                mean_late = sum(psnr[s] - jax_csv[s] for s in late) / len(late)
                breaches = [s for s in evals if abs(psnr[s] - jax_csv[s]) > TRAJ_GATE]
                gated = precision == "fp32" and seed in (0, 1)
                passed = abs(mean_late) <= TRAJ_GATE
                ok &= passed or not gated
                collapsed = all(abs(psnr[s] - black) < 1e-3 for s in evals)
                record[f"{precision}/{kernel}/s{seed}"] = dict(psnr=psnr, delta=delta,
                                                               mean_late=mean_late)
                secs = time.perf_counter() - t0
                print(f"[trajectory] {precision} {kernel} seed {seed} ({secs:.1f} s): psnr at {evals} {[round(psnr[s], 4) for s in evals]}; jax.csv "
                      f"{[round(jax_csv[s], 4) for s in evals]}; delta "
                      f"{[round(x, 4) for x in delta]}; mean delta over {late[0]}-{late[-1]} "
                      f"{mean_late:+.4f} dB; single evals beyond {TRAJ_GATE} dB: {breaches}; "
                      f"all-black at every eval: {collapsed}"
                      + (f" {'PASS' if passed else 'MISS'} (gate |mean| <= {TRAJ_GATE})"
                         if gated else " (reported, no gate)"), flush=True)
    print("[trajectory] " + json.dumps({k: round(v["mean_late"], 4) for k, v in record.items()}),
          flush=True)
    return 0 if ok else 1


# ``--fault2``: ROADMAP Queue 3 fault 2 in its own configuration ([train]'s
# scene and init, 64+128, 4096 rays, bf16), fused against pallas, 1,000
# steps (past the 200-step crop warmup) on each of 8 draw seeds, each
# checkpoint scored on the 4 test frames through its own path; closed when
# the paired mean gap is within 2 standard errors of 0 and within 0.5 dB
FAULT2_STEPS, FAULT2_EVERY, FAULT2_SEEDS, FAULT2_GATE = 1000, 200, tuple(range(8)), 0.5


def fault2(dev) -> int:
    """``python3 chip_smoke.py --fault2``: the paired test of fault 2 (above);
    prints each seed's PSNR of both paths every 200 steps, the paired
    differences at step 1000, their mean, standard error and the verdict,
    and the first step where the two paths' mean PSNR curves part by more
    than 0.5 dB."""
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.data.procedural import save_scene_tree
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import checkpoint_name, save_checkpoint
    from minimal_nerf_torch.training.config import TrainConfig

    card = card_line()
    scenes = make_train_scene(dev)
    scene = scenes["train"]
    cfg, tcfg = NeRFConfig(), TrainConfig()
    bias = init_density_bias(dev, cfg, tcfg, scene)
    init = init_train_params(dev, cfg, bias)
    points = list(range(FAULT2_EVERY, FAULT2_STEPS + 1, FAULT2_EVERY))
    curves = {k: {s: [] for s in points} for k in PATHS}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tree = save_scene_tree({"test": scenes["test"]}, tmp / "tree")
        for seed in FAULT2_SEEDS:
            for kernel in PATHS:
                t0 = time.perf_counter()
                k_cfg = dataclasses.replace(tcfg, kernel=kernel)
                mlp_apply, render_fn = loop.kernel_hooks(kernel, dev)
                step_fn = loop.make_train_step(cfg, k_cfg, loop.scene_static(scene),
                                               render_fn=render_fn, device=dev,
                                               mlp_apply=mlp_apply)
                params = cloned(init)
                state = loop.adam_init(params)
                with uncounted():
                    for step in range(FAULT2_STEPS):
                        params, state, metrics = step_fn(params, state, scene.images,
                                                         scene.poses, step, seed)
                        if step + 1 in curves[kernel]:
                            path = save_checkpoint(
                                tmp / checkpoint_name(f"{kernel}-s{seed}", 0, step + 1), params,
                                step + 1, cfg.to_dict(), k_cfg.to_dict())
                            curves[kernel][step + 1].append(scored_psnr(path, tree, dev))
                print(f"[fault2] {card}: bf16 {kernel} seed {seed}, {FAULT2_STEPS} steps in "
                      f"{time.perf_counter() - t0:.1f} s (with the scoring): test psnr at "
                      f"{points} {[round(curves[kernel][s][-1], 4) for s in points]}; last "
                      f"loss {float(metrics['train_loss']):.5f}", flush=True)
    final = FAULT2_STEPS
    diffs = [p - f for p, f in zip(curves["pallas"][final], curves["fused"][final])]
    n = len(diffs)
    mean = sum(diffs) / n
    se = math.sqrt(sum((d - mean) ** 2 for d in diffs) / (n - 1) / n)
    closed = abs(mean) <= 2 * se and abs(mean) <= FAULT2_GATE
    means = {k: {s: sum(v) / n for s, v in c.items()} for k, c in curves.items()}
    part = next((s for s in points if abs(means["pallas"][s] - means["fused"][s]) > FAULT2_GATE),
                None)
    print(f"[fault2] {card}: at step {final} over seeds {list(FAULT2_SEEDS)}: fused "
          f"{[round(x, 4) for x in curves['fused'][final]]}, pallas "
          f"{[round(x, 4) for x in curves['pallas'][final]]}; pallas - fused per seed "
          f"{[round(d, 4) for d in diffs]}; mean {mean:+.4f} dB, standard error {se:.4f} dB "
          f"({mean / se:+.2f} SE); the mean curves at {points}: fused "
          f"{[round(means['fused'][s], 4) for s in points]} pallas "
          f"{[round(means['pallas'][s], 4) for s in points]}; first step they part by more "
          f"than {FAULT2_GATE} dB: {part}; verdict: "
          f"{'CLOSED (|mean| <= 2 SE and <= 0.5 dB)' if closed else 'OPEN'}", flush=True)
    return 0


def entry(name, replaces, shapes, launches):
    """A kernel's entry of the kernels line: over the main path's shapes
    (one 4096-ray chunk or step: S=64 and S=192 in bf16; the hash
    encoding's coarse and fine launches of one step), its times summed."""
    return {"name": name, "route": "cuda",
            "source": f"minimal_nerf_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["err"] for r in shapes),
            "ms": sum(r["ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            "bound_ms": sum(r["bound_ms"] for r in shapes),
            "bound_by": shapes[-1]["bound_by"],
            "library_ms": (None if any(r["library_ms"] is None for r in shapes)
                           else sum(r["library_ms"] for r in shapes))}


def hash_entries(report):
    """The hash encoding's kernels' entries: they replace no TPU kernel (the
    JAX package has no hash grid); their launches are those of one replayed
    call of ``train.ngp``'s program; ``max_abs_err`` is relative (to the
    largest feature; to each entry's sum of magnitudes)."""
    fwd, bwd = report["hash_launches"]
    return [entry("hash_encode_fwd", None, report["hash_fwd"], fwd),
            entry("hash_encode_bwd", None, report["hash_bwd"], bwd)]


def vm_entries(report):
    """The VM sampling kernels' entries: they replace no TPU kernel (the JAX
    package has no TensoRF); their launches are those of one replayed call
    of ``train.tensorf``'s program; ``max_abs_err`` is 0 for outputs equal
    bit for bit (the forward) and relative to each entry's sum of
    magnitudes (the backward)."""
    fwd, bwd = report["vm_launches"]
    return [entry("vm_sample_fwd", None, report["vm_fwd"], fwd),
            entry("vm_sample_bwd", None, report["vm_bwd"], bwd)]


def mlp_entries(report):
    """The shading kernels' entries: they replace no TPU kernel (the JAX
    package has no TensoRF); their launches are those of one replayed call
    of ``train.tensorf``'s program; ``max_abs_err`` is the largest relative
    L2 gap to the plain chain (rgb; the gradients)."""
    fwd, bwd = report["mlp_launches"]
    return [entry("tensorf_mlp_fwd", None, report["mlp_fwd"], fwd),
            entry("tensorf_mlp_bwd", None, report["mlp_bwd"], bwd)]


def device_info():
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if argv[:1] == ["--occ-timing"]:
        root = Path(argv[1] if len(argv) > 1 else Path(__file__).parent).resolve()
        sys.path.insert(0, str(root))
        return occ_timing(dev, root)
    from minimal_nerf_torch.kernels import build

    if argv[:1] == ["--path-parity"]:
        build.build_all(KERNELS)
        return path_parity(dev, argv[1] if len(argv) > 1 else None)
    if argv[:1] in (["--trajectory"], ["--fault2"]):
        build.build_all(KERNELS)
        return (trajectory if argv[0] == "--trajectory" else fault2)(dev)
    if argv[:1] == ["--hash-encode"]:
        build.build_all(HASH_KERNELS)
        report = {}
        phase_hash_encode(dev, report)
        print(card)
        print(json.dumps({"kernels": hash_entries(report)}))
        print(json.dumps({"ok": True, "device": device_info()}))
        return 0
    if argv[:1] == ["--tensorf-mlp"]:
        build.build_all(MLP_KERNELS)
        report = {}
        phase_tensorf_mlp(dev, report)
        print(card)
        print(json.dumps({"kernels": mlp_entries(report)}))
        print(json.dumps({"ok": True, "device": device_info()}))
        return 0
    if argv[:1] == ["--vm-sample"]:
        build.build_all(VM_KERNELS)
        report = {}
        phase_vm_sample(dev, report)
        print(card)
        print(json.dumps({"kernels": vm_entries(report)}))
        print(json.dumps({"ok": True, "device": device_info()}))
        return 0

    t0 = time.perf_counter()
    built = KERNELS + HASH_KERNELS + VM_KERNELS + MLP_KERNELS
    build.build_all(built)
    print(f"[build] {built} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print(f"[build] {name}: {line.split('entry function')[1].strip()[:72]}",
                      flush=True)
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    report = {}
    phase_kernels(dev, report)
    phase_kernel_bwd(dev, report)
    phase_kernel_mlp(dev, report)
    phase_kernel_mlp_bwd(dev, report)
    phase_kernel_occ(dev, report)
    phase_kernel_occ_sampler(dev, report)
    phase_hash_encode(dev, report)
    phase_vm_sample(dev, report)
    phase_tensorf_mlp(dev, report)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, launches = phase_main_path(dev, Path(tmp))
        phase_reference(dev, ckpt)
        phase_render_cli(dev, ckpt, Path(tmp))
        scenes = make_train_scene(dev)
        scene = scenes["train"]
        train, step_fn, params, state = phase_train(dev, Path(tmp), scene)
        phase_train_reference(dev, scene, train["bias"])
        pallas, p_step_fn, p_params, p_state = phase_train_pallas(dev, Path(tmp), scene,
                                                                  train["bias"])
        phase_pallas_reference(dev, scene, train["bias"])
        phase_single_reference(dev, scene, train["bias"])
        occ_train, o_step_fn, o_params, o_state, o_grid, o_cfg, o_tcfg = phase_train_occ(
            dev, Path(tmp), scene, params, train["ckpt"])
        phase_occ_reference(dev, scene, o_params, o_grid, o_cfg, o_tcfg)
        multi = phase_multi_step(dev, scene, train["bias"], params)
        phase_trainer(dev, Path(tmp), scenes, train["ms"])
        phase_data_parallel(dev, Path(tmp), train["bias"])
        single = phase_single(dev, Path(tmp))
        phase_simple(dev, Path(tmp))
        phase_score(dev, Path(tmp), ckpt, pallas["ckpt"], train["ckpt"])
        phase_convert(dev, Path(tmp))
        phase_profile(ckpt, dev,
                      lambda: step_fn(params, state, scene.images, scene.poses, TRAIN_STEPS, 0),
                      lambda: p_step_fn(p_params, p_state, scene.images, scene.poses,
                                        TRAIN_STEPS, 0),
                      lambda: o_step_fn(o_params, o_state, o_grid, scene.images, scene.poses,
                                        TRAIN_STEPS + 1, 0), occ_train["ckpt"],
                      multi["fast_call"])
        multi = None  # the fast call's graph pool goes before the bench's process starts
        phase_bench(dev)

    # launches: each path's own run, its counts set to 0 just before it
    kernels = [
        entry("fused_raymarch_fwd", "minimal_nerf_tpu/kernels/fused_raymarch.py:175",
              [report[("bf16", s)] for s in SAMPLES], launches),
        entry("fused_raymarch_bwd", "minimal_nerf_tpu/kernels/fused_raymarch.py:191",
              [report[("bwd", "bf16", s)] for s in SAMPLES], train["counts"]["bwd"]),
        entry("raymarch_mlp_fwd", "minimal_nerf_tpu/kernels/raymarch.py:73",
              [report[("mlp", "bf16", s)] for s in SAMPLES], pallas["counts"]["fwd"]),
        entry("raymarch_mlp_bwd", "minimal_nerf_tpu/kernels/raymarch.py:277",
              [report[("mlp-bwd", "bf16", s)] for s in SAMPLES], pallas["counts"]["bwd"]),
        # one 4096-ray chunk or step's 4096 x 64 probes at G=64; launches in
        # the 100 occupancy steps: none since the sampler took the path
        entry("occupancy_probe", "minimal_nerf_tpu/kernels/occupancy_probe.py:44",
              [report["occ"]], occ_train["counts"]["probe"]),
        # one 4096-ray chunk or step at 64 bins x 16 samples, G=64, jitter;
        # launches in the 100 occupancy steps (one per step)
        entry("occupancy_sampler", "minimal_nerf_tpu/kernels/occupancy_probe.py:44",
              [report["occ_sampler"]], occ_train["counts"]["sampler"]),
    ] + hash_entries(report) + vm_entries(report) + mlp_entries(report)
    # train single --kernel pallas's own run (its counts set to 0 just before)
    print("[single] launches of train single --kernel pallas: " + json.dumps(
        {"raymarch_mlp_fwd": single["launched"][2], "raymarch_mlp_bwd": single["launched"][3]}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
