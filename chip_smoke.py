"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Builds every kernel of the serving path from the sources in the checkout,
holds each against its plain PyTorch version at the main path's shapes (on
weights whose outputs depend on the input, with bounds shown to reject
faulty versions), then renders two 800x800 orbit frames from a full-width
checkpoint written by the port, checks that the kernel carried the render,
and profiles one more frame for the kernel's and idle shares. Prints one line per
phase, the card's name and power limit, a JSON line of kernel timings, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
card or when any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

KERNELS = ["fused_raymarch_fwd"]
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
# the element bound (at the outputs' median) must sit SEP_MAX times and the
# mean bound SEP_MEAN times below the outputs' spread (std), or the
# comparison could not see a fault
SEP_MAX, SEP_MEAN = 3, 100


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


def macs_per_point(pd: int = 10, dd: int = 4, width: int = 256, rgb: int = 128) -> int:
    pe, de = 6 * pd, 6 * dd
    return (pe * width + 3 * width * width + (width + pe) * width + 2 * width * width
            + width + (width + de) * rgb + rgb * 3)


def bound_ms(fm, n: int, s: int, peak: float):
    """(least time in ms, what bounds it) for one pass of n rays x s samples."""
    ops = 2.0 * macs_per_point() * n * s
    weight_bytes = sum(w.numel() * w.element_size() for w in fm.ws + fm.bs)
    io_bytes = 4 * (n * 3 * 2 + n * s) + 4 * (n * 3 + n * s)
    t_ops, t_bytes = ops / peak, (weight_bytes + io_bytes) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
            print(f"[kernel] {prec} N={RAYS} S={s}: color max_abs={ca:.3e} mean_abs={cm:.3e} "
                  f"weights max_abs={wa:.3e} mean_abs={wm:.3e} (tol atol={atol} rtol={rtol} "
                  f"mean_rtol={mean_rtol}) {'PASS' if cok and wok else 'FAIL'}; ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
                  f"({b_by})", flush=True)
            report[(prec, s)] = dict(err=max(ca, wa), ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    if not ok_all:
        raise AssertionError("kernel disagrees with its plain version")


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
    fr.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = list(frames_iter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fr.launches
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
    uniforms = {"coarse": torch.rand((n, cfg.coarse_samples), generator=gen, device=dev),
                "eps": torch.rand((n, 1), generator=gen, device=dev),
                "jitter": torch.rand((n, cfg.fine_samples, 1), generator=gen, device=dev)}
    before = fr.launches
    card = fr.render_rays_fused(params, cfg, o, d, compute_dtype=tcfg.compute_dtype,
                                uniforms=uniforms)
    to_cpu = lambda tree: map_params(lambda t: t.cpu(), tree)  # noqa: E731
    ref = fr.render_rays_fused(to_cpu(params), cfg, o.cpu(), d.cpu(),
                               compute_dtype=tcfg.compute_dtype, uniforms=to_cpu(uniforms))
    fr.launches = before
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


def phase_profile(ckpt: Path, dev):
    """One more frame of the main path under ``torch.profiler``: the share of
    the frame's wall time the kernel takes, and the device's idle share (wall
    time covered by no device activity). A measurement, not a check: where
    the profiler sees no device activity it says so."""
    from torch.profiler import ProfilerActivity, profile

    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.render import render_views

    frames_iter = render_views(str(ckpt), rays=RAYS, num_poses=1, height=HW, width=HW,
                               device=dev)
    before = fr.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(frames_iter)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    fr.launches = before
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("[profile] 1 frame: the profiler recorded no device activity; kernel "
              "and idle shares not measured", flush=True)
        return
    kernel_us = sum(b - a for a, b, name in spans if "fused_fwd_kernel" in name)
    busy_us, end = 0.0, -math.inf
    for a, b, _ in spans:  # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    print(f"[profile] 1 frame {HW}x{HW} under torch.profiler: wall={wall_us / 1e3:.1f} ms, "
          f"device busy={busy_us / 1e3:.1f} ms, fused kernel={kernel_us / 1e3:.1f} ms "
          f"({100 * kernel_us / wall_us:.1f}% of wall), other device work="
          f"{(busy_us - kernel_us) / 1e3:.1f} ms, device idle share="
          f"{100 * (1 - busy_us / wall_us):.1f}%", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from minimal_nerf_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build_all(KERNELS)
    print(f"[build] {KERNELS} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    report = {}
    phase_kernels(dev, report)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, launches = phase_main_path(dev, Path(tmp))
        phase_reference(dev, ckpt)
        try:
            phase_profile(ckpt, dev)
        except Exception as exc:  # a measurement only: the checks ran above
            print(f"[profile] not measured: {type(exc).__name__}: {exc}", flush=True)

    main_shapes = [report[("bf16", s)] for s in SAMPLES]
    entry = {
        "name": "fused_raymarch_fwd",
        "route": "cuda",
        "source": "minimal_nerf_torch/kernels/csrc/fused_raymarch_fwd.cu",
        "replaces": "minimal_nerf_tpu/kernels/fused_raymarch.py:175",
        "launches": launches,
        # one 4096-ray chunk of the main path: the S=64 and S=192 passes, bf16
        "max_abs_err": max(r["err"] for r in main_shapes),
        "ms": sum(r["ms"] for r in main_shapes),
        "plain_ms": sum(r["plain_ms"] for r in main_shapes),
        "bound_ms": sum(r["bound_ms"] for r in main_shapes),
        "bound_by": main_shapes[-1]["bound_by"],
        "library_ms": sum(r["library_ms"] for r in main_shapes),
    }
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
