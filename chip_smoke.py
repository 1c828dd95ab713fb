"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Builds every kernel of the serving and training paths from the sources in
the checkout (the fused ray-march forward and backward, and the point-level
MLP forward and backward of the ``--kernel pallas`` path), holds each
against its plain PyTorch version at the main paths' shapes (on weights
whose outputs depend on the input, with bounds shown to reject faulty
versions), then:

- ``[main]`` renders two 800x800 orbit frames from a full-width checkpoint
  written by the port and checks that the forward kernel carried the render;
- ``[reference]`` holds a small render on the card against the CPU;
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
- ``[profile]`` profiles one frame, one train step and one pallas train step
  for the kernels' and the idle shares.

Prints one line per phase, the card's name and power limit, a JSON line of
kernel timings, and as its last line ``{"ok": true, "device": {...}}``.
Exits non-zero without a card or when any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

KERNELS = ["fused_raymarch_fwd", "fused_raymarch_bwd", "raymarch_mlp_fwd", "raymarch_mlp_bwd"]
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
    """Launches inside do not count: the kernels' counts are restored after."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import raymarch as rm

    before = (fr.launches, fr.bwd_launches, fr.wgrad_launches, rm.launches, rm.bwd_launches)
    try:
        yield
    finally:
        fr.launches, fr.bwd_launches, fr.wgrad_launches, rm.launches, rm.bwd_launches = before


def counts():
    """(fused forward, fused backward, point forward, point backward) launches."""
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import raymarch as rm

    return fr.launches, fr.bwd_launches, rm.launches, rm.bwd_launches


def reset_counts():
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import raymarch as rm

    fr.launches = fr.bwd_launches = fr.wgrad_launches = rm.launches = rm.bwd_launches = 0


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


def bwd_macs_per_point(pd: int = 10, dd: int = 4, width: int = 256, rgb: int = 128) -> int:
    """The backward's multiply-adds per point: the forward again, the
    activation gradients of every layer but those reading the encodings (t0,
    the skip's f0we, r0wd), and every weight gradient."""
    fwd = macs_per_point(pd, dd, width, rgb)
    no_enc_inputs = fwd - 6 * pd * width - 6 * pd * width - 6 * dd * rgb
    return 2 * fwd + no_enc_inputs


def bound_ms(fm, n: int, s: int, peak: float, macs: int = 0, io_floats: int = 0):
    """(least time in ms, what bounds it) for one pass of n rays x s samples:
    the forward by default, else ``macs`` per point and ``io_floats`` fp32
    values in and out besides the weights."""
    ops = 2.0 * (macs or macs_per_point()) * n * s
    weight_bytes = sum(w.numel() * w.element_size() for w in fm.ws + fm.bs)
    io_bytes = 4 * (io_floats or (n * 3 * 2 + n * s) + (n * 3 + n * s))
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
            plain_ms = cuda_ms(lambda: fr.fused_backward_plain(*args), warmup=1, reps=3)
            lib_ms = cuda_ms(library_bwd_chain(fm, RAYS, s, dev), warmup=1, reps=3)
            io = RAYS * 3 * 3 + RAYS * s * (2 if dw is not None else 1) + sum(
                w.numel() for w in fm.ws + fm.bs)
            b_ms, b_by = bound_ms(fm, RAYS, s, PEAK_BF16 if dtype else PEAK_FP32,
                                  macs=bwd_macs_per_point(), io_floats=io)
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
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
                  f"({b_by}) {'PASS' if ok else 'FAIL'}", flush=True)
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
            print(f"[kernel-mlp] {prec} P={RAYS}x{s}: sigma max_abs={sa:.3e} mean_abs={sm:.3e} "
                  f"(tol atol/rtol/mean_rtol {tols[0]}) rgb max_abs={ra:.3e} mean_abs="
                  f"{rmean:.3e} (tol {tols[1]}); spread (std) sigma={spread[0]:.3e} rgb="
                  f"{spread[1]:.3e}, element bound at the median sigma={max_at[0]:.3e} rgb="
                  f"{max_at[1]:.3e} (need {SEP_MAX}x below), mean bound sigma={mean_at[0]:.3e} "
                  f"rgb={mean_at[1]:.3e} (need {SEP_MEAN}x below); faulty plain versions "
                  f"passed: {missed or 'none'}; ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
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
            plain_ms = cuda_ms(lambda: rm.points_backward_plain(*args), warmup=1, reps=3)
            lib_ms = cuda_ms(library_bwd_chain(fm, RAYS, s, dev), warmup=1, reps=3)
            # bytes: x, d, dsig, drgb in, the 22 gradients out
            io = RAYS * s * 10 + sum(w.numel() for w in fm.ws + fm.bs)
            b_ms, b_by = bound_ms(fm, RAYS, s, PEAK_BF16 if dtype else PEAK_FP32,
                                  macs=bwd_macs_per_point(), io_floats=io)
            ok = within and same and not missed
            ok_all &= ok
            print(f"[kernel-mlp-bwd] {prec} P={RAYS}x{s}: 22 leaves, worst over the leaves "
                  f"max_rel={max(e[0] for e in errs):.3e} mean_rel={max(e[1] for e in errs):.3e} "
                  f"(bounds {tol[0]} / {tol[1]}); max_abs={max(e[2] for e in errs):.3e}; biases "
                  f"worst max_rel={max(e[0] for e in errs[12:]):.3e}; leaf spread (std) over the "
                  f"element bound >= {min(a for a, _ in seps):.2f}x, over the mean bound >= "
                  f"{min(b for _, b in seps):.1f}x; two launches bit-identical: {same}; faulty "
                  f"plain versions passed: {missed or 'none'}; ms={ms:.4f} plain_ms="
                  f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"{'PASS' if ok else 'FAIL'}", flush=True)
            report[("mlp-bwd", prec, s)] = dict(err=max(e[2] for e in errs), ms=ms,
                                                plain_ms=plain_ms, library_ms=lib_ms,
                                                bound_ms=b_ms, bound_by=b_by)
            del kw, kb, again, plain
            torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("point backward kernel disagrees with its plain version")


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


TRAIN_FRAMES, TRAIN_STEPS = 20, 100


def make_train_scene(dev):
    """The procedural ``random_object`` scene: 20 train frames at 800x800,
    rendered on the card by the port's ``data/procedural.py``."""
    from minimal_nerf_torch.data.procedural import make_procedural_scene

    t0 = time.perf_counter()
    scenes, _ = make_procedural_scene((("train", TRAIN_FRAMES),), height=HW, width=HW,
                                      scene="object", seed=0, chunk=8192, device=dev)
    torch.cuda.synchronize()
    scene = scenes["train"]
    print(f"[train] scene: {TRAIN_FRAMES} frames {HW}x{HW} made on the card in "
          f"{time.perf_counter() - t0:.1f} s; image mean {scene.images.float().mean().item():.2f}",
          flush=True)
    return scene


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
    counts = dict(fwd=fr.launches, bwd=fr.bwd_launches, wgrad=fr.wgrad_launches)
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
    before = fr.launches
    frame = next(iter(frames_iter))
    renders, fr.launches = fr.launches - before, before
    want_r = 2 * math.ceil(HW * HW / RAYS)
    ok = frame.shape == (HW, HW, 3) and str(frame.dtype) == "uint8" and renders == want_r
    print(f"[train] checkpoint {ckpt.name} rendered through the render path: {frame.shape} "
          f"{frame.dtype}, mean {float(frame.mean()):.2f}, forward launches {renders} (want "
          f"{want_r}) {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("render from the trained checkpoint failed")
    return dict(ms=ms, losses=losses, counts=counts, bias=bias), step_fn, params, state


def phase_train_reference(dev, scene, bias: float, kernel: str = "fused"):
    """One train step on the card (kernels) against the same step on the
    CPU (plain versions): shared weights, a 256-ray batch and shared draws,
    full width, bf16, through the render hooks of ``kernel``."""
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training import loop
    from minimal_nerf_torch.training.checkpoint import flatten_tree
    from minimal_nerf_torch.training.config import TrainConfig

    cfg, tcfg = NeRFConfig(), TrainConfig(kernel=kernel)
    n = 256
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = loop.sample_train_batch(0, scene.images, scene.poses, loop.scene_static(scene), n,
                                    TRAIN_FRAMES, tcfg.cropping_epochs, 0, generator=gen)
    batch = {k: batch[k] for k in ("origin", "direc", "rgb")}
    uniforms = {"coarse": torch.rand((n, cfg.coarse_samples), generator=gen, device=dev),
                "eps": torch.rand((n, 1), generator=gen, device=dev),
                "jitter": torch.rand((n, cfg.fine_samples, 1), generator=gen, device=dev)}
    to_cpu = lambda tree: map_params(lambda t: t.detach().cpu(), tree)  # noqa: E731
    lr = loop.make_lr_schedule(tcfg, TRAIN_FRAMES)(0)
    results, ran = [], []
    for device, params, b, u in (
            (dev, init_train_params(dev, cfg, bias), batch, uniforms),
            ("cpu", to_cpu(init_train_params(dev, cfg, bias)), to_cpu(batch), to_cpu(uniforms))):
        mlp_apply, render_fn = loop.kernel_hooks(kernel, device)
        with uncounted():
            before = counts()
            metrics, grads = loop.loss_and_grads(params, cfg, b, tcfg.compute_dtype, render_fn,
                                                 uniforms=u, mlp_apply=mlp_apply)
            ran.append(tuple(a - c for a, c in zip(counts(), before)))
        loop.adam_update(params, grads, loop.adam_init(params), lr)
        results.append((metrics["train_loss"].item(), flatten_tree(to_cpu(grads)),
                        flatten_tree(to_cpu(params))))
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
    # the card's step went through this path's kernels (2 passes each way),
    # the CPU's through none
    want = (2, 2, 0, 0) if kernel == "fused" else (0, 0, 2, 2)
    ok = (loss_rel <= 1e-3 and bwd_within(errs, BWD_TOL["bf16"])
          and p_max <= 2.0 * lr * 1.001 and p_mean <= 0.05 * lr and ran == [want, (0,) * 4])
    tag = "train-reference" if kernel == "fused" else f"{kernel}-reference"
    print(f"[{tag}] one step, {n} rays, bf16, --kernel {kernel}, card (kernels) vs CPU "
          f"(plain), shared weights, batch and draws: launches (fused fwd, bwd, point fwd, "
          f"bwd) card {ran[0]} cpu {ran[1]} (want {want}, none); loss card {card_loss:.6f} cpu "
          f"{cpu_loss:.6f} (rel {loss_rel:.2e}, tol 1e-3); gradients worst over the leaves "
          f"max_rel={max(e[0] for e in errs):.3e} mean_rel={max(e[1] for e in errs):.3e} (bounds "
          f"{BWD_TOL['bf16'][0]} / {BWD_TOL['bf16'][1]}); params after Adam max |d|="
          f"{p_max:.3e} (tol 2 lr = {2 * lr:.1e}) mean |d|={p_mean:.3e} (tol 0.05 lr) "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{kernel} train step on the card disagrees with the CPU reference")


def phase_train_pallas(dev, tmp: Path, scene, bias: float):
    """100 full-width steps of the ``--kernel pallas`` path
    (``kernel_hooks("pallas")``: the point kernels under the plain render)
    at ``TrainConfig(kernel="pallas")``, otherwise the defaults; a
    checkpoint of the result rendered through ``--kernel auto``."""
    from minimal_nerf_torch import views
    from minimal_nerf_torch.kernels import fused_raymarch as fr
    from minimal_nerf_torch.kernels import raymarch as rm
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.render import render_views
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, scene.images, scene.poses, step, 0)
        losses.append(metrics["train_loss"].item())
        times.append(time.perf_counter() - t0)
    counts = dict(fwd=rm.launches, bwd=rm.bwd_launches, fused=fr.launches + fr.bwd_launches)
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
    ckpt = save_checkpoint(tmp / checkpoint_name("pallas", TRAIN_STEPS // TRAIN_FRAMES,
                                                 TRAIN_STEPS),
                           params, TRAIN_STEPS, cfg.to_dict(), tcfg.to_dict())
    resolved = views.resolve_inference_kernel("auto", tcfg, dev)
    # two orbit frames; the second is timed (the first includes loading the
    # checkpoint and packing the weights)
    frames_iter = iter(render_views(str(ckpt), rays=RAYS, num_poses=2, height=HW, width=HW,
                                    kernel="auto", device=dev))
    reset_counts()
    next(frames_iter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = next(frames_iter)
    torch.cuda.synchronize()
    ms_frame = 1e3 * (time.perf_counter() - t0)
    renders, fused = rm.launches, fr.launches
    want_r = 2 * 2 * math.ceil(HW * HW / RAYS)
    ok = (resolved == "pallas" and frame.shape == (HW, HW, 3) and str(frame.dtype) == "uint8"
          and renders == want_r and fused == 0)
    print(f"[train-pallas] checkpoint {ckpt.name} (trained under --kernel pallas) rendered "
          f"through --kernel auto -> {resolved!r}: 2 frames {frame.shape} {frame.dtype}, mean "
          f"{float(frame.mean()):.2f}, ms/frame={ms_frame:.1f} (the second) rays/s="
          f"{HW * HW / (ms_frame / 1e3):.0f}, point forward launches {renders} (want {want_r} "
          f"= 2 frames x 157 chunks x 2 passes), fused launches {fused} (want 0) "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("render from the pallas-trained checkpoint failed")
    return dict(ms=ms, ms_frame=ms_frame, counts=counts, frame_launches=renders), step_fn, \
        params, state


def phase_pallas_reference(dev, scene, bias: float):
    """The ``--kernel pallas`` path on the card against the CPU: a 256-ray
    render (shared weights and draws), then one 256-ray train step."""
    from minimal_nerf_torch.kernels import raymarch as rm
    from minimal_nerf_torch.models.mlp import map_params
    from minimal_nerf_torch.models.nerf import NeRFConfig, render_rays

    cfg, n = NeRFConfig(), 256
    gen = torch.Generator(device=dev).manual_seed(7)
    o, d, _ = sample_rays(n, 1, gen, dev)
    uniforms = {"coarse": torch.rand((n, cfg.coarse_samples), generator=gen, device=dev),
                "eps": torch.rand((n, 1), generator=gen, device=dev),
                "jitter": torch.rand((n, cfg.fine_samples, 1), generator=gen, device=dev)}
    params = init_train_params(dev, cfg, bias)
    to_cpu = lambda tree: map_params(lambda t: t.cpu(), tree)  # noqa: E731
    with torch.no_grad(), uncounted():
        before = counts()
        card = render_rays(params, cfg, o, d, compute_dtype=torch.bfloat16,
                           mlp_apply=rm.make_mlp_kernel_apply(), uniforms=uniforms)
        ran = tuple(a - c for a, c in zip(counts(), before))
        ref = render_rays(to_cpu(params), cfg, o.cpu(), d.cpu(), compute_dtype=torch.bfloat16,
                          mlp_apply=rm.make_mlp_kernel_apply(), uniforms=to_cpu(uniforms))
    # same weights, draws and rounding points: the kernel and the plain
    # version differ only in the order of fp32 sums (see TOL)
    ok, msg = ran == (0, 0, 2, 0), [f"card launches (fused fwd, bwd, point fwd, bwd) {ran}"]
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


FUSED_GROUPS = {"forward kernel": ("fused_fwd_kernel",),
                "backward kernels": ("fused_bwd_kernel", "wgrad_", "reduce_slices")}
POINT_GROUPS = {"point forward kernel": ("points_fwd_kernel",),
                "point backward kernels": ("points_bwd_kernel", "wgrad_", "reduce_slices")}


def profile_shares(label: str, fn, groups=FUSED_GROUPS):
    """Run ``fn`` under ``torch.profiler``: print each group of kernels'
    time and share of the wall time (the backward's split by kernel), other
    device work and the device's idle share (wall time covered by no device
    activity). Fails when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with uncounted(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError(f"[profile] {label}: the profiler recorded no device activity")
    kernel_us = lambda key: sum(b - a for a, b, name in spans if key in name)  # noqa: E731
    parts, kernels_us = [], 0.0
    for group, keys in groups.items():
        each = [kernel_us(k) for k in keys]
        kernels_us += sum(each)
        split = (" (" + ", ".join(f"{k.strip('_')} {u / 1e3:.2f}" for k, u in zip(keys, each))
                 + ")") if len(keys) > 1 else ""
        parts.append(f"{group}={sum(each) / 1e3:.1f} ms ({100 * sum(each) / wall_us:.1f}% of "
                     f"wall){split}")
    busy_us, end = 0.0, -math.inf
    for a, b, _ in spans:  # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    print(f"[profile] {label} under torch.profiler: wall={wall_us / 1e3:.1f} ms, device "
          f"busy={busy_us / 1e3:.1f} ms, {', '.join(parts)}, other device work="
          f"{(busy_us - kernels_us) / 1e3:.1f} ms, device idle share="
          f"{100 * (1 - busy_us / wall_us):.1f}%", flush=True)


def phase_profile(ckpt: Path, dev, train_step, pallas_step):
    """One more frame of the render path, one more train step, and one more
    step of the pallas path."""
    from minimal_nerf_torch.render import render_views

    frames_iter = render_views(str(ckpt), rays=RAYS, num_poses=1, height=HW, width=HW,
                               device=dev)
    profile_shares(f"1 frame {HW}x{HW}", lambda: list(frames_iter))
    profile_shares(f"1 train step ({RAYS} rays)", train_step)
    profile_shares(f"1 pallas train step ({RAYS} rays)", pallas_step, POINT_GROUPS)


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
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, launches = phase_main_path(dev, Path(tmp))
        phase_reference(dev, ckpt)
        scene = make_train_scene(dev)
        train, step_fn, params, state = phase_train(dev, Path(tmp), scene)
        phase_train_reference(dev, scene, train["bias"])
        pallas, p_step_fn, p_params, p_state = phase_train_pallas(dev, Path(tmp), scene,
                                                                  train["bias"])
        phase_pallas_reference(dev, scene, train["bias"])
        phase_profile(ckpt, dev,
                      lambda: step_fn(params, state, scene.images, scene.poses, TRAIN_STEPS, 0),
                      lambda: p_step_fn(p_params, p_state, scene.images, scene.poses,
                                        TRAIN_STEPS, 0))

    def entry(name, replaces, shapes, launches):
        # one 4096-ray chunk or step of the main paths: S=64 and S=192, bf16
        return {"name": name, "route": "cuda",
                "source": f"minimal_nerf_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["err"] for r in shapes),
                "ms": sum(r["ms"] for r in shapes),
                "plain_ms": sum(r["plain_ms"] for r in shapes),
                "bound_ms": sum(r["bound_ms"] for r in shapes),
                "bound_by": shapes[-1]["bound_by"],
                "library_ms": sum(r["library_ms"] for r in shapes)}

    kernels = [
        entry("fused_raymarch_fwd", "minimal_nerf_tpu/kernels/fused_raymarch.py:175",
              [report[("bf16", s)] for s in SAMPLES], launches),
        entry("fused_raymarch_bwd", "minimal_nerf_tpu/kernels/fused_raymarch.py:191",
              [report[("bwd", "bf16", s)] for s in SAMPLES], train["counts"]["bwd"]),
        entry("raymarch_mlp_fwd", "minimal_nerf_tpu/kernels/raymarch.py:73",
              [report[("mlp", "bf16", s)] for s in SAMPLES], pallas["counts"]["fwd"]),
        entry("raymarch_mlp_bwd", "minimal_nerf_tpu/kernels/raymarch.py:277",
              [report[("mlp-bwd", "bf16", s)] for s in SAMPLES], pallas["counts"]["bwd"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
