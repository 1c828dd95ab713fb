"""Time variants of the forward and backward kernels on the card, in one
process and in turns, beside the kernels as built.

Each variant is a copy of ``csrc/`` with one text substitution, built with
``nvcc`` under ``_build/variants/`` and swapped into the wrappers (through
``build._LIBS``). A variant that turns work off gives wrong gradients: it
only says what that work costs, and its errors against the plain version
are printed beside its times. Run from the repo root on a machine with a
card (it uses ``chip_smoke.py``'s timers and inputs):

    python -m minimal_nerf_torch.kernels.variants [--parent DIR] [--kernels NAME ...]

``--parent`` names the ``csrc/`` directory of another commit (for example
unpacked by ``git archive``); its forward kernels join the comparison as
``parent``, called through their own C interface (before the tensor maps:
every weight from ``kernel_ws``) where they export no
``mlp_fwd_sm90_maps``. ``--kernels`` picks some of ``KERNELS``. Each line
gives the variant's ms per call (CUDA events, two turns: the order is as
built, the variants, then back) and its device time (for the backwards,
of kernels A, B and R).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import time
from pathlib import Path

import torch

import chip_smoke as cs
from minimal_nerf_torch.kernels import build
from minimal_nerf_torch.kernels import fused_raymarch as fr
from minimal_nerf_torch.kernels import raymarch as rm
from minimal_nerf_torch.models.mlp import init_nerf_mlp

# text substitutions in csrc/, each against the sources as they are, per
# kernel: the point backward's kernel A (fused_raymarch_common.cuh's
# KeepRows and reverse_sweep), the fused backward's bf16 kernel A
# (mlp_bwd_sm90.cuh), kernel B of both
_B_KERNELS = ("fused_raymarch_bwd", "raymarch_mlp_bwd")
BWD_VARIANTS = {
    # kernel A without its scratch stores
    "no scratch stores": {"raymarch_mlp_bwd": [("      if (r < rows)\n        __stcs(",
                                                "      if (r < 0)\n        __stcs(")]},
    # every layer's stores at its first k-step, as one burst
    "stores in one burst": {"raymarch_mlp_bwd": [(
        "const int i0 = kk * PER_THREAD / ksteps, i1 = (kk + 1) * PER_THREAD / ksteps;",
        "const int i0 = kk == 0 ? 0 : PER_THREAD, i1 = PER_THREAD;")]},
    # kernel A without its bias sums
    "no bias sums": {"raymarch_mlp_bwd": [("reverse_sweep<T, true>", "reverse_sweep<T, false>")]},
    # the wgmma kernel A without its scratch stores (its mask words kept;
    # wrong gradients)
    "sm90 scratch stores off": {"fused_raymarch_bwd": [(
        "    if (r < k.rows)\n      __stcs(reinterpret_cast<uint4*>(p.dst",
        "    if (r < 0)\n      __stcs(reinterpret_cast<uint4*>(p.dst")]},
    # ... with its scratch stores as plain stores, without the streaming hint
    "sm90 plain stores": {"fused_raymarch_bwd": [(
        "      __stcs(reinterpret_cast<uint4*>(p.dst + (long long)r * p.ch + c * KC + j * 8), v);",
        "      *reinterpret_cast<uint4*>(p.dst + (long long)r * p.ch + c * KC + j * 8) = v;")]},
    # ... without forming and storing the forward's mask words (wrong gradients)
    "sm90 mask words off": {"fused_raymarch_bwd": [
        ("    if (p.w0 >= 0) {\n      uint32_t bits", "    if (p.w0 >= 1 << 20) {\n      uint32_t bits"),
        ("  if (p.w0 >= 0 && c == p.ch / KC - 1) {", "  if (p.w0 >= 1 << 20 && c == p.ch / KC - 1) {")]},
    # ... without copying its staged layers out at all (wrong gradients)
    "sm90 drains off": {"fused_raymarch_bwd": [
        ("if (j < p.ch / KC) drain_chunk(k, p, j);", "if (j < 0) drain_chunk(k, p, j);"),
        ("for (int c = 0; c < p.ch / KC; ++c) drain_chunk", "for (int c = 0; c < 0; ++c) drain_chunk")]},
    # what the weights' traffic costs: the producer releases each stage
    # without loading it (wrong gradients)
    "sm90 weight loads off": {"fused_raymarch_bwd": [(
        "    mbar_expect_tx(bars + 8 * stage, n * KC * 2);\n    for (int h = 0; h < HALVES; ++h)",
        "    mbar_arrive(bars + 8 * stage);\n    for (int h = 0; h < 0; ++h)")]},
    # kernel B with five stages of 32 points in its ring
    "kernel B 32-point stages": {k: [("WB_P = 64, WB_STAGES = 3", "WB_P = 32, WB_STAGES = 5")]
                                 for k in _B_KERNELS},
    # twice as many point slices (a shorter tail of kernel B's last wave)
    "kernel B 128 slices": {k: [("long long slices = (p + 4095) / 4096;",
                                 "long long slices = (p + 2047) / 2048;"),
                                ("(slices > 64 ? 64 : slices)", "(slices > 128 ? 128 : slices)")]
                            for k in _B_KERNELS},
}
# the bf16 forwards' design (csrc/mlp_fwd_sm90.cuh), per kernel
FWD_VARIANTS = {
    # three stages of 32 KB in the weight ring (as built: four; five leave
    # the fused kernel no room for its own buffers)
    "ring 3 stages": {k: [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]
                      for k in ("fused_raymarch_fwd", "raymarch_mlp_fwd")},
    # clusters of two CTAs, each loading half of every slab into both
    "cluster multicast": {k: [("constexpr int CLUSTER = 1;", "constexpr int CLUSTER = 2;")]
                          for k in ("fused_raymarch_fwd", "raymarch_mlp_fwd")},
    # one buffer of encodings: the encoder warps fill it only once the
    # consumers are done with the last tile (as built: two)
    "encoding overlap off": {k: [("constexpr int ENC_BUFS = 2;", "constexpr int ENC_BUFS = 1;")]
                             for k in ("fused_raymarch_fwd", "raymarch_mlp_fwd")},
    # fewer registers for the producer warpgroup's encoders, more for the
    # consumers (as built: 56 and 224)
    "registers 40/232": {k: [("PRODUCER_REGS = 56, CONSUMER_REGS = 224",
                              "PRODUCER_REGS = 40, CONSUMER_REGS = 232")]
                         for k in ("fused_raymarch_fwd", "raymarch_mlp_fwd")},
    # the consumers' clock counts by phase (mlp_fwd_sm90.cuh TIMING)
    "phase clocks": {k: [("constexpr bool TIMING = false;", "constexpr bool TIMING = true;")]
                     for k in ("fused_raymarch_fwd", "raymarch_mlp_fwd")},
    # what the weights' traffic costs: the producer releases each stage
    # without loading it (wrong outputs)
    "weight loads off": {k: [(
        "    mbar_expect_tx(bars + 8 * stage, n * KC * 2);\n"
        "    for (int h = half0; h < half0 + HALVES / CLUSTER; ++h) {",
        "    mbar_arrive(bars + 8 * stage);\n"
        "    for (int h = half0; h < half0 * 0; ++h) {")]
        for k in ("fused_raymarch_fwd", "raymarch_mlp_fwd")},
}
KERNELS = ("fused_raymarch_fwd", "raymarch_mlp_fwd", "fused_raymarch_bwd", "raymarch_mlp_bwd")


def build_variants(kernels, parent: Path | None):
    """{(kernel, variant): loaded library}; prints ptxas's registers and
    spills of each."""
    out_dir = build.BUILD_DIR / "variants"
    jobs = {}
    for kernel in kernels:
        plans = {"as built": (build.CSRC, [])}
        if kernel.endswith("bwd"):
            plans.update({v: (build.CSRC, subs[kernel]) for v, subs in BWD_VARIANTS.items()
                          if kernel in subs})
        else:
            if parent is not None:
                plans["parent"] = (parent, [])
            plans.update({v: (build.CSRC, subs[kernel]) for v, subs in FWD_VARIANTS.items()
                          if kernel in subs})
        for variant, (src, subs) in plans.items():
            d = out_dir / variant.replace(" ", "_") / kernel
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(src, d)
            for a, b in subs:
                hits = 0
                for f in d.iterdir():
                    text = f.read_text()
                    hits += text.count(a)
                    f.write_text(text.replace(a, b))
                if hits == 0:
                    raise RuntimeError(f"variant {variant!r}: {a[:40]!r} not in the sources")
            lib = d / f"lib{kernel}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(d / f"{kernel}.cu")]
            jobs[(kernel, variant)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[variants] {key[0]} {key[1]!r}: {line.strip()}", flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def old_forward(lib, kernel: str, fm, inputs):
    """A bf16 forward through the C interface that takes no tensor maps and
    reads every weight from ``fm.kernel_ws`` (position_dim 10,
    direction_dim 4)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    (w, _kw), (b, _kb) = fr._ptrs(fm.kernel_ws), fr._ptrs(fm.kernel_bs)
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "fused_raymarch_fwd":
        o, d, ts = inputs
        n, s = ts.shape
        out = (torch.empty((n, 3), device=ts.device), torch.empty((n, s), device=ts.device))
        fn = lib.fused_raymarch_fwd
        fn.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p, p]
        fn.restype = i
        rc = fn(o.data_ptr(), d.data_ptr(), ts.data_ptr(), n, s, 10, 4, 1, w, b,
                out[0].data_ptr(), out[1].data_ptr(), stream)
    else:
        x, xd = inputs
        n = x.shape[0]
        out = (torch.empty((n, 1), device=x.device), torch.empty((n, 3), device=x.device))
        fn = lib.raymarch_mlp_fwd
        fn.argtypes = [p, p, i, i, i, i, p, p, p, p, p]
        fn.restype = i
        rc = fn(x.data_ptr(), xd.data_ptr(), n, 10, 4, 1, w, b, out[0].data_ptr(),
                out[1].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} (parent) launch failed with code {rc}")
    return out


# mlp_fwd_sm90.cuh's phases (PH_FULL .. PH_EPI), then mlp_rows whole and
# the time between its calls
PHASES = ("waits for a slab's bytes", "issuing the products", "waits for the products",
          "epilogues and heads")


def phase_shares(lib, fn) -> str:
    """The consumers' clocks of one call of ``fn`` (a build with TIMING on)
    by phase, as shares of all their clocks (mlp_rows and between)."""
    read = lib.mlp_fwd_sm90_phase_cycles
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * (len(PHASES) + 2))()
    torch.cuda.synchronize()
    if read(out) != 0:  # zero the counts
        raise RuntimeError("mlp_fwd_sm90_phase_cycles failed")
    fn()
    torch.cuda.synchronize()
    if read(out) != 0:
        raise RuntimeError("mlp_fwd_sm90_phase_cycles failed")
    *phases, rows, outside = (int(v) for v in out)
    total = rows + outside
    parts = dict(zip(PHASES, phases))
    parts["the rest of the layers"] = rows - sum(phases)
    parts["outside the layers (encodings, compositing)"] = outside
    return "phase clocks: " + ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in parts.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("variants: no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"[variants] {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    libs = build_variants(args.kernels, args.parent)
    print(f"[variants] {len(libs)} libraries built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(gen, device=dev, gain=cs.HE_GAIN), torch.bfloat16)
    for s in cs.SAMPLES:
        o, d, ts = cs.sample_rays(cs.RAYS, s, gen, dev)
        dc = torch.randn((cs.RAYS, 3), generator=gen, device=dev)
        dw = 0.1 * torch.randn((cs.RAYS, s), generator=gen, device=dev) if s == 64 else None
        x, xd = cs.point_inputs(cs.RAYS, s, gen, dev)
        dsig = torch.randn((cs.RAYS * s, 1), generator=gen, device=dev)
        drgb = torch.randn((cs.RAYS * s, 3), generator=gen, device=dev)
        calls = {
            "fused_raymarch_bwd": (lambda: fr.fused_backward(fm, o, d, ts, dc, dw),
                                   lambda: fr.fused_backward_plain(fm, o, d, ts, dc, dw),
                                   cs.BWD_PARTS["fused"]),
            "raymarch_mlp_bwd": (lambda: rm.points_backward(fm, x, xd, dsig, drgb),
                                 lambda: rm.points_backward_plain(fm, x, xd, dsig, drgb),
                                 cs.BWD_PARTS["point"]),
            "fused_raymarch_fwd": (lambda: fr.fused_forward(fm, o, d, ts),
                                   lambda: fr.fused_forward_plain(fm, o, d, ts),
                                   {"device": ("fused_fwd",)}),
            "raymarch_mlp_fwd": (lambda: rm.points_forward(fm, x, xd),
                                 lambda: rm.points_forward_plain(fm, x, xd),
                                 {"device": ("points_fwd",)}),
        }
        inputs = {"fused_raymarch_fwd": (o, d, ts), "raymarch_mlp_fwd": (x, xd)}

        def call(kernel, v, wrapper):
            lib = libs[(kernel, v)]
            build._LIBS[kernel] = lib
            if kernel.endswith("bwd") or hasattr(lib, "mlp_fwd_sm90_maps"):
                return wrapper
            return lambda: old_forward(lib, kernel, fm, inputs[kernel])

        for kernel in args.kernels:
            fn, plain_fn, parts = calls[kernel]
            plain = plain_fn()
            names = [v for k, v in libs if k == kernel]
            times = {v: [] for v in names}
            for v in names + names[::-1]:
                run = call(kernel, v, fn)
                times[v].append((cs.cuda_ms(run, warmup=1, reps=5),
                                 cs.device_split(run, parts, reps=3)))
            for v in names:
                out = call(kernel, v, fn)()
                if kernel.endswith("bwd"):
                    errs = cs.bwd_errors(out[0] + out[1], plain[0] + plain[1])
                    err = (f"max_rel={max(e[0] for e in errs):.3e} "
                           f"mean_rel={max(e[1] for e in errs):.3e}")
                else:
                    err = "max_abs=" + ",".join(f"{(a - b).abs().max().item():.3e}"
                                                for a, b in zip(out, plain))
                if v == "phase clocks":
                    print(f"[variants] {kernel} bf16 S={s} {phase_shares(libs[(kernel, v)], fn)}",
                          flush=True)
                ms = ",".join(f"{t[0]:.4f}" for t in times[v])
                split = " ".join(f"{p}=" + ",".join(f"{t[1][p]:.4f}" for t in times[v])
                                 for p in parts)
                print(f"[variants] {kernel} bf16 S={s} {v!r}: ms={ms} device {split} {err}",
                      flush=True)
            del plain
            torch.cuda.empty_cache()
    build._LIBS.clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
