"""Time variants of the backward kernels (and of the forwards) on the card,
in one process and in turns, beside the kernels as built.

Each variant is a copy of ``csrc/`` with one text substitution, built with
``nvcc`` under ``_build/variants/`` and swapped into the wrappers (through
``build._LIBS``). A variant that turns work off gives wrong gradients: it
only says what that work costs, and its errors against the plain version
are printed beside its times. Run from the repo root on a machine with a
card (it uses ``chip_smoke.py``'s timers and inputs):

    python -m minimal_nerf_torch.kernels.variants [--parent DIR]

``--parent`` names the ``csrc/`` directory of another commit (for example
unpacked by ``git archive``); its forward kernels join the comparison as
``parent``. Each line gives the variant's ms per call (CUDA events, two
turns: the order is as built, the variants, then back) and, for the
backwards, the device time of kernels A, B and R.
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

# text substitutions in csrc/, each against the sources as they are
BWD_VARIANTS = {
    # kernel A without its scratch stores
    "no scratch stores": [("      if (r < rows)\n        __stcs(",
                           "      if (r < 0)\n        __stcs(")],
    # every layer's stores at its first k-step, as one burst
    "stores in one burst": [(
        "const int i0 = kk * PER_THREAD / ksteps, i1 = (kk + 1) * PER_THREAD / ksteps;",
        "const int i0 = kk == 0 ? 0 : PER_THREAD, i1 = PER_THREAD;")],
    # kernel A without its bias sums
    "no bias sums": [("reverse_sweep<T, true>", "reverse_sweep<T, false>")],
    # kernel B with five stages of 32 points in its ring
    "kernel B 32-point stages": [("WB_P = 64, WB_STAGES = 3", "WB_P = 32, WB_STAGES = 5")],
    # twice as many point slices (a shorter tail of kernel B's last wave)
    "kernel B 128 slices": [("long long slices = (p + 4095) / 4096;",
                             "long long slices = (p + 2047) / 2048;"),
                            ("(slices > 64 ? 64 : slices)", "(slices > 128 ? 128 : slices)")],
}
# the dense layer's weight loads, two k-steps ahead (as built) and one
PREFETCH_1 = """  uint2 bcur[NT], bnext[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) bcur[j] = __ldg(wp + (size_t)j * ksteps * 32);
  for (int kk = 0; kk < ksteps; ++kk) {
    const bool more = kk + 1 < ksteps;
    if (more) {
#pragma unroll
      for (int j = 0; j < NT; ++j) bnext[j] = __ldg(wp + ((size_t)j * ksteps + kk + 1) * 32);
    }"""
PREFETCH_2 = """  uint2 bcur[NT], bnext[NT], bfar[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) bcur[j] = __ldg(wp + (size_t)j * ksteps * 32);
#pragma unroll
  for (int j = 0; j < NT; ++j) bnext[j] = __ldg(wp + ((size_t)j * ksteps + 1) * 32);
  for (int kk = 0; kk < ksteps; ++kk) {
    const bool more = kk + 1 < ksteps;
    if (kk + 2 < ksteps) {
#pragma unroll
      for (int j = 0; j < NT; ++j) bfar[j] = __ldg(wp + ((size_t)j * ksteps + kk + 2) * 32);
    }"""
SHIFT_1 = """      for (int j = 0; j < NT; ++j) bcur[j] = bnext[j];"""
SHIFT_2 = """      for (int j = 0; j < NT; ++j) {
        bcur[j] = bnext[j];
        bnext[j] = bfar[j];
      }"""
# substitutions in the dense layer that every kernel of KERNELS shares
SHARED_VARIANTS = {
    # each weight fragment loaded one k-step ahead of its products
    "weights one k-step ahead": [(PREFETCH_2, PREFETCH_1), (SHIFT_2, SHIFT_1)],
}
KERNELS = ("fused_raymarch_bwd", "raymarch_mlp_bwd", "fused_raymarch_fwd", "raymarch_mlp_fwd")


def build_variants(parent: Path | None):
    """{(kernel, variant): loaded library}; prints ptxas's registers and
    spills of each."""
    out_dir = build.BUILD_DIR / "variants"
    jobs = {}
    for kernel in KERNELS:
        plans = {"as built": (build.CSRC, [])}
        if kernel.endswith("bwd"):
            plans.update({v: (build.CSRC, subs) for v, subs in BWD_VARIANTS.items()})
        elif parent is not None:  # the forwards' C interface is unchanged
            plans["parent"] = (parent, [])
        plans.update({v: (build.CSRC, subs) for v, subs in SHARED_VARIANTS.items()})
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("variants: no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"[variants] {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    libs = build_variants(args.parent)
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
                                   {"A": ("fused_fwd_kernel",)}),
            "raymarch_mlp_fwd": (lambda: rm.points_forward(fm, x, xd),
                                 lambda: rm.points_forward_plain(fm, x, xd),
                                 {"A": ("points_fwd_kernel",)}),
        }
        for kernel, (fn, plain_fn, parts) in calls.items():
            plain = plain_fn()
            names = [v for k, v in libs if k == kernel]
            times = {v: [] for v in names}
            for v in names + names[::-1]:
                build._LIBS[kernel] = libs[(kernel, v)]
                times[v].append((cs.cuda_ms(fn, warmup=1, reps=5),
                                 cs.device_split(fn, parts, reps=3)))
            for v in names:
                build._LIBS[kernel] = libs[(kernel, v)]
                out = fn()
                if kernel.endswith("bwd"):
                    errs = cs.bwd_errors(out[0] + out[1], plain[0] + plain[1])
                    err = (f"max_rel={max(e[0] for e in errs):.3e} "
                           f"mean_rel={max(e[1] for e in errs):.3e}")
                else:
                    err = "max_abs=" + ",".join(f"{(a - b).abs().max().item():.3e}"
                                                for a, b in zip(out, plain))
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
