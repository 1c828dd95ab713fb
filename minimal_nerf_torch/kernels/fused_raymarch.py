"""Fused ray-march forward pass: positions -> encoding -> MLP -> compositing.

Counterpart of ``minimal_nerf_tpu/kernels/fused_raymarch.py`` (forward only;
the backward kernel comes with training). One call per render pass takes
per-ray origins/directions and sample times and returns the composited ray
colors plus the per-sample weights the hierarchical sampler needs.

- ``fused_forward`` is the wrapper: for CUDA tensors it launches the
  hand-written kernel in ``csrc/fused_raymarch_fwd.cu`` (and adds one to
  ``launches``); for CPU tensors it runs ``fused_forward_plain``, the same
  function in plain PyTorch with the same rounding points. Any other device
  raises; there is no fallback.
- ``fused_render_pass`` / ``render_rays_fused`` / ``make_fused_render_fn``
  mirror the JAX entry points.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from minimal_nerf_torch.models.mlp import round_to
from minimal_nerf_torch.ops import rendering
from minimal_nerf_torch.ops.encoding import positional_encoding

Params = Dict[str, Any]

# kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

KERNEL = "fused_raymarch_fwd"
WIDTH, RGB_WIDTH = 256, 128   # the widths the kernel is compiled for
POS_SLOT, DIR_SLOT = 64, 32   # padded encoding widths in the kernel
MAX_SAMPLES = 1024            # samples per ray the kernel's buffer holds


def flatten_mlp_params(params: Params, compute_dtype=None
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Split one MLP into the kernel's 12 weights and 10 biases.

    The two concat layers are split row-wise into (h-part, enc-part);
    weights are cast to the compute dtype; biases stay fp32 as ``[1, out]``
    (``minimal_nerf_tpu/kernels/raymarch.py:104-133``).
    """
    wt = (lambda w: w.to(compute_dtype)) if compute_dtype else (lambda w: w)
    tr, fe, de, rg = params["trunk"], params["feature"], params["density"], params["rgb"]
    width = tr[0]["w"].shape[1]
    ws = [
        wt(tr[0]["w"]), wt(tr[1]["w"]), wt(tr[2]["w"]), wt(tr[3]["w"]),
        wt(fe[0]["w"][:width]), wt(fe[0]["w"][width:]),
        wt(fe[1]["w"]), wt(fe[2]["w"]),
        wt(de["w"]),
        wt(rg[0]["w"][:width]), wt(rg[0]["w"][width:]),
        wt(rg[1]["w"]),
    ]
    bs = [tr[0]["b"], tr[1]["b"], tr[2]["b"], tr[3]["b"],
          fe[0]["b"], fe[1]["b"], fe[2]["b"], de["b"], rg[0]["b"], rg[1]["b"]]
    return ws, [b.float().reshape(1, -1) for b in bs]


class FusedMLP(NamedTuple):
    """One MLP prepared for the fused pass (see ``prepare_fused_mlp``)."""

    ws: List[torch.Tensor]
    bs: List[torch.Tensor]
    dtype: Optional[torch.dtype]
    # kernel operands (packed weights, flat biases) for CUDA, else None
    kernel_ws: Optional[List[torch.Tensor]]
    kernel_bs: Optional[List[torch.Tensor]]


def _pack_mma(w: torch.Tensor, k_pad: int) -> torch.Tensor:
    """``w [K, N]`` bf16 -> mma.sync B fragments ``[N/8, Kp/16, 32, 4]``.

    Lane ``g*4 + t`` of n-tile ``j`` and k-step ``kk`` holds
    ``W^T[j*8 + g][kk*16 + r*8 + t*2 + e]`` for ``r, e in {0, 1}``.
    """
    k, n = w.shape
    wt = torch.zeros((n, k_pad), dtype=w.dtype, device=w.device)
    wt[:, :k] = w.t()
    return (wt.reshape(n // 8, 8, k_pad // 16, 2, 4, 2)
            .permute(0, 2, 1, 4, 3, 5).contiguous())


def _pad_rows(w: torch.Tensor, k_pad: int) -> torch.Tensor:
    out = torch.zeros((k_pad, w.shape[1]), dtype=w.dtype, device=w.device)
    out[: w.shape[0]] = w
    return out


def _kernel_operands(ws, bs, dtype):
    """The weights in the layouts the CUDA kernel reads.

    bf16: every MLP matrix packed in mma fragment order with K padded to the
    kernel's slot; fp32: ``[K_pad, N]`` row-major. The density weight is a
    flat ``[256]`` and the rgb output weight ``[3, 128]``, both in the compute
    dtype.
    """
    width = ws[0].shape[1]
    rgb_width = ws[9].shape[1]
    if width != WIDTH or rgb_width != RGB_WIDTH:
        raise ValueError(f"the fused kernel is built for widths {WIDTH}/{RGB_WIDTH}, "
                         f"got {width}/{rgb_width}")
    k_pad = {0: POS_SLOT, 5: POS_SLOT, 10: DIR_SLOT}
    out = []
    for i, w in enumerate(ws):
        if i == 8:
            out.append(w.reshape(-1).contiguous())
        elif i == 11:
            out.append(w.t().contiguous())
        elif dtype == torch.bfloat16:
            out.append(_pack_mma(w, k_pad.get(i, w.shape[0])))
        else:
            out.append(_pad_rows(w, k_pad.get(i, w.shape[0])).contiguous())
    return out, [b.reshape(-1).contiguous() for b in bs]


def prepare_fused_mlp(params: Params, compute_dtype=None) -> FusedMLP:
    """Flatten (and, on a CUDA device, pack) one MLP for ``fused_forward``."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} not supported")
    dtype = None if compute_dtype == torch.float32 else compute_dtype
    ws, bs = flatten_mlp_params(params, dtype)
    kws = kbs = None
    if ws[0].device.type == "cuda":
        kws, kbs = _kernel_operands(ws, bs, dtype)
    return FusedMLP(ws, bs, dtype, kws, kbs)


def _encode(x: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """The in-kernel encoding: ``x`` rounded to ``dtype`` first, the result
    rounded to ``dtype`` too (returned as fp32 values)."""
    return round_to(positional_encoding(round_to(x, dtype), dim), dtype)


def fused_forward_plain(fm: FusedMLP, o, d, ts, position_dim: int = 10,
                        direction_dim: int = 4):
    """Plain PyTorch version of the kernel: ``color [N, 3]``, ``weights [N, S]``.

    Same rounding points as the kernel and ``_fused_forward_core``; only the
    order of fp32 sums differs (matmuls, ``torch.cumsum`` for the scan).
    """
    ws, bs, dtype = fm.ws, fm.bs, fm.dtype
    (t0w, t1w, t2w, t3w, f0wh, f0we, f1w, f2w, dw, r0wh, r0wd, r1w) = [
        round_to(w, dtype) for w in ws]
    (t0b, t1b, t2b, t3b, f0b, f1b, f2b, db, r0b, r1b) = bs
    n, s = ts.shape

    x = (o[:, None, :] + ts[:, :, None] * d[:, None, :]) * (1.0 / math.pi)
    dn = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True))
    e = _encode(x, position_dim, dtype)  # [N, S, 6*pd]
    ed = _encode(dn, direction_dim, dtype)[:, None, :].expand(n, s, -1)

    act = lambda v: round_to(torch.relu(v), dtype)  # noqa: E731
    a0 = act(e @ t0w + t0b)
    a1 = act(a0 @ t1w + t1b)
    a2 = act(a1 @ t2w + t2b)
    a3 = act(a2 @ t3w + t3b)
    a4 = act(a3 @ f0wh + e @ f0we + f0b)
    a5 = act(a4 @ f1w + f1b)
    h = round_to(a5 @ f2w + f2b, dtype)
    sigma = torch.relu(h @ dw + db)[..., 0]  # [N, S]
    r0 = act(h @ r0wh + ed @ r0wd + r0b)
    rgb = torch.sigmoid(r0 @ r1w + r1b)  # [N, S, 3]

    deltas = torch.cat([ts[:, 1:] - ts[:, :-1],
                        torch.full((n, 1), 1e10, dtype=ts.dtype, device=ts.device)], dim=1)
    ndd = -sigma * deltas
    excl = torch.cat([torch.zeros_like(ndd[:, :1]), torch.cumsum(ndd[:, :-1], dim=1)], dim=1)
    weights = (1.0 - torch.exp(ndd)) * torch.exp(excl)
    color = torch.sum(weights[..., None] * rgb, dim=1)
    return color, weights


def _check(name, t: torch.Tensor, shape, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _launch(fm: FusedMLP, o, d, ts, position_dim, direction_dim):
    global launches
    from minimal_nerf_torch.kernels import build

    n, s = ts.shape
    dev = o.device
    for name, t, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("ts", ts, (n, s))):
        _check(name, t, shape)
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
    if fm.kernel_ws is None or any(w.device != dev for w in fm.kernel_ws + fm.kernel_bs):
        raise ValueError(f"weights are not prepared on {dev}")
    wdtype = fm.dtype or torch.float32
    if any(w.dtype != wdtype or not w.is_contiguous() for w in fm.kernel_ws):
        raise ValueError(f"kernel weights must be contiguous {wdtype}")
    if not 1 <= s <= MAX_SAMPLES:
        raise ValueError(f"the fused kernel takes 1..{MAX_SAMPLES} samples per ray, got {s}")
    if not (1 <= 6 * position_dim <= POS_SLOT and 1 <= 6 * direction_dim <= DIR_SLOT):
        raise ValueError(f"encoding dims {position_dim}/{direction_dim} exceed the "
                         f"kernel's {POS_SLOT}/{DIR_SLOT} channel slots")
    color = torch.empty((n, 3), dtype=torch.float32, device=dev)
    weights = torch.empty((n, s), dtype=torch.float32, device=dev)
    if n == 0:
        return color, weights

    lib = build.load(KERNEL)
    fn = lib.fused_raymarch_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p, p]
    fn.restype = i
    w_ptrs = (ctypes.c_void_p * 12)(*[w.data_ptr() for w in fm.kernel_ws])
    b_ptrs = (ctypes.c_void_p * 10)(*[b.data_ptr() for b in fm.kernel_bs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(o.data_ptr(), d.data_ptr(), ts.data_ptr(), n, s, position_dim,
                direction_dim, int(fm.dtype == torch.bfloat16),
                ctypes.cast(w_ptrs, ctypes.c_void_p), ctypes.cast(b_ptrs, ctypes.c_void_p),
                color.data_ptr(), weights.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed with code {rc}")
    launches += 1
    return color, weights


def fused_forward(fm: FusedMLP, o, d, ts, position_dim: int = 10,
                  direction_dim: int = 4):
    """``color [N, 3]``, ``weights [N, S]`` for ``o, d [N, 3]``, ``ts [N, S]``.

    CUDA tensors go through the kernel, CPU tensors through the plain
    version; any other device raises.
    """
    if o.device.type == "cuda":
        return _launch(fm, o, d, ts, position_dim, direction_dim)
    if o.device.type == "cpu":
        return fused_forward_plain(fm, o, d, ts, position_dim, direction_dim)
    raise ValueError(f"no fused ray-march implementation for device {o.device}")


def fused_render_pass(params, o_rays, d_rays, ts, position_dim: int = 10,
                      direction_dim: int = 4, compute_dtype=None):
    """One fused pass for sample times ``ts [N, S, 1]`` or ``[N, S]``.

    ``params`` is one MLP tree or a ``FusedMLP``. Returns ``color [N, 3]``
    and ``weights [N, S, 1]``.
    """
    fm = params if isinstance(params, FusedMLP) else prepare_fused_mlp(params, compute_dtype)
    ts2 = ts[..., 0] if ts.dim() == 3 else ts
    color, weights = fused_forward(fm, o_rays.float().contiguous(),
                                   d_rays.float().contiguous(),
                                   ts2.float().contiguous(), position_dim, direction_dim)
    return color, weights[..., None]


def render_rays_fused(params: Params, config, o_rays, d_rays,
                      generator: Optional[torch.Generator] = None,
                      compute_dtype=None, mlp_apply=None, coarse_sampler=None,
                      uniforms: Optional[Dict[str, torch.Tensor]] = None):
    """Hierarchical render with both passes through the fused pass.

    Same draws and math as ``models.nerf.render_rays``; sampling and the
    sorted union run in PyTorch between the two passes. ``params`` holds
    ``"coarse"`` and ``"fine"`` MLP trees or ``FusedMLP``s. ``mlp_apply`` is
    accepted for interface parity and ignored.
    """
    from minimal_nerf_torch.models.nerf import fine_times

    sample_coarse = coarse_sampler or rendering.generate_coarse_samples
    uniforms = uniforms or {}
    _, coarse_ts = sample_coarse(o_rays, d_rays, config.coarse_samples, config.near,
                                 config.far, generator=generator,
                                 uniforms=uniforms.get("coarse"))
    pass_ = lambda mlp, ts: fused_render_pass(  # noqa: E731
        mlp, o_rays, d_rays, ts, config.position_dim, config.direction_dim,
        compute_dtype=compute_dtype)
    coarse_color, coarse_weights = pass_(params["coarse"], coarse_ts)
    all_ts = fine_times(config, o_rays, d_rays, coarse_weights, coarse_ts,
                        generator, uniforms)
    fine_color, _ = pass_(params["fine"], all_ts)
    return {"fine_rgb_rays": fine_color, "coarse_rgb_rays": coarse_color}


def make_fused_render_fn():
    """A ``render_fn`` hook (signature of ``models.nerf.render_rays``).

    The MLPs are flattened and packed once per params object, not per call.
    """
    cache: Dict[str, Any] = {}

    def render_fn(params, config, o_rays, d_rays, generator=None, compute_dtype=None,
                  mlp_apply=None, coarse_sampler=None, uniforms=None):
        key = (id(params), compute_dtype)
        if cache.get("key") != key:
            cache.update(key=key, params=params, prepared={
                k: prepare_fused_mlp(params[k], compute_dtype) for k in ("coarse", "fine")})
        return render_rays_fused(cache["prepared"], config, o_rays, d_rays, generator,
                                 compute_dtype=compute_dtype, coarse_sampler=coarse_sampler,
                                 uniforms=uniforms)

    return render_fn
