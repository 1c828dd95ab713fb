"""Fused ray-march pass: positions -> encoding -> MLP -> compositing, and its
gradient.

Counterpart of ``minimal_nerf_tpu/kernels/fused_raymarch.py``. One call per
render pass takes per-ray origins/directions and sample times and returns
the composited ray colors plus the per-sample weights the hierarchical
sampler needs; its backward turns ``dcolor``/``dweights`` into the MLP's
weight and bias gradients summed over all rays.

- ``fused_forward`` / ``fused_backward`` are the wrappers: for CUDA tensors
  they launch the hand-written kernels in ``csrc/fused_raymarch_fwd.cu``
  (whose bf16 MLP is ``csrc/mlp_fwd_sm90.cuh``) and
  ``csrc/fused_raymarch_bwd.cu`` (whose bf16 kernel A is
  ``csrc/mlp_bwd_sm90.cuh``), adding one to the counters ``FWD_LAUNCHES`` /
  ``BWD_LAUNCHES`` and ``WGRAD_LAUNCHES`` of ``utils.profiling``, and a bf16
  backward to ``BWD_SM90_LAUNCHES``; for CPU tensors they run ``fused_forward_plain`` /
  ``fused_backward_plain``, the same functions in plain PyTorch with the same
  rounding points. Any other device raises; there is no fallback.
- ``_FusedPass`` is the ``torch.autograd.Function`` joining the two: it takes
  the prepared ``FusedMLP`` plus the fp32 parameter tensors it was prepared
  from, and maps the kernel's flat gradients back onto those tensors. ``o``,
  ``d`` and ``ts`` get no gradient (as in ``_fused_core_bwd``).
- ``fused_render_pass`` / ``render_rays_fused`` / ``make_fused_render_fn``
  mirror the JAX entry points and are differentiable in the parameters;
  ``render_rays_fused`` traces its coarse pass, the sorted union between the
  passes and the fine pass (``nerf.render.*`` spans).
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from minimal_nerf_torch.models.mlp import round_to
from minimal_nerf_torch.ops import rendering
from minimal_nerf_torch.ops.encoding import positional_encoding
from minimal_nerf_torch.training.checkpoint import flatten_tree
from minimal_nerf_torch.utils import profiling

Params = Dict[str, Any]

# the launch counters (``profiling.count``; each wrapper adds one per
# launch): the forward kernel, the backward's per-ray kernel, and the
# backward's weight-gradient kernel (followed by its fixed-order reduction);
# of the backward's launches, those of the bf16 kernel A on wgmma
# (``fused_bwd_kernel_sm90``), which fp32 never takes
FWD_LAUNCHES = "fused_raymarch_fwd.launches"
BWD_LAUNCHES = "fused_raymarch_bwd.launches"
WGRAD_LAUNCHES = "fused_raymarch_wgrad.launches"
BWD_SM90_LAUNCHES = "fused_raymarch_bwd_sm90.launches"

KERNEL = "fused_raymarch_fwd"
BWD_KERNEL = "fused_raymarch_bwd"
WIDTH, RGB_WIDTH = 256, 128   # the widths the kernels are compiled for
POS_SLOT, DIR_SLOT = 64, 32   # padded encoding widths in the kernels
MAX_SAMPLES = 1024            # samples per ray the kernels' buffers hold

# The backward's scratch in the compute dtype, SCRATCH_CHANNELS values per
# point: every layer's input (e, ed, a0..a5, h, r0), then every layer's
# output gradient (g_a0..g_a5, g_h, g_r0, and the heads' 8-channel block),
# the channel order of csrc/fused_raymarch_common.cuh, each block of
# channels its own matrix [points, block width]
SCRATCH_CHANNELS = (POS_SLOT + DIR_SLOT + 7 * WIDTH + RGB_WIDTH
                    + 7 * WIDTH + RGB_WIDTH + 8)  # 3944
# the backwards' fp32 bias sums: one float per gradient channel of the
# scratch (g_a0..g_a5, g_h, g_r0, then the heads' block g_sigpre | g_rgbpre
# | 4 zeros)
BIAS_CHANNELS = 7 * WIDTH + RGB_WIDTH + 8  # 1928
# the fused backward's ReLU mask bits per point, as int32 words: a0..a5 and r0
MASK_WORDS = (6 * WIDTH + RGB_WIDTH) // 32  # 52


class FusedMLP(NamedTuple):
    """One MLP prepared for the fused pass (see ``prepare_fused_mlp``)."""

    ws: List[torch.Tensor]
    bs: List[torch.Tensor]
    dtype: Optional[torch.dtype]
    # kernel operands for CUDA, else None: the weights as the backwards and
    # the fp32 forwards read them (``_layout``; the bf16 forwards read only
    # the heads' here), flat biases
    kernel_ws: Optional[List[torch.Tensor]]
    kernel_bs: Optional[List[torch.Tensor]]
    # the transposed weights the backward's reverse sweep multiplies by
    # (T1, T2, T3, F0H, F1, F2, R0H), packed likewise; CUDA only
    kernel_wts: Optional[List[torch.Tensor]] = None
    # the parameter tensors this was prepared from, in ``flatten_tree``
    # order: gradients flow to them through ``_FusedPass``
    leaves: Tuple[torch.Tensor, ...] = ()
    # bf16 on CUDA: the forwards' matrices as ``W^T [N, Kp]`` (``FWD_MATRICES``,
    # ``_pack_kmajor``) and their tensor maps (``FWD_MAPS_BYTES`` of host
    # memory), encoded once here; else None
    kernel_fwd_ws: Optional[List[torch.Tensor]] = None
    kernel_maps: Optional[Any] = None
    # bf16 on CUDA, for a packing a backward will use: the reverse sweep's
    # matrices ``W [K, N]`` (``BWD_MATRICES``) and their tensor maps
    # (``BWD_MAPS_BYTES``), encoded once here; else None (the backward then
    # encodes them at its launch)
    kernel_bwd_ws: Optional[List[torch.Tensor]] = None
    kernel_bwd_maps: Optional[Any] = None


def _pack_mma(w: torch.Tensor, k_pad: int) -> torch.Tensor:
    """``w [K, N]`` bf16 -> mma.sync B fragments ``[N/8, Kp/16, 32, 4]``, the
    layout the backward kernels read.

    Lane ``g*4 + t`` of n-tile ``j`` and k-step ``kk`` holds
    ``W^T[j*8 + g][kk*16 + r*8 + t*2 + e]`` for ``r, e in {0, 1}``.
    """
    k, n = w.shape
    wt = torch.zeros((n, k_pad), dtype=w.dtype, device=w.device)
    wt[:, :k] = w.t()
    return (wt.reshape(n // 8, 8, k_pad // 16, 2, 4, 2)
            .permute(0, 2, 1, 4, 3, 5).contiguous())


def _pack_kmajor(w: torch.Tensor, k_pad: int) -> torch.Tensor:
    """``w [K, N]`` -> ``W^T [N, Kp]``, K zero-padded to ``k_pad``: the
    K-major matrix a tensor map of the bf16 forwards reads, 64 columns of
    k per box (``csrc/mlp_fwd_sm90.cuh``)."""
    k, n = w.shape
    if k == k_pad:
        return w.t().contiguous()
    wt = torch.zeros((n, k_pad), dtype=w.dtype, device=w.device)
    wt[:, :k] = w.t()
    return wt


# the matrices of the bf16 forwards' tensor maps (``flatten_mlp_params``
# slots T0, T1, T2, T3, F0H, F0E, F1, F2, R0H, R0D) and their padded K: the
# encodings' 64 columns of one box (the direction's 24 channels padded to
# 64, not to DIR_SLOT)
FWD_MATRICES = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)
FWD_K_PAD = {0: 64, 5: 64, 10: 64}
FWD_MAPS_BYTES = 10 * 128  # one CUtensorMap per matrix


def _forward_maps(fwd_ws: List[torch.Tensor]):
    """The tensor maps of the forwards' matrices, encoded on the host by
    the fused forward's library (``mlp_fwd_sm90_maps``); raises if the
    encode fails."""
    from minimal_nerf_torch.kernels import build

    fn = build.load(KERNEL).mlp_fwd_sm90_maps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    maps = ctypes.create_string_buffer(FWD_MAPS_BYTES)
    ptrs, _keep = _ptrs(fwd_ws)
    rc = fn(ptrs, ctypes.cast(maps, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"encoding the forwards' tensor maps failed with code {rc}")
    return maps


# the layers the reverse sweep multiplies by (``flatten_mlp_params`` slots
# T1, T2, T3, F0H, F1, F2, R0H): their ``W^T`` in ``_layout`` for the fp32
# and point backwards; for the bf16 fused backward each ``W [K, N]`` as it
# is, which is K-major for the product ``G_out @ W^T`` over N, 64 columns of
# N per box and its 256 rows of K in two (``csrc/mlp_bwd_sm90.cuh``); no
# padding: N is 256 or 128
BWD_MATRICES = (1, 2, 3, 4, 6, 7, 9)
BWD_MAPS_BYTES = 7 * 128  # one CUtensorMap per matrix


def _reverse_operands(ws: List[torch.Tensor]) -> List[torch.Tensor]:
    """The bf16 backward's reverse matrices ``W [K, N]`` in ``BWD_MATRICES``
    order."""
    return [ws[i].contiguous() for i in BWD_MATRICES]


def _reverse_maps(bwd_ws: List[torch.Tensor]):
    """The tensor maps of the reverse's matrices, encoded on the host by the
    backward's library (``fused_raymarch_bwd_maps``); raises if the encode
    fails."""
    from minimal_nerf_torch.kernels import build

    fn = build.function(BWD_KERNEL, "fused_raymarch_bwd_maps", [ctypes.c_void_p, ctypes.c_void_p])
    maps = ctypes.create_string_buffer(BWD_MAPS_BYTES)
    ptrs, _keep = _ptrs(bwd_ws)
    rc = fn(ptrs, ctypes.cast(maps, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"encoding the backward's tensor maps failed with code {rc}")
    return maps


def _pad_rows(w: torch.Tensor, k_pad: int) -> torch.Tensor:
    out = torch.zeros((k_pad, w.shape[1]), dtype=w.dtype, device=w.device)
    out[: w.shape[0]] = w
    return out


def _layout(w: torch.Tensor, k_pad: int, dtype) -> torch.Tensor:
    """One MLP matrix ``[K, N]`` as the kernels read it: bf16 packed in mma
    fragment order, fp32 row-major, K padded to ``k_pad`` either way."""
    if dtype == torch.bfloat16:
        return _pack_mma(w, k_pad)
    return _pad_rows(w, k_pad).contiguous()


def _kernel_operands(ws, bs, dtype):
    """The weights in the layouts the CUDA kernels read.

    Every MLP matrix in ``_layout`` with K padded to the kernel's slot; the
    density weight is a flat ``[256]`` and the rgb output weight ``[3, 128]``,
    both in the compute dtype. Third, the reverse sweep's ``W^T``.
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
        else:
            out.append(_layout(w, k_pad.get(i, w.shape[0]), dtype))
    wts = [_layout(ws[i].t(), ws[i].shape[1], dtype) for i in BWD_MATRICES]
    return out, [b.reshape(-1).contiguous() for b in bs], wts


def prepare_fused_mlp(params: Params, compute_dtype=None) -> FusedMLP:
    """Flatten (and, on a CUDA device, pack) one MLP for the fused pass.

    The prepared operands are detached copies; ``leaves`` keeps the
    parameter tensors themselves so ``_FusedPass`` can give them gradients.
    """
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} not supported")
    # imported here: raymarch imports this module at its top
    from minimal_nerf_torch.kernels.raymarch import flatten_mlp_params

    dtype = None if compute_dtype == torch.float32 else compute_dtype
    leaves = tuple(flatten_tree(params))
    # a packing that a backward will use: the pass is differentiated
    # (``fused_render_pass``'s test); serving packs none of it
    backward = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
    with torch.no_grad():
        ws, bs = flatten_mlp_params(params, dtype)
        return _prepared(ws, bs, dtype, leaves, backward)


def _forward_operands(ws: List[torch.Tensor]) -> List[torch.Tensor]:
    """The bf16 forwards' matrices ``W^T [N, Kp]`` in ``FWD_MATRICES`` order."""
    return [_pack_kmajor(ws[i], FWD_K_PAD.get(i, WIDTH)) for i in FWD_MATRICES]


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _prepared(ws, bs, dtype, leaves=(), backward: bool = False) -> FusedMLP:
    """The flat weights and biases with the kernels' operands for their
    device (CUDA only), the bf16 forwards' tensor maps encoded once here,
    and with ``backward`` the bf16 backward's reverse matrices and maps."""
    kws = kbs = kwts = fwd_ws = maps = bwd_ws = bwd_maps = None
    if _on_card(ws[0]):
        kws, kbs, kwts = _kernel_operands(ws, bs, dtype)
        if dtype == torch.bfloat16:
            fwd_ws = _forward_operands(ws)
            maps = _forward_maps(fwd_ws)
            if backward:
                bwd_ws = _reverse_operands(ws)
                bwd_maps = _reverse_maps(bwd_ws)
    return FusedMLP(ws, bs, dtype, kws, kbs, kwts, leaves, fwd_ws, maps, bwd_ws, bwd_maps)


def _encode(x: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """The in-kernel encoding: ``x`` rounded to ``dtype`` first, the result
    rounded to ``dtype`` too (returned as fp32 values)."""
    return round_to(positional_encoding(round_to(x, dtype), dim), dtype)


def _forward_core(fm: FusedMLP, o, d, ts, position_dim: int, direction_dim: int):
    """The forward chain with its intermediates (``_fused_forward_core``)."""
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
    sg = torch.relu(h @ dw + db)  # [N, S, 1]
    r0 = act(h @ r0wh + ed @ r0wd + r0b)
    rgb = torch.sigmoid(r0 @ r1w + r1b)  # [N, S, 3]

    deltas = torch.cat([ts[:, 1:] - ts[:, :-1],
                        torch.full((n, 1), 1e10, dtype=ts.dtype, device=ts.device)], dim=1)
    ndd = -sg[..., 0] * deltas
    excl = torch.cat([torch.zeros_like(ndd[:, :1]), torch.cumsum(ndd[:, :-1], dim=1)], dim=1)
    transmittance, ealpha = torch.exp(excl), torch.exp(ndd)
    weights = (1.0 - ealpha) * transmittance
    color = torch.sum(weights[..., None] * rgb, dim=1)
    return dict(e=e, ed=ed, a0=a0, a1=a1, a2=a2, a3=a3, a4=a4, a5=a5, h=h, sg=sg, r0=r0,
                rgb=rgb, deltas=deltas, transmittance=transmittance, ealpha=ealpha,
                weights=weights, color=color)


def fused_forward_plain(fm: FusedMLP, o, d, ts, position_dim: int = 10,
                        direction_dim: int = 4):
    """Plain PyTorch version of the kernel: ``color [N, 3]``, ``weights [N, S]``.

    Same rounding points as the kernel and ``_fused_forward_core``; only the
    order of fp32 sums differs (matmuls, ``torch.cumsum`` for the scan).
    """
    f = _forward_core(fm, o, d, ts, position_dim, direction_dim)
    return f["color"], f["weights"]


def _suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """``out[:, i] = sum_{j > i} x[:, j]`` (strict, without cancellation)."""
    rev = torch.cumsum(torch.flip(x, [1]), dim=1)
    return torch.flip(torch.cat([torch.zeros_like(rev[:, :1]), rev[:, :-1]], dim=1), [1])


def _grad_act(v: torch.Tensor, mask: torch.Tensor, dtype) -> torch.Tensor:
    """A ReLU layer's input gradient, stored in the compute dtype (``gact``)."""
    return round_to(v * mask, dtype)


def fused_backward_plain(fm: FusedMLP, o, d, ts, dcolor, dweights=None,
                         position_dim: int = 10, direction_dim: int = 4):
    """Plain PyTorch version of the backward kernel (``_fused_bwd_kernel``).

    Returns the 12 weight gradients ``[in, out]`` and 10 bias gradients
    ``[1, out]`` (fp32, summed over all rays) in ``flatten_mlp_params``
    order. ``dweights=None`` means zeros. Rounding points as in JAX: the
    gradient activations, ``g_rgbpre`` and ``g_sigpre`` are rounded to the
    compute dtype, ReLU masks compare the stored activations in fp32, and
    the weight-gradient products take compute-dtype operands with fp32 sums.
    """
    dtype = fm.dtype
    (_, t1w, t2w, t3w, f0wh, _, f1w, f2w, dw, r0wh, _, r1w) = [
        round_to(w, dtype) for w in fm.ws]
    f = _forward_core(fm, o, d, ts, position_dim, direction_dim)
    weights, rgb = f["weights"], f["rgb"]

    # compositing backward
    g_rgb = weights[..., None] * dcolor[:, None, :]
    g_w = torch.sum(dcolor[:, None, :] * rgb, dim=-1)
    if dweights is not None:
        g_w = g_w + dweights
    wg = weights * g_w
    g_sigma = f["deltas"] * (f["transmittance"] * f["ealpha"] * g_w - _suffix_sum(wg))

    # MLP backward
    pos = lambda v: (v > 0).float()  # noqa: E731
    gact = lambda v, mask: _grad_act(v, mask, dtype)  # noqa: E731

    def a_tb(a, b):
        return (round_to(a, dtype).reshape(-1, a.shape[-1]).t()
                @ round_to(b, dtype).reshape(-1, b.shape[-1]))

    def bsum(g):
        return torch.sum(g.float(), dim=(0, 1))[None, :]

    g_rgbpre = round_to(g_rgb * rgb * (1.0 - rgb), dtype)
    g_r0 = gact(g_rgbpre @ r1w.t(), pos(f["r0"]))
    g_sigpre = round_to(g_sigma[..., None] * (f["sg"] > 0), dtype)
    g_h = round_to(g_r0 @ r0wh.t() + g_sigpre @ dw.t(), dtype)
    g_a5 = gact(g_h @ f2w.t(), pos(f["a5"]))
    g_a4 = gact(g_a5 @ f1w.t(), pos(f["a4"]))
    g_a3 = gact(g_a4 @ f0wh.t(), pos(f["a3"]))
    g_a2 = gact(g_a3 @ t3w.t(), pos(f["a2"]))
    g_a1 = gact(g_a2 @ t2w.t(), pos(f["a1"]))
    g_a0 = gact(g_a1 @ t1w.t(), pos(f["a0"]))

    gws = [a_tb(f["e"], g_a0), a_tb(f["a0"], g_a1), a_tb(f["a1"], g_a2), a_tb(f["a2"], g_a3),
           a_tb(f["a3"], g_a4), a_tb(f["e"], g_a4), a_tb(f["a4"], g_a5), a_tb(f["a5"], g_h),
           a_tb(f["h"], g_sigpre), a_tb(f["h"], g_r0), a_tb(f["ed"], g_r0),
           a_tb(f["r0"], g_rgbpre)]
    gbs = [bsum(g) for g in (g_a0, g_a1, g_a2, g_a3, g_a4, g_a5, g_h, g_sigpre, g_r0,
                             g_rgbpre)]
    return gws, gbs


def _check(name, t: torch.Tensor, shape, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _check_launch(fm: FusedMLP, tensors, position_dim, direction_dim):
    """Device, dtype, shape and contiguity checks shared by the kernels (the
    fused ones here and the point kernels of ``raymarch``)."""
    dev = tensors[0][1].device
    for name, t, shape in tensors:
        _check(name, t, shape)
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
    if fm.kernel_ws is None or any(w.device != dev for w in fm.kernel_ws + fm.kernel_bs):
        raise ValueError(f"weights are not prepared on {dev}")
    wdtype = fm.dtype or torch.float32
    if any(w.dtype != wdtype or not w.is_contiguous() for w in fm.kernel_ws):
        raise ValueError(f"kernel weights must be contiguous {wdtype}")
    if not (1 <= 6 * position_dim <= POS_SLOT and 1 <= 6 * direction_dim <= DIR_SLOT):
        raise ValueError(f"encoding dims {position_dim}/{direction_dim} exceed the "
                         f"kernel's {POS_SLOT}/{DIR_SLOT} channel slots")
    return dev


def _maps_arg(fm: FusedMLP, dev):
    """The forwards' tensor maps as a launch argument: bf16 needs them,
    prepared on ``dev``; fp32 passes none."""
    if fm.dtype != torch.bfloat16:
        return None
    if fm.kernel_maps is None or any(w.device != dev for w in fm.kernel_fwd_ws):
        raise ValueError(f"the forwards' tensor maps are not prepared on {dev}")
    return ctypes.cast(fm.kernel_maps, ctypes.c_void_p)


def _check_samples(s: int):
    if not 1 <= s <= MAX_SAMPLES:
        raise ValueError(f"the fused kernel takes 1..{MAX_SAMPLES} samples per ray, got {s}")


def _ptrs(ts_list):
    """``(pointer to an array of the tensors' data pointers, the array)``;
    the caller keeps the array alive until the launch returns."""
    arr = (ctypes.c_void_p * len(ts_list))(*[t.data_ptr() for t in ts_list])
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _launch(fm: FusedMLP, o, d, ts, position_dim, direction_dim):
    from minimal_nerf_torch.kernels import build

    n, s = ts.shape
    dev = _check_launch(fm, [("o", o, (n, 3)), ("d", d, (n, 3)), ("ts", ts, (n, s))],
                        position_dim, direction_dim)
    _check_samples(s)
    color = torch.empty((n, 3), dtype=torch.float32, device=dev)
    weights = torch.empty((n, s), dtype=torch.float32, device=dev)
    if n == 0:
        return color, weights

    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function(KERNEL, "fused_raymarch_fwd", [p, p, p, i, i, i, i, i, p, p, p, p, p, p])
    (w_ptrs, _keep_w), (b_ptrs, _keep_b) = _ptrs(fm.kernel_ws), _ptrs(fm.kernel_bs)
    with build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(o.data_ptr(), d.data_ptr(), ts.data_ptr(), n, s, position_dim,
                direction_dim, int(fm.dtype == torch.bfloat16), w_ptrs, b_ptrs,
                _maps_arg(fm, dev), color.data_ptr(), weights.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed with code {rc}")
    profiling.count(FWD_LAUNCHES)
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


def _bwd_sizes(n: int, s: int) -> Tuple[int, ...]:
    """``(points, slices, weight-gradient floats, bias-sum rows, bias
    floats, mask words per point, scratch channels)`` of one backward: the
    kernel's own choice of rays per CTA and point slices."""
    from minimal_nerf_torch.kernels import build

    fn = build.function(BWD_KERNEL, "fused_raymarch_bwd_sizes",
                        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)])
    out = (ctypes.c_longlong * 7)()
    rc = fn(n, s, out)
    if rc != 0:
        raise ValueError(f"{BWD_KERNEL} does not take n={n}, s={s} (code {rc})")
    return tuple(int(v) for v in out)


def _launch_bwd(fm: FusedMLP, o, d, ts, dcolor, dweights, position_dim, direction_dim):
    from minimal_nerf_torch.kernels import build

    n, s = ts.shape
    tensors = [("o", o, (n, 3)), ("d", d, (n, 3)), ("ts", ts, (n, s)),
               ("dcolor", dcolor, (n, 3))]
    if dweights is not None:
        tensors.append(("dweights", dweights, (n, s)))
    dev = _check_launch(fm, tensors, position_dim, direction_dim)
    _check_samples(s)
    if fm.kernel_wts is None or any(w.device != dev for w in fm.kernel_wts):
        raise ValueError(f"transposed weights are not prepared on {dev}")
    if n == 0:
        return _split_grads(torch.zeros((GRAD_FLOATS,), dtype=torch.float32, device=dev), fm)
    points, slices, total, bias_rows, bias, words, channels = _bwd_sizes(n, s)
    if (total + bias, words, channels) != (GRAD_FLOATS, MASK_WORDS, SCRATCH_CHANNELS):
        raise RuntimeError(f"{BWD_KERNEL} writes {total} + {bias} gradient floats, {words} "
                           f"mask words and {channels} scratch channels, expected the blocks "
                           f"of GRAD_BLOCKS ({GRAD_FLOATS}), {MASK_WORDS} and "
                           f"{SCRATCH_CHANNELS}")
    grads = torch.empty((GRAD_FLOATS,), dtype=torch.float32, device=dev)
    scratch = torch.empty((points, SCRATCH_CHANNELS), dtype=fm.dtype or torch.float32,
                          device=dev)
    masks = torch.empty((points, MASK_WORDS), dtype=torch.int32, device=dev)
    partial = torch.empty((slices, total), dtype=torch.float32, device=dev)
    bias_partial = torch.empty((bias_rows, BIAS_CHANNELS), dtype=torch.float32, device=dev)

    bf16 = fm.dtype == torch.bfloat16
    maps = _maps_arg(fm, dev)
    bwd_ws, bwd_maps = fm.kernel_bwd_ws, fm.kernel_bwd_maps
    if bf16 and bwd_maps is None:  # a packing made for no backward
        bwd_ws = _reverse_operands(fm.ws)
        bwd_maps = _reverse_maps(bwd_ws)
    if bf16 and any(w.device != dev for w in bwd_ws):
        raise ValueError(f"the backward's tensor maps are not prepared on {dev}")

    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function(BWD_KERNEL, "fused_raymarch_bwd",
                        [p, p, p, p, p, i, i, i, i, i, p, p, p, p, p, p, p, p, p, p, p])
    (w_ptrs, _kw), (b_ptrs, _kb), (wt_ptrs, _kt) = (
        _ptrs(fm.kernel_ws), _ptrs(fm.kernel_bs), _ptrs(fm.kernel_wts))
    with build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(o.data_ptr(), d.data_ptr(), ts.data_ptr(), dcolor.data_ptr(),
                dweights.data_ptr() if dweights is not None else None, n, s, position_dim,
                direction_dim, int(bf16), w_ptrs, b_ptrs, wt_ptrs, maps,
                ctypes.cast(bwd_maps, ctypes.c_void_p) if bf16 else None,
                scratch.data_ptr(), masks.data_ptr(), partial.data_ptr(),
                bias_partial.data_ptr(), grads.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed with code {rc}")
    profiling.count(BWD_LAUNCHES)
    profiling.count(WGRAD_LAUNCHES)
    if bf16:
        profiling.count(BWD_SM90_LAUNCHES)
    return _split_grads(grads, fm)


# ``(rows, cols)`` of each block both backward kernels write, in their
# order: the 12 weight products (encodings padded to their slots, the two
# heads sharing one 8-column gradient block), then one row of the
# BIAS_CHANNELS bias sums in scratch channel order
GRAD_BLOCKS = ([(POS_SLOT, WIDTH)] + [(WIDTH, WIDTH)] * 4 + [(POS_SLOT, WIDTH)]
               + [(WIDTH, WIDTH)] * 2 + [(WIDTH, 8), (WIDTH, RGB_WIDTH),
                                         (DIR_SLOT, RGB_WIDTH), (RGB_WIDTH, 8)]
               + [(1, BIAS_CHANNELS)])
GRAD_FLOATS = sum(r * c for r, c in GRAD_BLOCKS)


def _split_grads(flat: torch.Tensor, fm: FusedMLP):
    """A backward kernel's flat fp32 output (``GRAD_BLOCKS``) as 12 weight
    and 10 bias gradients."""
    gws, off = [], 0
    for rows, cols in GRAD_BLOCKS[:12]:
        gws.append(flat[off: off + rows * cols].view(rows, cols))
        off += rows * cols
    pe, de = fm.ws[0].shape[0], fm.ws[10].shape[0]
    gws[0], gws[5], gws[10] = gws[0][:pe], gws[5][:pe], gws[10][:de]
    gws[8], gws[11] = gws[8][:, :1], gws[11][:, 1:4]
    b = flat[off: off + BIAS_CHANNELS].view(1, -1)
    head = b[:, 7 * WIDTH + RGB_WIDTH:]
    gbs = [b[:, i * WIDTH:(i + 1) * WIDTH] for i in range(7)] + [
        head[:, :1], b[:, 7 * WIDTH: 7 * WIDTH + RGB_WIDTH], head[:, 1:4]]
    return gws, gbs


def fused_backward(fm: FusedMLP, o, d, ts, dcolor, dweights=None, position_dim: int = 10,
                   direction_dim: int = 4):
    """The 12 weight and 10 bias gradients (fp32) of one fused pass.

    CUDA tensors go through the backward kernel, CPU tensors through
    ``fused_backward_plain``; any other device raises. ``dweights=None``
    means zeros.
    """
    if o.device.type == "cuda":
        return _launch_bwd(fm, o, d, ts, dcolor, dweights, position_dim, direction_dim)
    if o.device.type == "cpu":
        return fused_backward_plain(fm, o, d, ts, dcolor, dweights, position_dim,
                                    direction_dim)
    raise ValueError(f"no fused ray-march implementation for device {o.device}")


class _FusedPass(torch.autograd.Function):
    """``fused_forward`` with ``fused_backward`` as its gradient.

    Inputs: the prepared ``FusedMLP``, ``o, d, ts``, the encoding dims, then
    ``fm.leaves`` (the fp32 parameters ``fm`` was packed from). The backward
    maps the flat gradients back onto those leaves; ``o, d, ts`` get none.
    """

    @staticmethod
    def forward(ctx, fm, o, d, ts, position_dim, direction_dim, *leaves):
        ctx.fm, ctx.dims = fm, (position_dim, direction_dim)
        ctx.save_for_backward(o, d, ts)
        ctx.set_materialize_grads(False)
        return fused_forward(fm, o, d, ts, position_dim, direction_dim)

    @staticmethod
    def backward(ctx, dcolor, dweights):
        from minimal_nerf_torch.kernels.raymarch import unflatten_mlp_grads

        o, d, ts = ctx.saved_tensors
        fm = ctx.fm
        if dcolor is None:
            dcolor = torch.zeros((ts.shape[0], 3), dtype=torch.float32, device=ts.device)
        gws, gbs = fused_backward(fm, o, d, ts, dcolor.float().contiguous(),
                                  None if dweights is None else dweights.float().contiguous(),
                                  *ctx.dims)
        grads = flatten_tree(unflatten_mlp_grads(gws, gbs))
        return (None,) * 6 + tuple(grads)


def fused_render_pass(params, o_rays, d_rays, ts, position_dim: int = 10,
                      direction_dim: int = 4, compute_dtype=None):
    """One fused pass for sample times ``ts [N, S, 1]`` or ``[N, S]``.

    ``params`` is one MLP tree or a ``FusedMLP``. Returns ``color [N, 3]``
    and ``weights [N, S, 1]``, differentiable in the parameters when they
    require gradients.
    """
    fm = params if isinstance(params, FusedMLP) else prepare_fused_mlp(params, compute_dtype)
    ts2 = ts[..., 0] if ts.dim() == 3 else ts
    args = (fm, o_rays.float().contiguous(), d_rays.float().contiguous(),
            ts2.float().contiguous(), position_dim, direction_dim)
    if torch.is_grad_enabled() and any(t.requires_grad for t in fm.leaves):
        color, weights = _FusedPass.apply(*args, *fm.leaves)
    else:
        color, weights = fused_forward(*args)
    return color, weights[..., None]


def render_rays_fused(params: Params, config, o_rays, d_rays,
                      generator: Optional[torch.Generator] = None,
                      compute_dtype=None, mlp_apply=None, coarse_sampler=None,
                      uniforms: Optional[Dict[str, torch.Tensor]] = None,
                      return_stats: bool = False):
    """Hierarchical render with both passes through the fused pass.

    Same draws and math as ``models.nerf.render_rays``; sampling and the
    sorted union run in PyTorch between the two passes (the spans
    ``nerf.render.coarse_pass``, with the coarse samples, ``union`` and
    ``fine_pass``), and the fine pass's
    times carry no gradient (``sg(all_ts)`` in JAX). ``params`` holds
    ``"coarse"`` and ``"fine"`` MLP trees or ``FusedMLP``s. ``mlp_apply`` and
    ``return_stats`` are accepted for interface parity and ignored: the
    fused pass never materializes the densities (as in JAX).
    """
    from minimal_nerf_torch.models.nerf import fine_times

    sample_coarse = coarse_sampler or rendering.generate_coarse_samples
    uniforms = uniforms or {}
    pass_ = lambda mlp, ts: fused_render_pass(  # noqa: E731
        mlp, o_rays, d_rays, ts, config.position_dim, config.direction_dim,
        compute_dtype=compute_dtype)
    with profiling.span("nerf.render.coarse_pass"):
        _, coarse_ts = sample_coarse(o_rays, d_rays, config.coarse_samples, config.near,
                                     config.far, generator=generator,
                                     uniforms=uniforms.get("coarse"))
        coarse_color, coarse_weights = pass_(params["coarse"], coarse_ts)
    with profiling.span("nerf.render.union"):
        all_ts = fine_times(config, o_rays, d_rays, coarse_weights, coarse_ts,
                            generator, uniforms)
    with profiling.span("nerf.render.fine_pass"):
        fine_color, _ = pass_(params["fine"], all_ts.detach())
    return {"fine_rgb_rays": fine_color, "coarse_rgb_rays": coarse_color}


def capturing(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA device whose current stream is capturing
    a CUDA graph (the train step's, ``training.loop.make_multi_step``)."""
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class PackingCache:
    """``cache(params, compute_dtype, t)``: ``pack(params, compute_dtype)``
    kept for the newest ``capacity`` trees (by object) under the compute
    dtype and every leaf's ``_version``, which an in-place update advances.

    While the stream of ``t`` captures a graph of trained parameters (a leaf
    requires gradients: the train step's, whose replays update them in
    place) it packs inside the graph and keeps nothing, so each replay packs
    the weights as they stand; a graph of frozen ones (the view sweep's)
    reads the packing cached before its capture."""

    def __init__(self, pack, capacity: int = 1):
        self.pack, self.capacity = pack, capacity
        self.entries: Dict[int, Tuple[Any, Any, Any]] = {}  # id -> (key, params, packed)

    def __call__(self, params, compute_dtype, t: torch.Tensor):
        leaves = flatten_tree(params)
        key = (compute_dtype, tuple((id(leaf), leaf._version) for leaf in leaves))
        hit = self.entries.get(id(params))
        if capturing(t) and (hit is None or hit[0] != key
                             or any(leaf.requires_grad for leaf in leaves)):
            return self.pack(params, compute_dtype)
        self.entries.pop(id(params), None)  # re-inserted: the dict keeps the newest last
        if hit is None or hit[0] != key:
            hit = (key, params, self.pack(params, compute_dtype))
        self.entries[id(params)] = hit
        while len(self.entries) > self.capacity:
            self.entries.pop(next(iter(self.entries)))
        return hit[2]


def make_fused_render_fn():
    """A ``render_fn`` hook (``models.nerf.render_rays``' signature) packing
    its coarse and fine MLPs in a ``PackingCache`` of one tree."""
    cache = PackingCache(lambda params, dtype: {k: prepare_fused_mlp(params[k], dtype)
                                                for k in ("coarse", "fine")})

    def render_fn(params, config, o_rays, d_rays, generator=None, compute_dtype=None,
                  mlp_apply=None, coarse_sampler=None, uniforms=None, return_stats=False):
        return render_rays_fused(cache(params, compute_dtype, o_rays), config, o_rays, d_rays,
                                 generator, compute_dtype=compute_dtype,
                                 coarse_sampler=coarse_sampler, uniforms=uniforms)

    return render_fn
