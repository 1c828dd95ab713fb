"""Point-level MLP pass: encoding -> trunk -> heads per sample point, and its
gradient (the ``--kernel pallas`` path).

Counterpart of ``minimal_nerf_tpu/kernels/raymarch.py``. One call takes the
flattened points of a render pass, positions already divided by pi and unit
directions, and returns each point's density and color; the render around it
(sampling, compositing) stays in ``models.nerf.render_rays``. Its backward
turns ``dsigma``/``drgb`` into the MLP's weight and bias gradients summed
over all points.

- ``flatten_mlp_params`` / ``unflatten_mlp_grads`` split one MLP into the
  kernels' 12 weights and 10 biases and map their gradients back; both
  kernel families (this one and ``fused_raymarch``) use them, and both read
  the weights packed by ``fused_raymarch.prepare_fused_mlp``.
- ``points_forward`` / ``points_backward`` are the wrappers: for CUDA tensors
  they launch the hand-written kernels in ``csrc/raymarch_mlp_fwd.cu`` and
  ``csrc/raymarch_mlp_bwd.cu`` (adding one to the counters
  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` of ``utils.profiling``); for CPU
  tensors they run ``points_forward_plain`` /
  ``points_backward_plain``, the same functions in plain PyTorch with the
  TPU kernels' rounding points. Any other device raises; there is no
  fallback.
- ``_PointsMLP`` is the ``torch.autograd.Function`` joining the two;
  ``nerf_mlp_kernel_apply`` / ``make_mlp_kernel_apply`` are the drop-in
  ``mlp_apply`` hook for ``models.nerf.render_rays``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Tuple

import torch

from minimal_nerf_torch.kernels import fused_raymarch as fr
from minimal_nerf_torch.models.mlp import round_to
from minimal_nerf_torch.ops.encoding import normalize_coordinates
from minimal_nerf_torch.training.checkpoint import flatten_tree
from minimal_nerf_torch.utils import profiling

Params = Dict[str, Any]

# the launch counters (``profiling.count``): the forward kernel, and the
# backward (its per-point kernel, weight-gradient kernel and two fixed-order
# reductions count as one launch)
FWD_LAUNCHES = "raymarch_mlp_fwd.launches"
BWD_LAUNCHES = "raymarch_mlp_bwd.launches"

KERNEL = "raymarch_mlp_fwd"
BWD_KERNEL = "raymarch_mlp_bwd"
# the MLPs an mlp_apply hook keeps packed: a render's coarse and fine, and
# room for a second network
_CACHED_MLPS = 4


def flatten_mlp_params(params: Params, compute_dtype=None
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Split one MLP into the kernels' 12 weights and 10 biases.

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


def unflatten_mlp_grads(gws: List[torch.Tensor], gbs: List[torch.Tensor]) -> Params:
    """Inverse of ``flatten_mlp_params`` for the 12 + 10 fp32 gradients
    (``minimal_nerf_tpu/kernels/raymarch.py:398-421``): the split halves of
    ``feature[0]`` and ``rgb[0]`` are concatenated back."""
    lin = lambda w, b: {"w": w, "b": b.reshape(-1)}  # noqa: E731
    return {
        "trunk": [lin(gws[i], gbs[i]) for i in range(4)],
        "feature": [lin(torch.cat([gws[4], gws[5]], dim=0), gbs[4]),
                    lin(gws[6], gbs[5]), lin(gws[7], gbs[6])],
        "density": lin(gws[8], gbs[7]),
        "rgb": [lin(torch.cat([gws[9], gws[10]], dim=0), gbs[8]), lin(gws[11], gbs[9])],
    }


def _forward_core(fm: fr.FusedMLP, x_pts, d_pts, position_dim: int, direction_dim: int):
    """The forward chain of ``_nerf_mlp_kernel`` with its fp32 intermediates.

    x and d are rounded to the compute dtype before their encodings; every
    other matmul operand is rounded where the TPU kernel's ``_mm`` casts it.
    The activations stay fp32 (their ReLU masks are taken from them).
    """
    dtype = fm.dtype
    (t0w, t1w, t2w, t3w, f0wh, f0we, f1w, f2w, dw, r0wh, r0wd, r1w) = [
        round_to(w, dtype) for w in fm.ws]
    (t0b, t1b, t2b, t3b, f0b, f1b, f2b, db, r0b, r1b) = fm.bs
    r = lambda v: round_to(v, dtype)  # noqa: E731
    e = fr._encode(x_pts, position_dim, dtype)  # [P, 6*pd]
    ed = fr._encode(d_pts, direction_dim, dtype)
    a0 = torch.relu(e @ t0w + t0b)
    a1 = torch.relu(r(a0) @ t1w + t1b)
    a2 = torch.relu(r(a1) @ t2w + t2b)
    a3 = torch.relu(r(a2) @ t3w + t3b)
    # skip: concat(a3, e) @ W == a3 @ W_h + e @ W_e
    a4 = torch.relu(r(a3) @ f0wh + e @ f0we + f0b)
    a5 = torch.relu(r(a4) @ f1w + f1b)
    h = r(a5) @ f2w + f2b  # no activation
    sg = torch.relu(r(h) @ dw + db)  # [P, 1]
    r0 = torch.relu(r(h) @ r0wh + ed @ r0wd + r0b)
    rgb = torch.sigmoid(r(r0) @ r1w + r1b)  # [P, 3]
    return dict(e=e, ed=ed, a0=a0, a1=a1, a2=a2, a3=a3, a4=a4, a5=a5, h=h, sg=sg, r0=r0,
                rgb=rgb)


def points_forward_plain(fm: fr.FusedMLP, x_pts, d_pts, position_dim: int = 10,
                         direction_dim: int = 4):
    """Plain PyTorch version of the forward kernel: ``sigma [P, 1]``,
    ``rgb [P, 3]`` (fp32) for ``x_pts`` (positions / pi) and unit ``d_pts``
    ``[P, 3]``. Same rounding points as ``_nerf_mlp_kernel``; only the
    order of fp32 sums differs."""
    f = _forward_core(fm, x_pts, d_pts, position_dim, direction_dim)
    return f["sg"], f["rgb"]


def _bias_sum(g: torch.Tensor) -> torch.Tensor:
    """A bias gradient: the fp32 column sum of the UNROUNDED gradient
    (``jnp.sum(g_a0, 0)`` in ``_nerf_mlp_bwd_kernel``)."""
    return torch.sum(g, dim=0, keepdim=True)


def points_backward_plain(fm: fr.FusedMLP, x_pts, d_pts, dsig, drgb, position_dim: int = 10,
                          direction_dim: int = 4):
    """Plain PyTorch version of the backward kernel (``_nerf_mlp_bwd_kernel``).

    Returns the 12 weight gradients ``[in, out]`` and 10 bias gradients
    ``[1, out]`` (fp32, summed over the points) in ``flatten_mlp_params``
    order. Rounding points of the TPU kernel, not the fused backward's: the
    gradient activations stay fp32 and are rounded to the compute dtype only
    as operands of the products; ReLU masks compare the fp32 activations;
    the bias gradients sum the unrounded fp32 gradients.
    """
    dtype = fm.dtype
    (_, t1w, t2w, t3w, f0wh, _, f1w, f2w, dw, r0wh, _, r1w) = [
        round_to(w, dtype) for w in fm.ws]
    f = _forward_core(fm, x_pts, d_pts, position_dim, direction_dim)
    r = lambda v: round_to(v, dtype)  # noqa: E731
    pos = lambda v: (v > 0).float()  # noqa: E731

    def a_tb(a, b):  # _aTb: both operands rounded, fp32 sums
        return r(a).t() @ r(b)

    rgb = f["rgb"]
    g_rgbpre = drgb * rgb * (1.0 - rgb)
    g_r0 = (r(g_rgbpre) @ r1w.t()) * pos(f["r0"])
    g_sigpre = dsig * pos(f["sg"])
    g_h = r(g_r0) @ r0wh.t() + r(g_sigpre) @ dw.t()
    g_a5 = (r(g_h) @ f2w.t()) * pos(f["a5"])
    g_a4 = (r(g_a5) @ f1w.t()) * pos(f["a4"])
    g_a3 = (r(g_a4) @ f0wh.t()) * pos(f["a3"])
    g_a2 = (r(g_a3) @ t3w.t()) * pos(f["a2"])
    g_a1 = (r(g_a2) @ t2w.t()) * pos(f["a1"])
    g_a0 = (r(g_a1) @ t1w.t()) * pos(f["a0"])

    gws = [a_tb(f["e"], g_a0), a_tb(f["a0"], g_a1), a_tb(f["a1"], g_a2), a_tb(f["a2"], g_a3),
           a_tb(f["a3"], g_a4), a_tb(f["e"], g_a4), a_tb(f["a4"], g_a5), a_tb(f["a5"], g_h),
           a_tb(f["h"], g_sigpre), a_tb(f["h"], g_r0), a_tb(f["ed"], g_r0),
           a_tb(f["r0"], g_rgbpre)]
    gbs = [_bias_sum(g) for g in (g_a0, g_a1, g_a2, g_a3, g_a4, g_a5, g_h, g_sigpre, g_r0,
                                  g_rgbpre)]
    return gws, gbs


def _launch(fm: fr.FusedMLP, x_pts, d_pts, position_dim, direction_dim):
    from minimal_nerf_torch.kernels import build

    p = x_pts.shape[0]
    dev = fr._check_launch(fm, [("x_pts", x_pts, (p, 3)), ("d_pts", d_pts, (p, 3))],
                           position_dim, direction_dim)
    sigma = torch.empty((p, 1), dtype=torch.float32, device=dev)
    rgb = torch.empty((p, 3), dtype=torch.float32, device=dev)
    if p == 0:
        return sigma, rgb
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function(KERNEL, "raymarch_mlp_fwd",
                        [ptr, ptr, i, i, i, i, ptr, ptr, ptr, ptr, ptr, ptr])
    (w_ptrs, _keep_w), (b_ptrs, _keep_b) = fr._ptrs(fm.kernel_ws), fr._ptrs(fm.kernel_bs)
    with build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x_pts.data_ptr(), d_pts.data_ptr(), p, position_dim, direction_dim,
                int(fm.dtype == torch.bfloat16), w_ptrs, b_ptrs, fr._maps_arg(fm, dev),
                sigma.data_ptr(), rgb.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed with code {rc}")
    profiling.count(FWD_LAUNCHES)
    return sigma, rgb


def points_forward(fm: fr.FusedMLP, x_pts, d_pts, position_dim: int = 10,
                   direction_dim: int = 4):
    """``sigma [P, 1]``, ``rgb [P, 3]`` for ``x_pts``, ``d_pts [P, 3]``.

    CUDA tensors go through the kernel, CPU tensors through the plain
    version; any other device raises.
    """
    if x_pts.device.type == "cuda":
        return _launch(fm, x_pts, d_pts, position_dim, direction_dim)
    if x_pts.device.type == "cpu":
        return points_forward_plain(fm, x_pts, d_pts, position_dim, direction_dim)
    raise ValueError(f"no point-level MLP implementation for device {x_pts.device}")


def _bwd_sizes(p: int, is_bf16: bool) -> Tuple[int, ...]:
    """``(scratch points, slices, weight-gradient floats, CTAs, bias
    floats, scratch channels)`` of one backward: the kernel's own tiling of
    the points."""
    from minimal_nerf_torch.kernels import build

    fn = build.function(BWD_KERNEL, "raymarch_mlp_bwd_sizes",
                        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)])
    out = (ctypes.c_longlong * 6)()
    rc = fn(p, int(is_bf16), out)
    if rc != 0:
        raise ValueError(f"{BWD_KERNEL} does not take p={p} (code {rc})")
    return tuple(int(v) for v in out)


def _launch_bwd(fm: fr.FusedMLP, x_pts, d_pts, dsig, drgb, position_dim, direction_dim):
    from minimal_nerf_torch.kernels import build

    p = x_pts.shape[0]
    dev = fr._check_launch(fm, [("x_pts", x_pts, (p, 3)), ("d_pts", d_pts, (p, 3)),
                                ("dsig", dsig, (p, 1)), ("drgb", drgb, (p, 3))],
                           position_dim, direction_dim)
    if fm.kernel_wts is None or any(w.device != dev for w in fm.kernel_wts):
        raise ValueError(f"transposed weights are not prepared on {dev}")
    if p == 0:
        return fr._split_grads(torch.zeros((fr.GRAD_FLOATS,), dtype=torch.float32,
                                           device=dev), fm)
    is_bf16 = fm.dtype == torch.bfloat16
    points, slices, total, ctas, bias, channels = _bwd_sizes(p, is_bf16)
    if (total + bias, channels) != (fr.GRAD_FLOATS, fr.SCRATCH_CHANNELS):
        raise RuntimeError(f"{BWD_KERNEL} writes {total} + {bias} gradient floats through "
                           f"{channels} scratch channels, expected the blocks of GRAD_BLOCKS "
                           f"({fr.GRAD_FLOATS}) and {fr.SCRATCH_CHANNELS}")
    grads = torch.empty((fr.GRAD_FLOATS,), dtype=torch.float32, device=dev)
    scratch = torch.empty((points, fr.SCRATCH_CHANNELS), dtype=fm.dtype or torch.float32,
                          device=dev)
    partial = torch.empty((slices, total), dtype=torch.float32, device=dev)
    bias_partial = torch.empty((ctas, fr.BIAS_CHANNELS), dtype=torch.float32, device=dev)

    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function(BWD_KERNEL, "raymarch_mlp_bwd",
                        [ptr, ptr, ptr, ptr, i, i, i, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr])
    (w_ptrs, _kw), (b_ptrs, _kb), (wt_ptrs, _kt) = (
        fr._ptrs(fm.kernel_ws), fr._ptrs(fm.kernel_bs), fr._ptrs(fm.kernel_wts))
    with build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x_pts.data_ptr(), d_pts.data_ptr(), dsig.data_ptr(), drgb.data_ptr(), p,
                position_dim, direction_dim, int(is_bf16), w_ptrs, b_ptrs, wt_ptrs,
                scratch.data_ptr(), partial.data_ptr(), bias_partial.data_ptr(),
                grads.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed with code {rc}")
    profiling.count(BWD_LAUNCHES)
    return fr._split_grads(grads, fm)


def points_backward(fm: fr.FusedMLP, x_pts, d_pts, dsig, drgb, position_dim: int = 10,
                    direction_dim: int = 4):
    """The 12 weight and 10 bias gradients (fp32) of one point pass, for the
    cotangents ``dsig [P, 1]`` and ``drgb [P, 3]``.

    CUDA tensors go through the backward kernel, CPU tensors through
    ``points_backward_plain``; any other device raises.
    """
    if x_pts.device.type == "cuda":
        return _launch_bwd(fm, x_pts, d_pts, dsig, drgb, position_dim, direction_dim)
    if x_pts.device.type == "cpu":
        return points_backward_plain(fm, x_pts, d_pts, dsig, drgb, position_dim,
                                     direction_dim)
    raise ValueError(f"no point-level MLP implementation for device {x_pts.device}")


class _PointsMLP(torch.autograd.Function):
    """``points_forward`` with ``points_backward`` as its gradient.

    Inputs: the prepared ``FusedMLP``, ``x_pts, d_pts``, the encoding dims,
    then ``fm.leaves`` (the fp32 parameters ``fm`` was packed from). The
    backward maps the flat gradients back onto those leaves; the points get
    none (nothing trainable lies upstream of the sample points, and JAX
    returns zeros for them).
    """

    @staticmethod
    def forward(ctx, fm, x_pts, d_pts, position_dim, direction_dim, *leaves):
        ctx.fm, ctx.dims = fm, (position_dim, direction_dim)
        ctx.save_for_backward(x_pts, d_pts)
        ctx.set_materialize_grads(False)
        return points_forward(fm, x_pts, d_pts, position_dim, direction_dim)

    @staticmethod
    def backward(ctx, dsig, drgb):
        x_pts, d_pts = ctx.saved_tensors
        p = x_pts.shape[0]
        zeros = lambda c: torch.zeros((p, c), dtype=torch.float32,  # noqa: E731
                                      device=x_pts.device)
        dsig = zeros(1) if dsig is None else dsig.float().contiguous()
        drgb = zeros(3) if drgb is None else drgb.float().contiguous()
        gws, gbs = points_backward(ctx.fm, x_pts, d_pts, dsig, drgb, *ctx.dims)
        return (None,) * 5 + tuple(flatten_tree(unflatten_mlp_grads(gws, gbs)))


def point_inputs(samples: torch.Tensor, direc: torch.Tensor):
    """The kernels' ``x_pts``, ``d_pts [N*S, 3]`` (fp32, contiguous) for
    ``samples [N, S, 3]`` and ray directions ``direc [N, 3]``, by JAX's
    prologue (``raymarch.py:204-207``): ``direc / |direc|`` broadcast per
    point, ``x = samples / pi``. The TPU kernel's padding to whole tiles is
    not needed: the kernels mask the ragged tile."""
    n, s, _ = samples.shape
    direc = direc / torch.linalg.norm(direc, dim=-1, keepdim=True)
    d_pts = direc[:, None, :].expand(n, s, 3).reshape(-1, 3)
    x_pts = normalize_coordinates(samples).reshape(-1, 3)
    return x_pts.float().contiguous(), d_pts.float().contiguous()


def nerf_mlp_kernel_apply(params, samples: torch.Tensor, direc: torch.Tensor,
                          position_dim: int = 10, direction_dim: int = 4, compute_dtype=None):
    """Drop-in ``models.mlp.nerf_mlp_apply`` through the point kernels.

    ``samples [N, S, 3]`` world-space positions, ``direc [N, 3]`` ray
    directions -> ``density [N, S, 1]``, ``rgb [N, S, 3]`` (fp32),
    differentiable in the parameters when they require gradients.
    ``params`` is one MLP tree or a prepared ``FusedMLP``.
    """
    fm = params if isinstance(params, fr.FusedMLP) else fr.prepare_fused_mlp(
        params, compute_dtype)
    n, s, _ = samples.shape
    args = (fm, *point_inputs(samples, direc), position_dim, direction_dim)
    if torch.is_grad_enabled() and any(t.requires_grad for t in fm.leaves):
        sigma, rgb = _PointsMLP.apply(*args, *fm.leaves)
    else:
        sigma, rgb = points_forward(*args)
    return sigma.reshape(n, s, 1), rgb.reshape(n, s, 3)


def make_mlp_kernel_apply():
    """An ``mlp_apply`` hook for ``models.nerf.render_rays`` (``--kernel
    pallas``; JAX ``make_pallas_mlp_apply``), called with one MLP at a time,
    packing the ``_CACHED_MLPS`` newest in a ``fused_raymarch.PackingCache``."""
    cache = fr.PackingCache(fr.prepare_fused_mlp, _CACHED_MLPS)

    def apply_fn(params, samples, direc, position_dim=10, direction_dim=4,
                 compute_dtype=None):
        return nerf_mlp_kernel_apply(cache(params, compute_dtype, samples), samples, direc,
                                     position_dim, direction_dim)

    return apply_fn
