"""TensoRF's vector-matrix (VM) factor sampling: the CUDA kernels, their
plain PyTorch versions and the autograd ``Function`` between them.

The factors of one kind (density or appearance) are, per mode ``m``, a
plane ``[N, N, R]`` over the axes ``PLANE_AXES[m] = (w, h)`` (rows along
``h``, columns along ``w``) and a line ``[N, R]`` along ``LINE_AXES[m]``,
stored channel-last as ``planes [3, N, N, R]`` and ``lines [3, N, R]``
(TensoRF's ``TensorVMSplit`` keeps ``[1, R, N, N]`` and ``[1, R, N, 1]``
per mode: ``planes[m] == plane_m[0].permute(1, 2, 0)``). A point ``x`` of
the box ``[-bound, bound]^3`` maps to ``xhat = (x + bound) * (1 / bound) -
1`` in ``[-1, 1]`` and to the pixel ``(xhat + 1) * 0.5 * (N - 1)`` on each
axis (``grid_sample``'s ``align_corners=True``), whose cell is ``floor``
clamped to ``N - 2``. Per point and mode the plane is interpolated
bilinearly from its 4 corner rows, the line linearly from its 2, and their
product taken per channel:

- ``f_sigma [P]``: the sum over the modes and the ``R_sigma`` density
  channels of the products (``-inf`` for a point outside the box, whose
  softplus is a density of 0);
- ``prods [P, 3 R_c]``: the appearance products, mode-major (0 outside).

``csrc/vm_sample_fwd.cu`` computes both (or ``f_sigma`` alone) with the
plain version's operations in its order; ``csrc/vm_sample_bwd.cu`` adds
the gradients of both into the four factors' gradients with float4 atomic
adds, one per run of consecutive points in one cell (no gradient to the
positions, none from a point outside the box). Neither replaces a TPU
kernel: the JAX package has no TensoRF.

- ``vm_sample(x, factors, bound, with_app)``: the sampling as the field
  calls it on a card (``VMSample``): one kernel launch each way, CUDA
  tensors only (the field sends CPU tensors through autograd of
  ``sample_plain``). It allocates only its outputs and the zeroed
  gradients, reads no value on the host and is captured in the train
  step's CUDA graph.
- ``forward`` and ``backward`` are the single launches (``LAUNCHES_FWD``,
  ``LAUNCHES_BWD`` of ``utils.profiling`` count them); ``check_inputs``
  holds what the kernels take (the published ``R_sigma = 16``, ``R_c = 48``).
- ``sample_plain`` and ``backward_plain`` are the plain versions (indexing;
  autograd differentiates ``sample_plain``, the route of ``--kernel xla``
  and of CPU tensors; ``backward_plain`` is the backward kernel's reference
  in the tests and ``chip_smoke.py``).
- The fp32 atomics make the factors' gradients vary in their last bits from
  run to run; the forward is deterministic.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from minimal_nerf_torch.utils import profiling

LAUNCHES_FWD = "vm_sample_fwd.launches"
LAUNCHES_BWD = "vm_sample_bwd.launches"
PLANE_AXES = ((0, 1), (0, 2), (1, 2))  # TensoRF's matMode: (w, h) axes of each mode's plane
LINE_AXES = (2, 1, 0)                  # TensoRF's vecMode
KERNEL_COMPONENTS = (16, 48)  # (R_sigma, R_c): the only component counts the kernels take
KEYS = ("density_planes", "density_lines", "app_planes", "app_lines")

_FWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3
_BWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 7


def box_constants(bound: float) -> Tuple[float, float, float]:
    """``(lo, hi, inv)``, the box ``[lo, hi]^3`` and ``inv = 2 / (hi - lo)``
    as fp32 values (what the kernels are handed)."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return f32(-bound), f32(bound), f32(2.0 / (2.0 * bound))


def locate(x: torch.Tensor, bound: float, res: int):
    """``(inside [P], cell [P, 3] int64, frac [P, 3])`` of points ``x [P,
    3]``: inside the closed box, each axis's cell and place in it, with the
    kernels' operations in their order."""
    lo, hi, inv = box_constants(bound)
    inside = ((x >= lo) & (x <= hi)).all(dim=-1)
    xhat = (x - lo) * inv - 1.0
    pix = torch.clamp(((xhat + 1.0) * 0.5) * float(res - 1), 0.0, float(res - 1))
    cell = torch.clamp(torch.floor(pix), max=float(res - 2))
    return inside, cell.long(), pix - cell


def _corners(cell, frac, res: int, m: int):
    """The rows of mode ``m``'s 4 plane corners (into ``[N * N, R]``) and 2
    line corners (into ``[N, R]``) with their weights, in the kernels'
    order: plane ``(h, w)``, ``(h, w + 1)``, ``(h + 1, w)``, ``(h + 1, w +
    1)``; line ``l``, ``l + 1``."""
    aw, ah = PLANE_AXES[m]
    al = LINE_AXES[m]
    iw, ih, il = cell[:, aw], cell[:, ah], cell[:, al]
    fw, fh, fl = frac[:, aw], frac[:, ah], frac[:, al]
    ow, oh = 1.0 - fw, 1.0 - fh
    row = ih * res + iw
    plane = ((row, ow * oh), (row + 1, fw * oh), (row + res, ow * fh), (row + res + 1, fw * fh))
    line = ((il, 1.0 - fl), (il + 1, fl))
    return plane, line


def _mode_values(planes, lines, m: int, plane, line):
    """The interpolated plane and line ``[P, R]`` of mode ``m``."""
    res, r = planes.shape[1], planes.shape[-1]
    flat = planes[m].reshape(res * res, r)
    pv = None
    for rows, w in plane:
        term = flat[rows] * w[:, None]
        pv = term if pv is None else pv + term
    (r0, w0), (r1, w1) = line
    lv = lines[m][r0] * w0[:, None] + lines[m][r1] * w1[:, None]
    return pv, lv


def _group_sums(prod: torch.Tensor) -> torch.Tensor:
    """``[P, R] -> [P, ceil(R / 4)]``: each group of 4 channels summed in
    channel order (a kernel thread's sum)."""
    groups = []
    for lo in range(0, prod.shape[1], 4):
        s = prod[:, lo]
        for c in range(lo + 1, min(lo + 4, prod.shape[1])):
            s = s + prod[:, c]
        groups.append(s)
    return torch.stack(groups, dim=1)


def sample_plain(x: torch.Tensor, factors: Dict[str, torch.Tensor], bound: float,
                 with_app: bool = True):
    """``(f_sigma [P], prods [P, 3 R_c] or None)`` of points ``x [P, 3]`` in
    plain PyTorch (any component counts), with the kernels' operations in
    their order: per density group of 4 channels the sum over its channels,
    then over the modes, then the groups summed pairwise. Differentiable in
    the factors (autograd's gradient is an accumulating scatter)."""
    dp, dl = factors["density_planes"], factors["density_lines"]
    res = dp.shape[1]
    inside, cell, frac = locate(x, bound, res)
    acc, prods = None, []
    for m in range(3):
        plane, line = _corners(cell, frac, res, m)
        pv, lv = _mode_values(dp, dl, m, plane, line)
        s = _group_sums(pv * lv)
        acc = s if acc is None else acc + s
        if with_app:
            pv, lv = _mode_values(factors["app_planes"], factors["app_lines"], m, plane, line)
            prods.append(pv * lv)
    groups = list(acc.unbind(1))
    while len(groups) > 1:
        groups = [groups[i] + groups[i + 1] if i + 1 < len(groups) else groups[i]
                  for i in range(0, len(groups), 2)]
    f_sigma = torch.where(inside, groups[0], torch.full_like(groups[0], -float("inf")))
    if not with_app:
        return f_sigma, None
    return f_sigma, torch.where(inside[:, None], torch.cat(prods, dim=1), 0.0)


@torch.no_grad()
def backward_plain(x: torch.Tensor, factors: Dict[str, torch.Tensor], bound: float,
                   g_sigma: Optional[torch.Tensor], g_prods: Optional[torch.Tensor]):
    """The four factors' gradients (``KEYS``' order, fp32) of
    ``sample_plain`` for the outputs' gradients ``g_sigma [P]`` and
    ``g_prods [P, 3 R_c]`` (None: zero): per mode and corner ``w *
    (g * other factor's value)``, added into the rows with ``index_add_``;
    nothing from a point outside the box."""
    dp = factors["density_planes"]
    res = dp.shape[1]
    inside, cell, frac = locate(x, bound, res)
    keep = inside.float()[:, None]
    out = [torch.zeros_like(factors[k], dtype=torch.float32) for k in KEYS]
    rc = factors["app_planes"].shape[-1]
    for m in range(3):
        plane, line = _corners(cell, frac, res, m)
        for kind, (gp, gl) in enumerate(((out[0], out[1]), (out[2], out[3]))):
            planes, lines = (factors[KEYS[2 * kind]], factors[KEYS[2 * kind + 1]])
            r = planes.shape[-1]
            if kind == 0:
                if g_sigma is None:
                    continue
                g = g_sigma.float()[:, None].expand(-1, r)
            else:
                if g_prods is None:
                    continue
                g = g_prods.float()[:, m * rc:(m + 1) * rc]
            pv, lv = _mode_values(planes, lines, m, plane, line)
            tp, tl = g * lv * keep, g * pv * keep
            flat = gp[m].view(res * res, r)
            for rows, w in plane:
                flat.index_add_(0, rows, w[:, None] * tp)
            for rows, w in line:
                gl[m].index_add_(0, rows, w[:, None] * tl)
    return tuple(out)


def check_inputs(x: torch.Tensor, factors: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous fp32 ``[P, 3]`` and
    the factors contiguous fp32 ``[3, N, N, R]`` planes and ``[3, N, R]``
    lines (N at least 2) on its device, with the component counts the
    kernels are built for (``KERNEL_COMPONENTS``)."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"x: expected contiguous float32 [P, 3], got {x.dtype} "
                         f"{tuple(x.shape)}")
    res = factors["density_planes"].shape[1]
    for key, r in zip(KEYS, (KERNEL_COMPONENTS[0],) * 2 + (KERNEL_COMPONENTS[1],) * 2):
        t = factors[key]
        want = (3, res, res, r) if key.endswith("planes") else (3, res, r)
        if t.dtype != torch.float32 or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"{key}: expected contiguous float32 {list(want)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"inputs on several devices: {x.device}, {t.device}")
    if res < 2:
        raise ValueError(f"a factor resolution of at least 2, got {res}")


def _launch(symbol: str, argtypes, args, counter: str, dev) -> None:
    from minimal_nerf_torch.kernels import build

    fn = build.function(symbol, symbol, argtypes)
    with build.on_device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with code {rc}")
    profiling.count(counter)


def _common_args(x, factors, bound):
    f = [factors[k] for k in KEYS]
    return [x.data_ptr(), x.shape[0]] + [t.data_ptr() for t in f] + [
        f[0].shape[1], *box_constants(bound)]


def forward(x: torch.Tensor, factors: Dict[str, torch.Tensor], bound: float,
            with_app: bool = True):
    """One launch of the forward kernel on CUDA tensors: ``(f_sigma [P],
    prods [P, 144] or None)``."""
    if x.device.type != "cuda":
        raise ValueError(f"the VM sampling kernel takes CUDA tensors, got {x.device}")
    check_inputs(x, factors)
    n = x.shape[0]
    sigma = torch.empty(n, dtype=torch.float32, device=x.device)
    prods = (torch.empty((n, 3 * KERNEL_COMPONENTS[1]), dtype=torch.float32, device=x.device)
             if with_app else None)
    if n:
        _launch("vm_sample_fwd", _FWD_ARGS, _common_args(x, factors, bound) + [
            sigma.data_ptr(), prods.data_ptr() if with_app else None], LAUNCHES_FWD, x.device)
    return sigma, prods


def backward(x: torch.Tensor, factors: Dict[str, torch.Tensor], bound: float,
             g_sigma: Optional[torch.Tensor], g_prods: Optional[torch.Tensor]):
    """One launch of the backward kernel on CUDA tensors: the four
    factors' gradients (``KEYS``' order, zeroed here, fp32) for
    ``g_sigma [P]`` and ``g_prods [P, 144]`` (None: zero)."""
    if x.device.type != "cuda":
        raise ValueError(f"the VM sampling kernel takes CUDA tensors, got {x.device}")
    check_inputs(x, factors)
    n = x.shape[0]
    if g_sigma is None:
        g_sigma = torch.zeros(n, dtype=torch.float32, device=x.device)
    if g_prods is None:
        g_prods = torch.zeros((n, 3 * KERNEL_COMPONENTS[1]), dtype=torch.float32,
                              device=x.device)
    g_sigma, g_prods = g_sigma.float().contiguous(), g_prods.float().contiguous()
    if tuple(g_sigma.shape) != (n,) or tuple(g_prods.shape) != (n, 3 * KERNEL_COMPONENTS[1]):
        raise ValueError(f"gradients: expected [{n}] and [{n}, {3 * KERNEL_COMPONENTS[1]}], got "
                         f"{tuple(g_sigma.shape)} and {tuple(g_prods.shape)}")
    out = tuple(torch.zeros_like(factors[k]) for k in KEYS)
    if n:
        _launch("vm_sample_bwd", _BWD_ARGS, _common_args(x, factors, bound) + [
            g_sigma.data_ptr(), g_prods.data_ptr()] + [t.data_ptr() for t in out],
            LAUNCHES_BWD, x.device)
    return out


class VMSample(torch.autograd.Function):
    """``vm_sample`` with the factors' gradients: the forward and backward
    kernels (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, x, bound, with_app, dp, dl, ap, al):
        ctx.save_for_backward(x, dp, dl, ap, al)
        ctx.bound = bound
        out = forward(x, dict(zip(KEYS, (dp, dl, ap, al))), bound, with_app)
        return out if with_app else out[0]

    @staticmethod
    def backward(ctx, g_sigma, g_prods=None):
        x, *f = ctx.saved_tensors
        return (None, None, None) + backward(x, dict(zip(KEYS, f)), ctx.bound, g_sigma,
                                             g_prods)


def vm_sample(x: torch.Tensor, factors: Dict[str, torch.Tensor], bound: float,
              with_app: bool = True):
    """``(f_sigma [P], prods [P, 3 R_c])`` of points ``x [P, 3]`` on a card,
    or ``f_sigma`` alone without ``with_app``, through the kernels
    (``VMSample``)."""
    out = VMSample.apply(x.contiguous(), bound, with_app, *(factors[k] for k in KEYS))
    return out if with_app else (out, None)
