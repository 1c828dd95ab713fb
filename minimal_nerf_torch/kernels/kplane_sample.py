"""K-Planes' multi-scale plane sampling: the CUDA kernels, their plain
PyTorch versions and the autograd ``Function`` between them.

Each scale ``s`` has three planes stored channel-last as ``planes[s] [3,
N_s, N_s, C]``; plane ``c`` spans the axes ``PLANE_AXES[c] = (w, h)`` (rows
along ``h``, columns along ``w``: K-Planes' ``[1, C, N, N]`` grid is
``planes[s][c].permute(2, 0, 1)[None]``). A point ``x`` of the box
``[-bound, bound]^3`` maps to its cell and place on each axis at ``N_s`` as
``vm_sample.locate`` computes them (``grid_sample``'s ``align_corners=True``
with the coordinate clamped to the border, so a point outside the box reads
the border: ``padding_mode='border'``). Per point, scale and plane the
plane is interpolated bilinearly from its 4 corner rows, and scale ``s``'s
feature is the product of its three planes' values, ``(P_0 * P_1) * P_2``
channel by channel; the features are the scales' in order, ``[P, S C]``.

``csrc/kplane_sample_fwd.cu`` computes them with the plain version's
operations in its order; ``csrc/kplane_sample_bwd.cu`` adds the gradient
``g * (product of the other two planes)`` of each plane's corners into the
planes' gradients with float4 atomic adds, one per run of consecutive
points in one cell (no gradient to the positions). Both share the box and
corner arithmetic with TensoRF's kernels (``csrc/plane_corners.cuh``).
Neither replaces a TPU kernel: the JAX package has no K-Planes.

- ``kplane_sample(x, planes, bound)``: the sampling as the field calls it
  on a card (``KPlaneSample``): one kernel launch each way, CUDA tensors
  only (the field sends CPU tensors through autograd of ``sample_plain``).
  It allocates only its output and the zeroed gradients, reads no value on
  the host and is captured in the train step's CUDA graph.
- ``forward`` and ``backward`` are the single launches (``LAUNCHES_FWD``,
  ``LAUNCHES_BWD`` of ``utils.profiling`` count them); ``check_inputs``
  holds what the kernels take (4 scales of 32 channels, the published
  sizes; any resolution of at least 2).
- ``sample_plain`` and ``backward_plain`` are the plain versions (indexing;
  autograd differentiates ``sample_plain``, the route of ``--kernel xla``
  and of CPU tensors; ``backward_plain`` is the backward kernel's reference
  in the tests).
- The fp32 atomics make the planes' gradients vary in their last bits from
  run to run; the forward is deterministic.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from minimal_nerf_torch.kernels.vm_sample import box_constants, locate
from minimal_nerf_torch.utils import profiling

LAUNCHES_FWD = "kplane_sample_fwd.launches"
LAUNCHES_BWD = "kplane_sample_bwd.launches"
PLANE_AXES = ((0, 1), (0, 2), (1, 2))  # (w, h): itertools.combinations(range(3), 2)
KERNEL_SCALES, KERNEL_CHANNELS = 4, 32  # the only sizes the kernels take

_FWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
_BWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 6


def corners(cell: torch.Tensor, frac: torch.Tensor, res: int, c: int):
    """The rows of plane ``c``'s 4 corners (into ``[N * N, C]``) with their
    weights, in the kernels' order: ``(h, w)``, ``(h, w + 1)``, ``(h + 1,
    w)``, ``(h + 1, w + 1)``."""
    aw, ah = PLANE_AXES[c]
    fw, fh = frac[:, aw], frac[:, ah]
    ow, oh = 1.0 - fw, 1.0 - fh
    row = cell[:, ah] * res + cell[:, aw]
    return ((row, ow * oh), (row + 1, fw * oh), (row + res, ow * fh), (row + res + 1, fw * fh))


def _scale_values(scale: torch.Tensor, cell: torch.Tensor, frac: torch.Tensor):
    """A scale's three planes ``[3, N, N, C]`` interpolated at the points'
    corners: ``([3, P, C], rows)``, each plane's 4 corner terms summed in
    order, the 12 corners gathered at once (one scatter in autograd's
    backward); ``rows`` holds each plane's ``corners``."""
    res, ch = scale.shape[1], scale.shape[-1]
    rows = [corners(cell, frac, res, c) for c in range(3)]
    index = torch.stack([r + c * res * res for c in range(3) for r, _ in rows[c]])
    weight = torch.stack([w for c in range(3) for _, w in rows[c]])[..., None]
    t = scale.reshape(3 * res * res, ch)[index] * weight  # [12, P, C], plane-major
    return ((t[0::4] + t[1::4]) + t[2::4]) + t[3::4], rows


def sample_plain(x: torch.Tensor, planes: Sequence[torch.Tensor], bound: float) -> torch.Tensor:
    """The features ``[P, S C]`` of points ``x [P, 3]`` in plain PyTorch (any
    number of scales and channels), with the kernels' operations in their
    order. Differentiable in the planes (autograd's gradient is an
    accumulating scatter)."""
    out = []
    for scale in planes:
        _, cell, frac = locate(x, bound, scale.shape[1])
        v, _ = _scale_values(scale, cell, frac)
        out.append((v[0] * v[1]) * v[2])
    return torch.cat(out, dim=1)


@torch.no_grad()
def backward_plain(x: torch.Tensor, planes: Sequence[torch.Tensor], bound: float,
                   g: torch.Tensor) -> List[torch.Tensor]:
    """The planes' gradients (fp32) of ``sample_plain`` for the features'
    gradient ``g [P, S C]``: per scale, plane and corner ``w * g * (the
    other two planes' values)``, added into the rows with ``index_add_``."""
    out, lo = [], 0
    for scale in planes:
        res, ch = scale.shape[1], scale.shape[-1]
        _, cell, frac = locate(x, bound, res)
        v, rows = _scale_values(scale, cell, frac)
        gs = g[:, lo:lo + ch].float()
        grad = torch.zeros_like(scale, dtype=torch.float32)
        for c in range(3):
            a, b = [v[o] for o in range(3) if o != c]
            t = gs * (a * b)
            flat = grad[c].view(res * res, ch)
            for r, w in rows[c]:
                flat.index_add_(0, r, w[:, None] * t)
        out.append(grad)
        lo += ch
    return out


def check_inputs(x: torch.Tensor, planes: Sequence[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous fp32 ``[P, 3]`` and
    the planes ``KERNEL_SCALES`` contiguous fp32 ``[3, N, N, 32]`` (N at
    least 2) on its device."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"x: expected contiguous float32 [P, 3], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if len(planes) != KERNEL_SCALES:
        raise ValueError(f"expected {KERNEL_SCALES} scales of planes, got {len(planes)}")
    for s, t in enumerate(planes):
        res = t.shape[1] if t.dim() == 4 else 0
        want = (3, res, res, KERNEL_CHANNELS)
        if t.dtype != torch.float32 or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"planes[{s}]: expected contiguous float32 [3, N, N, "
                             f"{KERNEL_CHANNELS}], got {t.dtype} {tuple(t.shape)}")
        if res < 2:
            raise ValueError(f"planes[{s}]: a resolution of at least 2, got {res}")
        if t.device != x.device:
            raise ValueError(f"inputs on several devices: {x.device}, {t.device}")


def _launch(symbol: str, argtypes, args, counter: str, dev) -> None:
    from minimal_nerf_torch.kernels import build

    fn = build.function(symbol, symbol, argtypes)
    with build.on_device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with code {rc}")
    profiling.count(counter)


def _common_args(x, planes, bound):
    lo, _, inv = box_constants(bound)
    return ([x.data_ptr(), x.shape[0]] + [t.data_ptr() for t in planes]
            + [t.shape[1] for t in planes] + [lo, inv])


def _on_card(x: torch.Tensor, planes) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the K-Planes sampling kernel takes CUDA tensors, got {x.device}")
    check_inputs(x, planes)


def forward(x: torch.Tensor, planes: Sequence[torch.Tensor], bound: float) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors: the features ``[P,
    128]``."""
    _on_card(x, planes)
    out = torch.empty((x.shape[0], KERNEL_SCALES * KERNEL_CHANNELS), dtype=torch.float32,
                      device=x.device)
    if x.shape[0]:
        _launch("kplane_sample_fwd", _FWD_ARGS, _common_args(x, planes, bound)
                + [out.data_ptr()], LAUNCHES_FWD, x.device)
    return out


def backward(x: torch.Tensor, planes: Sequence[torch.Tensor], bound: float,
             g: torch.Tensor) -> List[torch.Tensor]:
    """One launch of the backward kernel on CUDA tensors: the planes'
    gradients (zeroed here, fp32) for the features' gradient ``g [P,
    128]``."""
    _on_card(x, planes)
    n = x.shape[0]
    g = g.float().contiguous()
    if tuple(g.shape) != (n, KERNEL_SCALES * KERNEL_CHANNELS):
        raise ValueError(f"gradient: expected [{n}, {KERNEL_SCALES * KERNEL_CHANNELS}], got "
                         f"{tuple(g.shape)}")
    out = [torch.zeros_like(t) for t in planes]
    if n:
        _launch("kplane_sample_bwd", _BWD_ARGS, _common_args(x, planes, bound)
                + [g.data_ptr()] + [t.data_ptr() for t in out], LAUNCHES_BWD, x.device)
    return out


class KPlaneSample(torch.autograd.Function):
    """``kplane_sample`` with the planes' gradients: the forward and
    backward kernels (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, x, bound, *planes):
        ctx.save_for_backward(x, *planes)
        ctx.bound = bound
        return forward(x, planes, bound)

    @staticmethod
    def backward(ctx, g):
        x, *planes = ctx.saved_tensors
        return (None, None) + tuple(backward(x, planes, ctx.bound, g))


def kplane_sample(x: torch.Tensor, planes: Sequence[torch.Tensor], bound: float) -> torch.Tensor:
    """The features ``[P, 128]`` of points ``x [P, 3]`` on a card, through
    the kernels (``KPlaneSample``)."""
    return KPlaneSample.apply(x.contiguous(), bound, *planes)
