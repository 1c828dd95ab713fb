"""TensoRF's shading chain: the CUDA kernels, the plain PyTorch version and
the autograd ``Function`` between them.

From the appearance products ``prods [P, 3 R_c]`` of the VM sampling
(``kernels.vm_sample``) and the rays' directions ``direc [N, 3]`` (``P = N
S``, point ``p`` on ray ``p // S``): the features ``a = prods @ basis``;
the first layer's input ``[a, d, PE(a, feature_pe), PE(d, view_pe)]`` (``d``
the unit direction; ``PE(v, F)`` the sines, then the cosines, of ``v_c
2^f`` at index ``c F + f``, TensoRF's ``positional_encoding``); then
``feature_width``-wide ReLU layers with biases to a sigmoid color ``rgb [P,
3]``. Matmul inputs are rounded to the compute dtype with fp32 sums
(``models.mlp.linear``).

- ``mlp_plain``: the chain in plain PyTorch (any sizes, any compute dtype),
  the route of CPU tensors, ``--kernel xla`` and fp32; autograd
  differentiates it. The card tests and ``chip_smoke.py [tensorf-mlp]``
  hold the kernels against it.
- ``tensorf_mlp``: the chain on a card through the kernels
  (``TensoRFMLP``): ``csrc/tensorf_mlp_fwd.cu`` packs the weights into bf16
  fragments and computes rgb, one call; ``csrc/tensorf_mlp_bwd.cu``
  recomputes the forward and computes the products' gradient and every
  parameter's, one call. CUDA tensors, bf16, the published widths only
  (``check_inputs``); no gradient to the directions. A call allocates only
  its outputs and scratch and reads no value on the host, so the train
  step's CUDA graph captures it.
- ``forward`` and ``backward`` are the single calls (``LAUNCHES_FWD``,
  ``LAUNCHES_BWD`` of ``utils.profiling`` count them).

Numerics: every product's inputs are rounded to bf16 and summed in fp32,
as the plain version at bf16 does. Its backward also rounds each gradient
that leaves a product to bf16 (autograd through its casts: the parameters'
gradients, ``dprods``, each layer's input gradient); the kernels keep them
fp32 until they enter the next product. So the two part by bf16 roundings,
not more (the tests' tolerances). The parameter gradients are fp32 sums
over fixed slices of the points, added in a fixed order: two backward
calls give the same bits.

Neither kernel replaces a TPU kernel: the JAX package has no TensoRF.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Dict, List, Tuple

import torch

from minimal_nerf_torch.models.mlp import linear, round_to
from minimal_nerf_torch.utils import profiling

LAUNCHES_FWD = "tensorf_mlp_fwd.launches"
LAUNCHES_BWD = "tensorf_mlp_bwd.launches"
# the only sizes the kernels take: 3 R_c products, app_dim, feature_width,
# feature_pe, view_pe (configs/lego.txt's)
PRODS, APP_DIM, WIDTH, FEATURE_PE, VIEW_PE = 144, 27, 128, 2, 2
IN = APP_DIM + 3 + 2 * FEATURE_PE * APP_DIM + 2 * VIEW_PE * 3  # 150
SLICE_TARGET = 128  # the weight gradients' slices of the points (about)

_P = ctypes.c_void_p
_FWD_ARGS = [_P, _P, ctypes.c_longlong, ctypes.c_int] + [_P] * 9 + [_P]
_BWD_ARGS = [_P, _P, ctypes.c_longlong, ctypes.c_int] + [_P] * 8 + [
    ctypes.c_int, ctypes.c_int, _P, _P]


def frequency_encoding(v: torch.Tensor, freqs: int) -> torch.Tensor:
    """``[..., C] -> [..., 2 C freqs]``: ``sin(v_c 2^f)`` at ``c freqs + f``,
    then the cosines (TensoRF's ``positional_encoding``, no pi)."""
    scales = 2.0 ** torch.arange(freqs, dtype=torch.float32, device=v.device)
    pts = (v[..., None] * scales).reshape(*v.shape[:-1], freqs * v.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def mlp_plain(prods: torch.Tensor, direc: torch.Tensor, basis: torch.Tensor,
              mlp: List[Dict[str, torch.Tensor]], feature_pe: int, view_pe: int,
              compute_dtype=None) -> torch.Tensor:
    """``rgb [P, 3]`` of the products ``[P, 3 R_c]`` on rays with directions
    ``[N, 3]`` (``S = P / N`` points a ray) in plain PyTorch (module doc)."""
    n = direc.shape[0]
    s = prods.shape[0] // n if n else 0
    a = round_to(prods, compute_dtype) @ round_to(basis, compute_dtype)
    d = direc / torch.linalg.norm(direc, dim=-1, keepdim=True)
    d = torch.cat([d, frequency_encoding(d, view_pe)], dim=-1)
    d = d[:, None, :].expand(n, s, d.shape[-1]).reshape(-1, d.shape[-1])
    h = torch.cat([a, d[:, :3], frequency_encoding(a, feature_pe), d[:, 3:]], dim=-1)
    for layer in mlp[:-1]:
        h = torch.relu(linear(layer, h, compute_dtype))
    return torch.sigmoid(linear(mlp[-1], h, compute_dtype))


def check_inputs(prods: torch.Tensor, direc: torch.Tensor, basis: torch.Tensor,
                 mlp: List[Dict[str, torch.Tensor]]) -> None:
    """Raise ``ValueError`` unless the products are a contiguous fp32 ``[P,
    144]``, the directions a contiguous fp32 ``[N, 3]`` with ``N`` dividing
    ``P``, and the basis and the layers contiguous fp32 at the published
    widths (``[144, 27]``; ``[150, 128]``, ``[128, 128]``, ``[128, 3]`` and
    their biases), all on one device."""
    def need(name, t, shape):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous float32 {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != prods.device:
            raise ValueError(f"inputs on several devices: {prods.device}, {t.device}")

    if prods.dim() != 2 or direc.dim() != 2:
        raise ValueError(f"expected products [P, {PRODS}] and directions [N, 3], got "
                         f"{tuple(prods.shape)} and {tuple(direc.shape)}")
    p, n = prods.shape[0], direc.shape[0]
    need("prods", prods, (p, PRODS))
    need("direc", direc, (n, 3))
    if (p % n if n else p):
        raise ValueError(f"{p} points on {n} rays: not a whole number of samples a ray")
    need("basis", basis, (PRODS, APP_DIM))
    if len(mlp) != 3:
        raise ValueError(f"expected 3 layers, got {len(mlp)}")
    for i, (layer, (k, o)) in enumerate(zip(mlp, ((IN, WIDTH), (WIDTH, WIDTH), (WIDTH, 3)))):
        need(f"mlp[{i}].w", layer["w"], (k, o))
        need(f"mlp[{i}].b", layer["b"], (o,))


def plan(p: int) -> Tuple[int, int]:
    """``(slices, chunk)``: the weight gradients' slices of ``p`` points, a
    whole number of 32-point stages each (a fixed function of ``p``, so the
    sums' order is too)."""
    chunk = max(32, math.ceil(math.ceil(p / SLICE_TARGET) / 32) * 32)
    return math.ceil(p / chunk), chunk


@functools.lru_cache(maxsize=None)
def _image_bytes() -> int:
    """The packed weights' bytes, as the forward's library defines them."""
    from minimal_nerf_torch.kernels import build

    out = ctypes.c_int()
    build.function("tensorf_mlp_fwd", "tensorf_mlp_fwd_sizes", [_P], None)(ctypes.byref(out))
    return out.value


@functools.lru_cache(maxsize=None)
def _bwd_sizes() -> Tuple[int, int, int]:
    """``(scratch columns, partial floats a slice, gradient floats)``, as
    the backward's library defines them."""
    from minimal_nerf_torch.kernels import build

    vals = [ctypes.c_int() for _ in range(3)]
    build.function("tensorf_mlp_bwd", "tensorf_mlp_bwd_sizes", [_P] * 3, None)(
        *(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


def _launch(symbol: str, argtypes, args, counter: str, dev) -> None:
    from minimal_nerf_torch.kernels import build

    fn = build.function(symbol, symbol, argtypes)
    with build.on_device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with code {rc}")
    profiling.count(counter)


def _weights(basis, mlp):
    return [basis.data_ptr()] + [t.data_ptr() for layer in mlp for t in (layer["w"], layer["b"])]


def forward(prods: torch.Tensor, direc: torch.Tensor, basis: torch.Tensor,
            mlp: List[Dict[str, torch.Tensor]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the forward on CUDA tensors: ``(rgb [P, 3], image)``, the
    image the weights packed for the kernels (the backward's input)."""
    if prods.device.type != "cuda":
        raise ValueError(f"the shading kernels take CUDA tensors, got {prods.device}")
    check_inputs(prods, direc, basis, mlp)
    p = prods.shape[0]
    image = torch.empty(_image_bytes() // 4, dtype=torch.int32, device=prods.device)
    rgb = torch.empty((p, 3), dtype=torch.float32, device=prods.device)
    if p:
        basis_p, w1, b1, w2, b2, w3, b3 = _weights(basis, mlp)
        _launch("tensorf_mlp_fwd", _FWD_ARGS,
                [prods.data_ptr(), direc.data_ptr(), p, p // direc.shape[0], basis_p, w1, b1, w2,
                 b2, w3, b3, image.data_ptr(), rgb.data_ptr()], LAUNCHES_FWD, prods.device)
    return rgb, image


def backward(prods: torch.Tensor, direc: torch.Tensor, basis: torch.Tensor,
             mlp: List[Dict[str, torch.Tensor]], image: torch.Tensor, g_rgb: torch.Tensor):
    """One call of the backward on CUDA tensors, for the color's gradient
    ``g_rgb [P, 3]``: ``(dprods [P, 144], dbasis, [{"w", "b"}] * 3)``, fp32
    in the parameters' shapes."""
    if prods.device.type != "cuda":
        raise ValueError(f"the shading kernels take CUDA tensors, got {prods.device}")
    check_inputs(prods, direc, basis, mlp)
    p, dev = prods.shape[0], prods.device
    g_rgb = g_rgb.float().contiguous()
    if tuple(g_rgb.shape) != (p, 3):
        raise ValueError(f"g_rgb: expected [{p}, 3], got {tuple(g_rgb.shape)}")
    cols, partial_floats, out_floats = _bwd_sizes()
    if image.numel() * image.element_size() != _image_bytes() or image.device != dev:
        raise ValueError("image: not the forward's packed weights on this device")
    dprods = torch.empty((p, PRODS), dtype=torch.float32, device=dev)
    out = (torch.empty if p else torch.zeros)(out_floats, dtype=torch.float32, device=dev)
    if p:
        slices, chunk = plan(p)
        scratch = torch.empty(cols * p, dtype=torch.bfloat16, device=dev)
        partial = torch.empty(slices * partial_floats, dtype=torch.float32, device=dev)
        _, _, b1, _, b2, _, b3 = _weights(basis, mlp)
        _launch("tensorf_mlp_bwd", _BWD_ARGS,
                [prods.data_ptr(), direc.data_ptr(), p, p // direc.shape[0], image.data_ptr(),
                 b1, b2, b3, g_rgb.data_ptr(), dprods.data_ptr(), scratch.data_ptr(),
                 partial.data_ptr(), slices, chunk, out.data_ptr()], LAUNCHES_BWD, dev)
    shapes = [(PRODS, APP_DIM), (IN, WIDTH), (WIDTH,), (WIDTH, WIDTH), (WIDTH,), (WIDTH, 3), (3,)]
    parts = list(torch.split(out, [math.prod(s) for s in shapes]))
    dbasis, *layers = [t.view(s) for t, s in zip(parts, shapes)]
    return dprods, dbasis, [{"w": layers[2 * i], "b": layers[2 * i + 1]} for i in range(3)]


class TensoRFMLP(torch.autograd.Function):
    """``tensorf_mlp`` with the gradients of the products and the
    parameters: the forward and backward calls (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, prods, direc, basis, w1, b1, w2, b2, w3, b3):
        mlp = [{"w": w1, "b": b1}, {"w": w2, "b": b2}, {"w": w3, "b": b3}]
        rgb, image = forward(prods, direc, basis, mlp)
        ctx.save_for_backward(prods, direc, basis, w1, b1, w2, b2, w3, b3, image)
        return rgb

    @staticmethod
    def backward(ctx, g_rgb):
        prods, direc, basis, w1, b1, w2, b2, w3, b3, image = ctx.saved_tensors
        mlp = [{"w": w1, "b": b1}, {"w": w2, "b": b2}, {"w": w3, "b": b3}]
        dprods, dbasis, grads = backward(prods, direc, basis, mlp, image, g_rgb)
        return (dprods, None, dbasis) + tuple(g[k] for g in grads for k in ("w", "b"))


def tensorf_mlp(prods: torch.Tensor, direc: torch.Tensor, basis: torch.Tensor,
                mlp: List[Dict[str, Any]]) -> torch.Tensor:
    """``rgb [P, 3]`` of the products ``[P, 144]`` on rays with directions
    ``[N, 3]`` on a card, through the kernels (``TensoRFMLP``); the
    directions take no gradient."""
    if direc.requires_grad:
        raise ValueError("the shading kernels give the directions no gradient")
    return TensoRFMLP.apply(prods.contiguous(), direc.contiguous(), basis,
                            *(layer[k] for layer in mlp for k in ("w", "b")))
