"""The fused occupancy sampler: the whole coarse-sampler hook in one kernel.

Counterpart of the coarse sampler of
``minimal_nerf_tpu/ops/occupancy.py::make_occupancy_sampler``
(``query_bin_weights`` + ``occupancy_coarse_samples``), whose one Pallas
kernel is the bin probe (``minimal_nerf_tpu/kernels/occupancy_probe.py::
_probe_kernel``). For rays ``o, d [N, 3]`` and their draws ``eps [N, 1]``
and, with in-bin jitter, ``frac [N, S]`` (raw ``U[0, 1)``), the kernel in
``csrc/occupancy_sampler.cu`` computes the bins' cells, the probe, the bin
weights with the uniform fallback, the CDF, the inverse-CDF bin of each
sample, its place in the bin, the sort and ``samples = o + ts * d`` in one
launch. The plain version is ``ops.occupancy.occupancy_sample_plain`` (the
existing PyTorch math); ``ops.occupancy.occupancy_sample`` dispatches.

- ``sample`` is the wrapper: CUDA tensors only (adding one to ``launches``
  per launch), with no fallback; ``check_inputs`` holds what every version
  takes, ``check_kernel_limits`` what only the kernel takes (B and S up to
  256, a floor of at least 0).
- ``BinConstants`` are the scalars as the plain version rounds them:
  ``scale = G / (2 bound)`` and ``width = (far - near) / B`` computed in
  double, then each scalar rounded to float32, as torch rounds a Python
  float when it applies it to a float32 tensor.
- The C function comes from ``build.function`` (its ``argtypes`` set once)
  and is called inside ``build.on_device`` (no device switch when the
  tensors' device is current).
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional, Tuple

import torch

# kernel launches since the last reset
launches = 0

KERNEL = "occupancy_sampler"
MAX_BINS = 256
MAX_SAMPLES = 256

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 5 + [ctypes.c_void_p]


class BinConstants(NamedTuple):
    """The sampler's scalars, each a float32 value held in a Python float."""
    resolution: int
    num_bins: int
    bound: float
    scale: float
    width: float
    near: float
    floor: float


def _f32(x: float) -> float:
    """``x`` rounded to the nearest float32 (as torch applies a Python float
    to a float32 tensor)."""
    return struct.unpack("f", struct.pack("f", x))[0]


@functools.lru_cache(maxsize=64)
def bin_constants(cfg, num_bins: int, near: float, far: float) -> BinConstants:
    """The scalars of an ``ops.occupancy.OccupancyConfig`` (its
    ``resolution``, ``bound`` and ``floor``) over ``num_bins`` bins of
    ``[near, far]``, as ``bin_cells`` and ``occupancy_coarse_samples`` round
    them."""
    g = cfg.resolution
    return BinConstants(g, num_bins, _f32(cfg.bound), _f32(g / (2.0 * cfg.bound)),
                        _f32((far - near) / num_bins), _f32(near), _f32(cfg.floor))


def _want(name: str, t: torch.Tensor, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} contiguous={t.is_contiguous()}")


def check_inputs(occ_words: torch.Tensor, o_rays: torch.Tensor, d_rays: torch.Tensor,
                 eps: Optional[torch.Tensor], frac: Optional[torch.Tensor], resolution: int,
                 num_samples: int):
    """Raise ``ValueError`` unless the inputs are what every version takes:
    the ``[G^3 // 32]`` int32 words, float32 ``o, d [N, 3]``, ``eps [N, 1]``
    (or None for the weights alone) and ``frac [N, S]`` or None, all
    contiguous and on one device."""
    n = o_rays.shape[0] if o_rays.dim() == 2 else -1
    _want("occ_words", occ_words, torch.int32, (resolution ** 3 // 32,))
    _want("o_rays", o_rays, torch.float32, (n, 3))
    _want("d_rays", d_rays, torch.float32, (n, 3))
    tensors = [occ_words, o_rays, d_rays]
    if eps is not None:
        _want("eps", eps, torch.float32, (n, 1))
        tensors.append(eps)
    if frac is not None:
        _want("frac", frac, torch.float32, (n, num_samples))
        tensors.append(frac)
    if any(t.device != o_rays.device for t in tensors):
        raise ValueError(f"inputs on several devices: {[str(t.device) for t in tensors]}")


def check_kernel_limits(consts: BinConstants, num_samples: int):
    """Raise ``ValueError`` for what the kernel does not take: more than 256
    bins or samples, no bins, a negative sample count or a negative floor
    (its weights-only mode is ``num_samples = 0``)."""
    if not 1 <= consts.num_bins <= MAX_BINS:
        raise ValueError(f"the sampler kernel takes 1 to {MAX_BINS} bins, got {consts.num_bins}")
    if not 0 <= num_samples <= MAX_SAMPLES:
        raise ValueError(f"the sampler kernel takes up to {MAX_SAMPLES} samples, "
                         f"got {num_samples}")
    if consts.floor < 0:
        raise ValueError(f"the sampler kernel takes a floor >= 0, got {consts.floor}")


def sample(occ_words: torch.Tensor, o_rays: torch.Tensor, d_rays: torch.Tensor,
           eps: Optional[torch.Tensor], frac: Optional[torch.Tensor], consts: BinConstants,
           num_samples: int, with_weights: bool = False,
           ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One launch of the sampler kernel on CUDA tensors: ``(samples [N, S,
    3], ts [N, S, 1], weights [N, B] or None)``; with ``num_samples = 0`` and
    ``eps = None`` only the weights (``(None, None, weights)``). ``frac``
    (in-bin jitter) or None picks the jitter or the exact CDF inverse."""
    global launches
    from minimal_nerf_torch.kernels import build

    if o_rays.device.type != "cuda":
        raise ValueError(f"the sampler kernel takes CUDA tensors, got {o_rays.device}")
    check_inputs(occ_words, o_rays, d_rays, eps, frac, consts.resolution, num_samples)
    check_kernel_limits(consts, num_samples)
    if (eps is None) != (num_samples == 0) or (num_samples == 0 and not with_weights):
        raise ValueError("eps is needed exactly when samples are asked for; "
                         "with no samples, ask for the weights")
    n, dev = o_rays.shape[0], o_rays.device
    s = num_samples
    ts = torch.empty((n, s, 1), dtype=torch.float32, device=dev) if s else None
    samples = torch.empty((n, s, 3), dtype=torch.float32, device=dev) if s else None
    weights = (torch.empty((n, consts.num_bins), dtype=torch.float32, device=dev)
               if with_weights else None)
    if n == 0:
        return samples, ts, weights
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = build.function(KERNEL, KERNEL, _ARGTYPES)
    with build.on_device(dev):
        rc = fn(occ_words.data_ptr(), occ_words.shape[0], consts.resolution, o_rays.data_ptr(),
                d_rays.data_ptr(), ptr(eps), ptr(frac), ptr(ts), ptr(samples), ptr(weights), n,
                consts.num_bins, s, consts.bound, consts.scale, consts.width, consts.near,
                consts.floor, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed with code {rc}")
    launches += 1
    return samples, ts, weights

