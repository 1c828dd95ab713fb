"""The occupancy bin probe: one bit of the packed grid per probe.

Counterpart of ``minimal_nerf_tpu/kernels/occupancy_probe.py``. For linear
cell indices ``lin`` (int32, any shape) and the packed occupancy words
(``ops.occupancy.pack_occupancy``, ``[G^3 // 32]`` int32 holding the JAX
``uint32`` bit pattern) it returns ``(words[lin >> 5] >> (lin & 31)) & 1`` as
int32 0/1 in ``lin``'s shape. An index outside ``[0, 32 * n_words)`` gives 0,
as the TPU kernel's zero-padded table does; ``bin_cells`` clips its
indices, so the plain sampler never makes one. The main path no longer
launches this kernel: the fused sampler (``kernels/occupancy_sampler.py``)
probes through the same device function (``csrc/occupancy_common.cuh``).
This wrapper stays as the counterpart of the JAX public
``probe_bits_pallas``; the plain sampler reads its bits through
``probe_bits_plain``.

- ``probe_bits`` is the wrapper: for CUDA tensors it launches the
  hand-written kernel in ``csrc/occupancy_probe.cu`` (adding one to
  ``launches``); for CPU tensors it runs ``probe_bits_plain``, the same
  function in plain PyTorch. Any other device raises; there is no fallback.
- The TPU kernel resolves each word by a one-hot matmul against a u16 table
  (the TPU has no gather unit); on Hopper the gather is native, so the
  kernel reads the word directly. The probe has no gradient.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since the last reset
launches = 0

KERNEL = "occupancy_probe"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p]


def probe_bits_plain(occ_words: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the indexing expression, with an
    out-of-range index giving 0."""
    valid = (lin >= 0) & (lin < 32 * occ_words.shape[0])
    safe = torch.where(valid, lin, 0)
    words = occ_words[(safe >> 5).long()]
    return torch.where(valid, (words >> (safe & 31)) & 1, 0).to(torch.int32)


def _check(occ_words: torch.Tensor, lin: torch.Tensor):
    if occ_words.dtype != torch.int32 or occ_words.dim() != 1 or not occ_words.is_contiguous():
        raise ValueError(f"occ_words: expected contiguous 1-D int32, got {occ_words.dtype} "
                         f"{tuple(occ_words.shape)} contiguous={occ_words.is_contiguous()}")
    if lin.dtype != torch.int32 or not lin.is_contiguous():
        raise ValueError(f"lin: expected contiguous int32, got {lin.dtype} "
                         f"contiguous={lin.is_contiguous()}")
    if occ_words.device != lin.device:
        raise ValueError(f"occ_words on {occ_words.device}, lin on {lin.device}")
    if occ_words.shape[0] == 0:
        raise ValueError("occ_words is empty")


def _launch(occ_words: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    global launches
    from minimal_nerf_torch.kernels import build

    _check(occ_words, lin)
    bits = torch.empty_like(lin)
    if lin.numel() == 0:
        return bits
    fn = build.function(KERNEL, KERNEL, _ARGTYPES)
    with build.on_device(lin.device):
        stream = torch.cuda.current_stream(lin.device).cuda_stream
        rc = fn(occ_words.data_ptr(), occ_words.shape[0], lin.data_ptr(), bits.data_ptr(),
                lin.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed with code {rc}")
    launches += 1
    return bits


def probe_bits(occ_words: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """The occupancy bit (int32 0/1, ``lin``'s shape) of each index ``lin``.

    CUDA tensors go through the kernel, CPU tensors through the plain
    version; any other device raises.
    """
    if lin.device.type == "cuda":
        return _launch(occ_words, lin)
    if lin.device.type == "cpu":
        _check(occ_words, lin)
        return probe_bits_plain(occ_words, lin)
    raise ValueError(f"no occupancy probe implementation for device {lin.device}")
