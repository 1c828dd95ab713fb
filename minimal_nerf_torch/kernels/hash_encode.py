"""The multiresolution hash encoding's CUDA kernels and their autograd
``Function``.

``csrc/hash_encode_fwd.cu`` gathers each point's 8 corner rows on every
level and interpolates them (features ``[P, L * F]``); ``csrc/
hash_encode_bwd.cu`` adds each corner's ``weight * gradient`` into the
table's gradient with float2 atomic adds, one per run of neighbouring points
in one cell (no gradient to the positions). Neither replaces a TPU kernel:
the JAX package has no hash grid. The plain versions are
``ops.encoding.hash_encode_plain`` and ``hash_encode_backward_plain``.

- ``hash_encode(x01, table, levels)`` is the encoding as the ngp field
  calls it (``HashEncode``): on CUDA tensors the two kernels, one launch
  each way; on CPU tensors the plain versions, with no fallback from the
  card. It allocates only the features and the zeroed gradient, of sizes
  fixed by the shapes, reads no value on the host and is captured in the
  train step's CUDA graph.
- ``forward`` and ``backward`` are the single launches (``LAUNCHES_FWD``,
  ``LAUNCHES_BWD`` of ``utils.profiling`` count them); ``check_inputs``
  holds what every version takes.
- ``backward_counted`` launches the backward's counted kernel, which also
  counts the float2 adds it issued per level, and reads them back (a sync:
  tests and ``chip_smoke.py`` only); ``merged_share`` turns the counters
  into ``hash_encode_bwd.merged_share``, the share of the (point, level,
  corner) row updates that merging removed.
- The fp32 atomics make the table's gradient vary in its last bits from run
  to run; the forward is deterministic.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from minimal_nerf_torch.ops.encoding import (GridLevel, hash_encode_backward_plain,
                                             hash_encode_plain)
from minimal_nerf_torch.utils import profiling

LAUNCHES_FWD = "hash_encode_fwd.launches"
LAUNCHES_BWD = "hash_encode_bwd.launches"
# the counted backward's counters, per level (suffix ``.l<level>``): float2
# adds issued and (point, level, corner) row updates
REDS, ROW_UPDATES = "hash_encode_bwd.reds", "hash_encode_bwd.row_updates"
MERGED_SHARE = "hash_encode_bwd.merged_share"
FEATURES = 2  # the only feature width the kernels are built for (the paper's)
MAX_LEVELS = 32

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [
    ctypes.c_void_p] * 5


@functools.lru_cache(maxsize=16)
def _level_arrays(levels: Tuple[GridLevel, ...]):
    """The levels as the C arrays the kernels take (kept alive by the
    cache): resolutions, dense flags, hashed masks, offsets."""
    n = len(levels)
    return ((ctypes.c_int * n)(*[lv.resolution for lv in levels]),
            (ctypes.c_int * n)(*[int(lv.dense) for lv in levels]),
            (ctypes.c_uint * n)(*[0 if lv.dense else lv.size - 1 for lv in levels]),
            (ctypes.c_longlong * n)(*[lv.offset for lv in levels]))


def entries(levels: Tuple[GridLevel, ...]) -> int:
    return levels[-1].offset + levels[-1].size


def check_inputs(x01: torch.Tensor, table: torch.Tensor, levels: Tuple[GridLevel, ...]):
    """Raise ``ValueError`` unless ``x01`` is a contiguous fp32 ``[P, 3]``,
    ``table`` a contiguous fp32 ``[entries, 2]`` on the same device (F = 2,
    the only width the kernels take), with 1 to 32 levels whose hashed sizes
    are powers of two."""
    if x01.dtype != torch.float32 or x01.dim() != 2 or x01.shape[1] != 3 \
            or not x01.is_contiguous():
        raise ValueError(f"x01: expected contiguous float32 [P, 3], got {x01.dtype} "
                         f"{tuple(x01.shape)}")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous() \
            or table.shape[0] != entries(levels) or table.shape[1] != FEATURES:
        raise ValueError(f"table: expected contiguous float32 [{entries(levels)}, {FEATURES}], "
                         f"got {table.dtype} {tuple(table.shape)}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(levels)}")
    if any(not lv.dense and lv.size & (lv.size - 1) for lv in levels):
        raise ValueError("a hashed level's size must be a power of two")
    if x01.device != table.device:
        raise ValueError(f"inputs on several devices: {x01.device}, {table.device}")


def _launch(symbol: str, x01, src, dst, features: int, levels, counter: str,
            source: Optional[str] = None, extra: Tuple[int, ...] = ()) -> None:
    """One launch of the C function ``symbol`` of ``csrc/<source>.cu``
    (default: ``symbol``); the pointers ``extra`` follow the stream."""
    from minimal_nerf_torch.kernels import build

    n, dev = x01.shape[0], x01.device
    if n == 0:
        return
    fn = build.function(source or symbol, symbol, _ARGTYPES + [ctypes.c_void_p] * len(extra))
    res, dense, mask, offset = _level_arrays(levels)
    with build.on_device(dev):
        rc = fn(x01.data_ptr(), src.data_ptr(), dst.data_ptr(), n, features, len(levels), res,
                dense, mask, offset, torch.cuda.current_stream(dev).cuda_stream, *extra)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with code {rc}")
    profiling.count(counter)


def forward(x01: torch.Tensor, table: torch.Tensor,
            levels: Tuple[GridLevel, ...]) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors: ``[P, L * F]``."""
    if x01.device.type != "cuda":
        raise ValueError(f"the hash encoding kernel takes CUDA tensors, got {x01.device}")
    check_inputs(x01, table, levels)
    out = torch.empty((x01.shape[0], len(levels) * table.shape[1]), dtype=torch.float32,
                      device=x01.device)
    _launch("hash_encode_fwd", x01, table, out, table.shape[1], levels, LAUNCHES_FWD)
    return out


def _backward_inputs(x01, grad, table_shape, levels, out):
    if x01.device.type != "cuda":
        raise ValueError(f"the hash encoding kernel takes CUDA tensors, got {x01.device}")
    if out is None:
        out = torch.zeros(tuple(table_shape), dtype=torch.float32, device=x01.device)
    check_inputs(x01, out, levels)
    grad = grad.float().contiguous()
    if tuple(grad.shape) != (x01.shape[0], len(levels) * out.shape[1]):
        raise ValueError(f"grad: expected [{x01.shape[0]}, {len(levels) * out.shape[1]}], "
                         f"got {tuple(grad.shape)}")
    return grad, out


def backward(x01: torch.Tensor, grad: torch.Tensor, table_shape,
             levels: Tuple[GridLevel, ...], out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the backward kernel on CUDA tensors: the table's
    gradient ``table_shape`` (fp32) for the features' gradient ``grad [P,
    L * F]``, added into ``out`` (default: zeros; ``check_inputs`` holds
    it to the table's shape)."""
    grad, out = _backward_inputs(x01, grad, table_shape, levels, out)
    _launch("hash_encode_bwd", x01, grad, out, out.shape[1], levels, LAUNCHES_BWD)
    return out


def backward_counted(x01: torch.Tensor, grad: torch.Tensor, table_shape,
                     levels: Tuple[GridLevel, ...]):
    """``backward`` through the counted kernel: ``(table's gradient, float2
    adds issued per level)``. Adds those to the counters ``REDS.l<level>``
    and the launch's ``P * 8`` row updates a level to ``ROW_UPDATES.l<level>``
    (see ``merged_share``); reads the device's counts back, so it waits for
    the card and cannot be captured."""
    grad, out = _backward_inputs(x01, grad, table_shape, levels, None)
    reds = torch.zeros(len(levels), dtype=torch.int64, device=x01.device)
    _launch("hash_encode_bwd_counted", x01, grad, out, out.shape[1], levels, LAUNCHES_BWD,
            "hash_encode_bwd", (reds.data_ptr(),))
    issued = [int(r) for r in reds.tolist()]
    for lv, r in enumerate(issued):
        profiling.count(f"{REDS}.l{lv}", r)
        profiling.count(f"{ROW_UPDATES}.l{lv}", 8 * x01.shape[0])
    return out, issued


def merged_share(levels: int) -> Dict[str, float]:
    """``MERGED_SHARE`` from the counters of the counted launches since the
    last ``profiling.reset()``: ``1 - adds issued / row updates`` on each
    level (``"l0"``, ``"l1"``, ...) and over all ``levels`` (``"all"``); a
    level with no updates counted is left out."""
    share, reds, rows = {}, 0, 0
    for lv in range(levels):
        r, u = profiling.counter(f"{REDS}.l{lv}"), profiling.counter(f"{ROW_UPDATES}.l{lv}")
        if u:
            share[f"l{lv}"] = 1.0 - r / u
            reds, rows = reds + r, rows + u
    if rows:
        share["all"] = 1.0 - reds / rows
    return share


class HashEncode(torch.autograd.Function):
    """``hash_encode`` with its table gradient: the kernels on a CUDA
    device, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x01, table, levels):
        ctx.save_for_backward(x01)
        ctx.levels, ctx.table_shape = levels, tuple(table.shape)
        if x01.device.type == "cuda":
            return forward(x01, table, levels)
        if x01.device.type != "cpu":
            raise ValueError(f"no hash encoding for device {x01.device}")
        check_inputs(x01, table, levels)
        return hash_encode_plain(x01, table, levels)

    @staticmethod
    def backward(ctx, grad):
        (x01,) = ctx.saved_tensors
        if x01.device.type == "cuda":
            return None, backward(x01, grad, ctx.table_shape, ctx.levels), None
        return None, hash_encode_backward_plain(x01, grad, ctx.table_shape[0], ctx.levels), None


def hash_encode(x01: torch.Tensor, table: torch.Tensor,
                levels: Tuple[GridLevel, ...]) -> torch.Tensor:
    """The hash encoding ``[P, L * F]`` of ``x01 [P, 3]`` in ``[0, 1]``,
    through the kernels on a card (``HashEncode``)."""
    return HashEncode.apply(x01.contiguous(), table, levels)
