"""Input encodings: the positional (Fourier-feature) encoding of the NeRF
MLP, and Instant-NGP's multiresolution hash encoding and spherical
harmonics (``models/ngp.py``).

The positional encoding is the counterpart of
``minimal_nerf_tpu/ops/encoding.py``. The layout is frequency-major with cos
before sin: for each octave ``i`` the output holds ``cos(2**i * pi * x)``
over all C input channels, then ``sin(...)`` over all C channels, giving
``2 * dim * C`` channels.

The hash encoding (Mueller et al., SIGGRAPH 2022, sec. 3) has no
counterpart in the JAX package. ``grid_levels`` lays out the levels of one
table; ``hash_encode_plain`` is its plain PyTorch version (indexing, whose
gradient autograd takes), the route of ``--kernel xla`` and the oracle of
the CUDA kernels ``kernels/hash_encode.py``, whose CPU dispatch takes
``hash_encode_backward_plain`` (``index_add_``) for the table's gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


def positional_encoding(x: torch.Tensor, dim: int = 10) -> torch.Tensor:
    """Encode ``x [..., C]`` with ``dim`` octaves -> ``[..., 2 * dim * C]``."""
    c = x.shape[-1]
    freqs = (2.0 ** torch.arange(dim, dtype=x.dtype, device=x.device)) * math.pi
    angles = x[..., None, :] * freqs[:, None]  # [..., dim, C]
    enc = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-2)
    return enc.reshape(*x.shape[:-1], 2 * dim * c)


def normalize_coordinates(x: torch.Tensor, bound: float = math.pi) -> torch.Tensor:
    """Scale coordinates from ``[-bound, bound]`` into ``[-1, 1]``."""
    return x / bound


# ---------------------------------------------------------------- hash grid

# the spatial hash's primes (sec. 3): xor(x * 1, y * 2654435761, z * 805459861)
HASH_PRIMES = (1, 2654435761, 805459861)


class GridLevel(NamedTuple):
    """One level of a hash grid: ``resolution`` cells per axis (so
    ``resolution + 1`` vertices), its first entry ``offset`` in the table,
    its ``size`` in entries, and whether it is ``dense`` (its vertices
    indexed one to one) or hashed into ``size`` entries (a power of two)."""

    resolution: int
    offset: int
    size: int
    dense: bool


def grid_levels(levels: int, log2_table: int, min_resolution: int,
                max_resolution: int) -> Tuple[GridLevel, ...]:
    """The levels of one table: ``N_l = floor(N_min * (N_max / N_min)^(l /
    (L - 1)))``, the paper's geometric growth ``b = exp(ln(N_max / N_min) /
    (L - 1))`` written so that the last level is ``N_max`` exactly; a level
    whose ``(N_l + 1)^3`` vertices fit ``2^log2_table`` entries is dense and
    takes that many, every other level ``2^log2_table``."""
    t = 1 << log2_table
    out, offset = [], 0
    for lv in range(levels):
        frac = lv / (levels - 1) if levels > 1 else 0.0
        res = int(math.floor(min_resolution * (max_resolution / min_resolution) ** frac))
        dense = (res + 1) ** 3 <= t
        size = (res + 1) ** 3 if dense else t
        out.append(GridLevel(res, offset, size, dense))
        offset += size
    return tuple(out)


def grid_index(corner: torch.Tensor, level: GridLevel) -> torch.Tensor:
    """The entry of level ``level`` (its own index, before its offset) of
    the integer vertices ``corner [..., 3]``: ``x + (N + 1) (y + (N + 1) z)``
    on a dense level, else the spatial hash modulo the level's size. The
    products are taken in int64, whose low bits are those of the uint32
    products the hash is defined on."""
    x, y, z = corner.unbind(-1)
    if level.dense:
        n1 = level.resolution + 1
        return x + n1 * (y + n1 * z)
    p0, p1, p2 = HASH_PRIMES
    return ((x * p0) ^ (y * p1) ^ (z * p2)) & (level.size - 1)


def grid_cell(x01: torch.Tensor, level: GridLevel) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cell ``[P, 3]`` (int64) and the place in it ``[P, 3]`` of points
    ``x01 [P, 3]`` in ``[0, 1]``: ``pos = x * N``, the cell ``floor(pos)``
    clamped to ``N - 1`` (a point on the box's far face lies at the far
    side of the last cell), the place ``pos - cell``."""
    pos = x01 * float(level.resolution)
    cell = torch.clamp(torch.floor(pos), max=float(level.resolution - 1))
    return cell.long(), pos - cell


def corner_weight(frac: torch.Tensor, c: int) -> torch.Tensor:
    """The trilinear weight ``[P]`` of corner ``c`` (bit ``a`` of ``c`` set:
    the far vertex along axis ``a``): the product of ``frac`` or ``1 -
    frac`` over x, y, z in that order."""
    w = [frac[:, a] if (c >> a) & 1 else 1.0 - frac[:, a] for a in range(3)]
    return w[0] * w[1] * w[2]


def _corners(device) -> torch.Tensor:
    return torch.tensor([[(c >> a) & 1 for a in range(3)] for c in range(8)],
                        dtype=torch.int64, device=device)


def grid_corners(x01: torch.Tensor,
                 levels: Tuple[GridLevel, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table rows ``[P, L, 8]`` (int64, offsets included) and trilinear
    weights ``[P, L, 8]`` of the 8 corners of each point's cell on every
    level."""
    bits = _corners(x01.device)
    rows, weights = [], []
    for level in levels:
        cell, frac = grid_cell(x01, level)
        rows.append(torch.stack([level.offset + grid_index(cell + bits[c], level)
                                 for c in range(8)], dim=-1))
        weights.append(torch.stack([corner_weight(frac, c) for c in range(8)], dim=-1))
    return torch.stack(rows, dim=1), torch.stack(weights, dim=1)


def hash_encode_plain(x01: torch.Tensor, table: torch.Tensor,
                      levels: Tuple[GridLevel, ...]) -> torch.Tensor:
    """The multiresolution hash encoding of points ``x01 [P, 3]`` in ``[0,
    1]`` from ``table [entries, F]``: per level the trilinear interpolation
    of its cell's 8 corner entries, summed over the corners in order ``c =
    0 .. 7``; ``[P, L * F]``, level-major. Plain PyTorch indexing, one
    gather of every corner row: autograd takes the table's gradient (an
    accumulating scatter)."""
    rows, weights = grid_corners(x01, levels)
    p, n = rows.shape[0], len(levels)
    vals = table[rows.reshape(-1)].reshape(p, n, 8, table.shape[1])
    acc = weights[:, :, 0, None] * vals[:, :, 0]
    for c in range(1, 8):
        acc = acc + weights[:, :, c, None] * vals[:, :, c]
    return acc.reshape(p, n * table.shape[1])


def hash_encode_backward_plain(x01: torch.Tensor, grad: torch.Tensor, entries: int,
                               levels: Tuple[GridLevel, ...]) -> torch.Tensor:
    """The table's gradient ``[entries, F]`` (fp32) of ``hash_encode_plain``
    for the features' gradient ``grad [P, L * F]``: each corner's ``weight
    * grad`` added into its entry with one ``index_add_``."""
    rows, weights = grid_corners(x01, levels)
    p, n = rows.shape[0], len(levels)
    g = grad.float().reshape(p, n, 1, -1)
    out = torch.zeros((entries, g.shape[-1]), dtype=torch.float32, device=x01.device)
    return out.index_add_(0, rows.reshape(-1), (weights[..., None] * g).reshape(-1, g.shape[-1]))


# ------------------------------------------------------ spherical harmonics

def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """The real spherical harmonics of unit directions ``d [..., 3]`` up to
    band ``degree - 1``: ``[..., degree^2]`` (16 at degree 4), with
    tiny-cuda-nn's constants and signs (the encoding Instant-NGP's color
    network reads, sec. 5.4)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"spherical harmonics of degree 1 to 4, got {degree}")
    x, y, z = d.unbind(-1)
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree > 2:
        xy, yz, xz, x2, y2, z2 = x * y, y * z, x * z, x * x, y * y, z * z
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * xz,
                0.54627421529603959 * x2 - 0.54627421529603959 * y2]
    if degree > 3:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, dim=-1)
