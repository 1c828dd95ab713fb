"""Plain PyTorch reference of Instant-NGP's NeRF field (Mueller, Evans,
Schied, Keller, Instant Neural Graphics Primitives with a Multiresolution
Hash Encoding, SIGGRAPH 2022, arXiv:2201.05989), as a ``reference.nerf.Field``.

Written from the paper and the configuration file (``configs/<name>.json``,
its ``ngp`` group), independent of the package under test: it imports
neither it nor JAX. The draws, the sampling, the sorted union, the
compositing, the loss and the train steps are ``reference/nerf.py``'s, as
they are; this file gives the field and its optimizer:

- the encoding (sec. 3): ``L`` levels of resolution ``N_l = floor(N_min
  b^l)``, ``b = (N_max / N_min)^(1 / (L - 1))``; a point ``x`` of the
  occupancy grid's box ``[-bound, bound]^3`` enters as ``(x + bound) / (2
  bound)`` clamped to ``[0, 1]``, scaled by ``N_l``; its cell's 8 vertices
  ``floor(x N_l)`` and ``+1`` (the last cell taking a point on the far
  face) are looked up in the level's ``T = 2^log2_table`` entries through
  the spatial hash ``xor(x * 1, y * 2654435761, z * 805459861) mod T``, or
  one to one on a level whose ``(N_l + 1)^3`` vertices fit ``T``; the F
  features of each level are the trilinear interpolation of its 8 entries;
- the density MLP (sec. 5.4): the ``L F`` features -> 64 (ReLU) -> 16
  (linear), the first output the log-density, density ``exp``;
- the color MLP: the 16 density outputs beside the 16 real spherical
  harmonics of the unit view direction (degree 4, tiny-cuda-nn's constants)
  -> 64 -> 64 (ReLU) -> 3, a sigmoid;
- the optimizer (sec. 4): Adam, ``b1 = 0.9``, ``b2 = 0.99``, ``eps =
  1e-15``; a table entry whose gradient is exactly 0 keeps its value and
  moments (the paper's sparse update of the table); ``1e-6 w`` (L2) added to
  each MLP weight's gradient.

In float32 with TF32 off (the caller's ``reference.nerf.exact_float32``).
``Numerics`` set the MLPs' matmul inputs (``"fp32"``, or the control's
``"fp8"``, ``reference.nerf.matmul``) and a rounding of the gathered
features (the control's ``"bf16"``).

Departures from the paper and from instant-ngp, each as the configuration's
``assumed`` states:

- no MLP biases (tiny-cuda-nn's fully fused MLP has none);
- the table in fp32 (tiny-cuda-nn keeps fp16 copies);
- the corners of the paper's ``floor(x N_l)`` (tiny-cuda-nn offsets each
  level by half a cell) and its ``N_l`` (tiny-cuda-nn's grows differently);
- the density ``exp`` without instant-ngp's truncated gradient;
- the sampling of the repo's fast recipe: a 64^3 occupancy grid and 16 + 48
  hierarchical samples through the same field in both passes, in place of
  instant-ngp's cascaded 128^3 grid and fixed-step marching; the loss the
  repo's summed coarse and fine MSE (instant-ngp: Huber on one pass);
- the learning rate 1e-2 of instant-ngp's ``configs/nerf/base.json`` under
  the repo's per-epoch decay, and no EMA of the weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from nerfbench.reference import nerf as R

PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class Numerics:
    matmul: str = "fp32"            # "fp32" or "fp8"
    features: Optional[str] = None  # rounding of the gathered features: None or "bf16"


def levels(ngp: Dict[str, Any]) -> List[Tuple[int, int, int, bool]]:
    """``(N_l, offset, size, dense)`` of every level of one table."""
    t = 1 << ngp["log2_table"]
    n_min, n_max, count = ngp["min_resolution"], ngp["max_resolution"], ngp["levels"]
    out, offset = [], 0
    for lv in range(count):
        n = int(math.floor(n_min * (n_max / n_min) ** (lv / (count - 1) if count > 1 else 0.0)))
        dense = (n + 1) ** 3 <= t
        size = (n + 1) ** 3 if dense else t
        out.append((n, offset, size, dense))
        offset += size
    return out


def entries(ngp: Dict[str, Any]) -> int:
    n, offset, size, _ = levels(ngp)[-1]
    return offset + size


def vertex_index(v: torch.Tensor, n: int, size: int, dense: bool) -> torch.Tensor:
    """A level's entry of the integer vertices ``v [..., 3]``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if dense:
        return x + (n + 1) * y + (n + 1) ** 2 * z
    return torch.bitwise_xor(torch.bitwise_xor(x * PRIMES[0], y * PRIMES[1]),
                             z * PRIMES[2]) % size


def encode(x01: torch.Tensor, table: torch.Tensor, ngp: Dict[str, Any]) -> torch.Tensor:
    """The hash encoding ``[P, L * F]`` of ``x01 [P, 3]`` in ``[0, 1]``:
    every level's corner rows gathered at once, the 8 weighted rows of a
    level summed in corner order."""
    rows, weights = [], []
    for n, offset, size, dense in levels(ngp):
        pos = x01 * float(n)
        cell = torch.clamp(torch.floor(pos), max=float(n - 1))
        frac = pos - cell
        cell = cell.long()
        for c in range(8):
            bit = [(c >> a) & 1 for a in range(3)]
            v = cell + torch.tensor(bit, device=x01.device)
            w = 1.0
            for a in range(3):
                w = w * (frac[:, a] if bit[a] else 1.0 - frac[:, a])
            rows.append(offset + vertex_index(v, n, size, dense))
            weights.append(w)
    p, count, f = x01.shape[0], ngp["levels"], table.shape[1]
    vals = table[torch.stack(rows, dim=1).reshape(-1)].reshape(p, count, 8, f)
    w = torch.stack(weights, dim=1).reshape(p, count, 8, 1)
    feat = w[:, :, 0] * vals[:, :, 0]
    for c in range(1, 8):
        feat = feat + w[:, :, c] * vals[:, :, c]
    return feat.reshape(p, count * f)


def spherical_harmonics(d: torch.Tensor) -> torch.Tensor:
    """The 16 real spherical harmonics of bands 0-3 of unit ``d [..., 3]``."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * x * z,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], dim=-1)


def mlp(weights, x: torch.Tensor, how: str) -> torch.Tensor:
    """ReLU layers without biases, the last one linear."""
    for i, w in enumerate(weights):
        x = R.matmul(x, w, how)
        if i < len(weights) - 1:
            x = torch.relu(x)
    return x


def _features(params, x: torch.Tensor, cfg: Dict, num: Numerics) -> torch.Tensor:
    bound = cfg["occupancy"]["bound"]
    x01 = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)
    f = encode(x01, params["table"], cfg["ngp"])
    return f.to(torch.bfloat16).float() if num.features == "bf16" else f


@dataclasses.dataclass(frozen=True)
class SparseAdam(R.Adam):
    """Instant-NGP's Adam over ``reference.nerf.leaves``' order: ``l2 * p``
    added to the gradient of the leaves ``l2_leaves``; an element of the
    leaves ``sparse_leaves`` whose gradient is exactly 0 keeps its value and
    moments."""
    l2: float = 0.0
    l2_leaves: Tuple[int, ...] = ()
    sparse_leaves: Tuple[int, ...] = ()

    @torch.no_grad()
    def apply(self, ps, mu, nu, lr, count: int) -> None:
        dev = lr.device
        bc1 = (1 - torch.tensor(self.b1) ** (count + 1)).to(dev)
        bc2 = (1 - torch.tensor(self.b2) ** (count + 1)).to(dev)
        for i, (p, m, v) in enumerate(zip(ps, mu, nu)):
            g = p.grad
            if i in self.l2_leaves:
                g = g + self.l2 * p
            keep = (g == 0) if i in self.sparse_leaves else None
            m_new = self.b1 * m + (1 - self.b1) * g
            v_new = self.b2 * v + (1 - self.b2) * g * g
            p_new = p - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            if keep is not None:
                m_new, v_new, p_new = (torch.where(keep, old, new) for old, new in
                                       ((m, m_new), (v, v_new), (p, p_new)))
            m.copy_(m_new)
            v.copy_(v_new)
            p.copy_(p_new)
            p.grad = None


def adam(cfg: Dict) -> SparseAdam:
    """The field's Adam on its tree ``{"color": [...], "density": [...],
    "table"}``: sorted, the MLP weights come first and the table last."""
    mlp_leaves = cfg["ngp"]["color_layers"] + 1 + 2
    return SparseAdam(b1=0.9, b2=0.99, eps=1e-15, l2=1e-6, l2_leaves=tuple(range(mlp_leaves)),
                      sparse_leaves=(mlp_leaves,))


def ngp_field(cfg: Dict) -> R.Field:
    """The field of ``cfg["ngp"]``, the same in both passes."""
    def point(params, which, x, d, num: Numerics):
        lead = x.shape[:-1]
        h = mlp(params["density"], _features(params, x.reshape(-1, 3), cfg, num), num.matmul)
        dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        sh = spherical_harmonics(dn)[:, None, :].expand(*lead, 16).reshape(-1, 16)
        rgb = torch.sigmoid(mlp(params["color"], torch.cat([h, sh], dim=-1), num.matmul))
        return torch.exp(h[:, 0]).reshape(lead), rgb.reshape(*lead, 3)

    def density(params, x, num: Numerics):
        return torch.exp(mlp(params["density"], _features(params, x, cfg, num), num.matmul)[:, 0])

    return R.Field(samples=cfg["ngp"], point=point, density=density, adam=adam(cfg))


def reference_numerics(cfg: Dict) -> Numerics:
    """fp32 matmuls and features: the check holds the program's bf16 matmul
    inputs (the configuration's precision) to fp32."""
    return Numerics("fp32", None)


def control_numerics(cfg: Dict) -> Numerics:
    """The control, one step below the configuration's bf16: fp8 matmul
    inputs (e4m3, e5m2 for gradients) and the gathered features rounded to
    bf16."""
    return Numerics("fp8", "bf16")
