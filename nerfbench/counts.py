"""Operation counts of the NeRF MLP, worked out from its widths.

A copy of ``chip_smoke.py::macs_per_point`` (the forward) beside the model's
backward work. Every count is multiply-adds per sample point of one MLP
evaluation; a FLOP count is twice that.

- ``fwd_macs``: every layer's ``in x out`` (460,416 at the published
  widths, encodings of 10 and 4 octaves, width 256, color branch 128, and
  the package's depth: 4 trunk layers, the skip layer, 2 more).
- ``bwd_macs``: the backward as a model needs it, without recomputing the
  forward: every layer's weight gradient (``in x out`` again) plus the
  activation gradient of every layer whose input is not an encoding (the
  first trunk layer reads only the position encoding, the skip layer and
  the color layer read an encoding beside a hidden vector: their encoding
  rows need no gradient). 887,040 at the published widths.
- ``kernel_bwd_macs``: what the fused backward kernels execute, which adds
  one recomputed forward: ``chip_smoke.py::bwd_macs_per_point``, 1,347,456.
"""

from __future__ import annotations

from typing import Dict


def layers(nerf: Dict):
    """``(name, in, out, encoding rows)`` of every matmul of one MLP."""
    pe, de = 6 * nerf["position_dim"], 6 * nerf["direction_dim"]
    h, r = nerf["width"], nerf["rgb_width"]
    trunk = [("trunk0", pe, h, pe)] + [(f"trunk{i}", h, h, 0)
                                        for i in range(1, nerf["trunk_layers"])]
    feature = [("feature0", h + pe, h, pe)] + [(f"feature{i}", h, h, 0)
                                              for i in range(1, nerf["feature_layers"])]
    return trunk + feature + [("density", h, 1, 0), ("rgb0", h + de, r, de), ("rgb1", r, 3, 0)]


def fwd_macs(nerf: Dict) -> int:
    return sum(i * o for _, i, o, _ in layers(nerf))


def bwd_macs(nerf: Dict) -> int:
    wgrad = fwd_macs(nerf)
    agrad = sum((i - enc) * o for _, i, o, enc in layers(nerf))
    return wgrad + agrad


def kernel_bwd_macs(nerf: Dict) -> int:
    return bwd_macs(nerf) + fwd_macs(nerf)


def points_per_ray(nerf: Dict) -> int:
    """Points evaluated per ray: the coarse pass and the sorted union of
    coarse and fine samples in the fine pass."""
    return nerf["coarse_samples"] + (nerf["coarse_samples"] + nerf["fine_samples"])


def train_flops_per_ray(nerf: Dict) -> int:
    return 2 * (fwd_macs(nerf) + bwd_macs(nerf)) * points_per_ray(nerf)


def render_flops_per_ray(nerf: Dict) -> int:
    return 2 * fwd_macs(nerf) * points_per_ray(nerf)
