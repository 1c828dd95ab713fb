"""Reference-shaped helper facade.

Counterpart of ``minimal_nerf_tpu/nerf_helpers.py``: the port's rendering
math re-exported under the reference's ``nerf_helpers`` names (reference
``nerf_helpers.py``), so a user of the original finds every function where
they expect it. Differences, documented rather than hidden:

- sampling functions take a ``torch.Generator`` or pre-drawn uniforms
  instead of the global torch RNG and device;
- ``view_reconstruction`` and ``generate_360_view_synthesis`` accept a
  ``models.nerf.NeRFNetwork`` wrapper or a raw ``render_chunk`` callable
  ``(o, d, generator) -> rgb``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from minimal_nerf_torch import views as _views
from minimal_nerf_torch.ops.cameras import (  # noqa: F401
    convert_to_ndc_rays,
    get_rays,
    pose_spherical,
    spherical_poses,
)
from minimal_nerf_torch.ops.rendering import (  # noqa: F401
    calculate_unnormalized_weights,
    estimate_ray_color,
    generate_coarse_samples,
    generate_deltas,
    inverse_transform_sampling,
    union_and_sort_ts,
)

photo_nerf_to_image = _views.photo_nerf_to_image
generate_360_view_synthesis = _views.generate_360_view_synthesis


def fix_batchify(batch: Dict) -> None:
    """Squeeze a leading singleton batch axis in place (reference
    ``nerf_helpers.py:18-26``)."""
    for key, value in batch.items():
        batch[key] = value.squeeze(0) if hasattr(value, "squeeze") else value


def torch_to_numpy(tensor, is_normalized_image: bool = False) -> np.ndarray:
    """A tensor or array as numpy for plotting (reference
    ``nerf_helpers.py:240-251``): a ``...CHW`` layout (ndim >= 4) moved to
    ``...HWC``, a normalized image optionally rescaled to [0, 255]."""
    if hasattr(tensor, "detach"):
        arr = tensor.detach().cpu().clone().numpy()
    else:
        arr = np.array(tensor)
    if arr.ndim >= 4:
        arr = np.moveaxis(arr, [-3, -2, -1], [-1, -3, -2])
    if is_normalized_image:
        arr = np.clip(arr * 255, 0, 255)
    return arr


def view_reconstruction(model, all_o_rays, all_d_rays, N: int = 4096) -> np.ndarray:
    """Reference-signature view reconstruction (``nerf_helpers.py:189-210``):
    ``model`` is a ``models.nerf.NeRFNetwork`` (or any object whose
    ``forward(o, d, generator)`` returns ``{"fine_rgb_rays": ...}``) or a
    ``render_chunk(o, d, generator)``; returns ``[H, W, 3]`` uint8."""
    if callable(model) and not hasattr(model, "forward"):
        render_chunk = model
    else:
        def render_chunk(o, d, generator):
            return model.forward(o, d, generator)["fine_rgb_rays"]

    return _views.view_reconstruction(render_chunk, all_o_rays, all_d_rays, chunk=N)
