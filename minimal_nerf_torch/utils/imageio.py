"""Image IO: PNG write and animated-GIF write on uint8 ``[H, W, 3]`` arrays.

The port's own copy of ``minimal_nerf_tpu/utils/imageio.py``'s writers.
Uses the ``imageio`` package, else PIL; both are imported at first use, so
a machine without them can still import and render (``render_views``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np


def _backend():
    try:
        import imageio.v2 as iio

        return "imageio", iio
    except ImportError:
        pass
    try:
        from PIL import Image

        return "pil", Image
    except ImportError:
        raise ImportError("no image backend available (need imageio or PIL)") from None


def imwrite(path: str | Path, image: np.ndarray) -> None:
    """Write a ``[H, W, 3]`` uint8 image (format from the extension)."""
    image = np.asarray(image, dtype=np.uint8)
    kind, mod = _backend()
    if kind == "imageio":
        mod.imwrite(str(path), image)
    else:
        mod.fromarray(image).save(str(path))


def mimwrite(path: str | Path, frames: Sequence[np.ndarray], fps: float = 10.0) -> None:
    """Write an animated GIF from uint8 RGB frames (reference ``nerf_helpers.py:187``)."""
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    kind, mod = _backend()
    if kind == "imageio":
        mod.mimwrite(str(path), frames, duration=1000.0 / fps, loop=0)
    else:
        ims = [mod.fromarray(f) for f in frames]
        ims[0].save(str(path), save_all=True, append_images=ims[1:],
                    duration=int(1000.0 / fps), loop=0)
