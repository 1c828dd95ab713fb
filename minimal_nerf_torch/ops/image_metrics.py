"""PSNR and SSIM image metrics (scikit-image compatible), in numpy and in torch.

Counterpart of ``minimal_nerf_tpu/ops/image_metrics.py``. Both versions use
skimage's defaults for scoring (``score.py`` of the reference):

- PSNR: ``10 * log10(data_range**2 / mse)`` over the whole image, float64;
  identical images give ``inf``.
- SSIM: a uniform 7x7 window (``gaussian_weights=False``), ``K1 = 0.01``,
  ``K2 = 0.03``, the sample covariance (``NP / (NP - 1)``), means over the
  valid windows only (the ``(win_size - 1) // 2`` border skimage crops),
  channels averaged last; ``data_range`` is 255 for uint8 images.

``peak_signal_noise_ratio`` and ``structural_similarity`` are the JAX
package's numpy functions, copied: the plain version, which the tests hold
against the JAX module's golden values. ``psnr`` and ``ssim`` compute the
same scalars in torch, in float64 on the tensors' device, and return 0-d
tensors there, so that a caller can sum them over frames without waiting
for the device. Their window means come from ``F.avg_pool2d`` over the
valid windows (49 terms each), not from a summed-area table, whose large
prefix sums would cancel at 800x800 for images that are not integers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_K1, _K2 = 0.01, 0.03


def peak_signal_noise_ratio(
    image_true: np.ndarray, image_test: np.ndarray, data_range: float | None = None
) -> float:
    """PSNR in dB between two images (skimage-compatible).

    Args:
        image_true/image_test: arrays of identical shape.
        data_range: value range; inferred as 255 for uint8 inputs.
    """
    if data_range is None:
        if image_true.dtype == np.uint8:
            data_range = 255.0
        else:
            data_range = float(image_true.max() - image_true.min())
    err = np.mean(
        (image_true.astype(np.float64) - image_test.astype(np.float64)) ** 2
    )
    with np.errstate(divide="ignore"):  # identical images -> inf, like skimage
        return float(10.0 * np.log10((data_range**2) / err))


def _box_filter(img: np.ndarray, win: int) -> np.ndarray:
    """``win x win`` window means of a ``[H, W]`` float64 image over the
    valid region, ``[H - win + 1, W - win + 1]``, from a summed-area table."""
    pad = np.zeros((img.shape[0] + 1, img.shape[1] + 1), dtype=np.float64)
    np.cumsum(np.cumsum(img, axis=0), axis=1, out=pad[1:, 1:])
    s = (
        pad[win:, win:]
        - pad[:-win, win:]
        - pad[win:, :-win]
        + pad[:-win, :-win]
    )
    return s / (win * win)


def _ssim_channel(
    x: np.ndarray, y: np.ndarray, data_range: float, win_size: int
) -> float:
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    np_pix = win_size * win_size
    cov_norm = np_pix / (np_pix - 1)  # sample covariance

    ux = _box_filter(x, win_size)
    uy = _box_filter(y, win_size)
    uxx = _box_filter(x * x, win_size)
    uyy = _box_filter(y * y, win_size)
    uxy = _box_filter(x * y, win_size)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (_K1 * data_range) ** 2
    c2 = (_K2 * data_range) ** 2

    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    # the valid box filter already leaves out the border skimage crops
    return float(s.mean())


def _check_pair(im1, im2, data_range, uint8: bool):
    if tuple(im1.shape) != tuple(im2.shape):
        raise ValueError(f"shape mismatch: {tuple(im1.shape)} vs {tuple(im2.shape)}")
    if data_range is None:
        if uint8:
            return 255.0
        raise ValueError("data_range must be given for non-uint8 images")
    return data_range


def structural_similarity(
    im1: np.ndarray,
    im2: np.ndarray,
    data_range: float | None = None,
    win_size: int = 7,
    multichannel: bool = True,
) -> float:
    """Mean SSIM between two ``[H, W]`` or ``[H, W, C]`` images of the same
    dtype and shape (skimage-compatible defaults; ``multichannel`` averages
    the per-channel SSIMs of a 3-d image)."""
    data_range = _check_pair(im1, im2, data_range, im1.dtype == np.uint8)
    if multichannel and im1.ndim == 3:
        return float(
            np.mean(
                [
                    _ssim_channel(im1[..., c], im2[..., c], data_range, win_size)
                    for c in range(im1.shape[-1])
                ]
            )
        )
    return _ssim_channel(im1, im2, data_range, win_size)


def psnr(image_true: torch.Tensor, image_test: torch.Tensor,
         data_range: float | None = None) -> torch.Tensor:
    """``peak_signal_noise_ratio`` in torch: a 0-d float64 tensor on the
    images' device (``inf`` for identical images); a shape mismatch raises."""
    if tuple(image_true.shape) != tuple(image_test.shape):
        raise ValueError(f"shape mismatch: {tuple(image_true.shape)} vs "
                         f"{tuple(image_test.shape)}")
    if data_range is None:
        if image_true.dtype == torch.uint8:
            data_range = 255.0
        else:
            data_range = (image_true.max() - image_true.min()).double()
    err = torch.mean((image_true.double() - image_test.double()) ** 2)
    return 10.0 * torch.log10((data_range ** 2) / err)


def ssim(im1: torch.Tensor, im2: torch.Tensor, data_range: float | None = None,
         win_size: int = 7, multichannel: bool = True) -> torch.Tensor:
    """``structural_similarity`` in torch: a 0-d float64 tensor on the
    images' device, the mean over channels of each channel's mean SSIM."""
    data_range = _check_pair(im1, im2, data_range, im1.dtype == torch.uint8)
    if not (multichannel and im1.dim() == 3):
        return _ssim_channels(im1[None], im2[None], data_range, win_size)[0]
    return _ssim_channels(im1.movedim(-1, 0), im2.movedim(-1, 0), data_range,
                          win_size).mean()


def _ssim_channels(x: torch.Tensor, y: torch.Tensor, data_range: float,
                   win_size: int) -> torch.Tensor:
    """Mean SSIM of each of ``C`` channel pairs ``[C, H, W]`` -> ``[C]``."""
    x, y = x.double()[:, None], y.double()[:, None]
    np_pix = win_size * win_size
    cov_norm = np_pix / (np_pix - 1)
    ux, uy, uxx, uyy, uxy = F.avg_pool2d(
        torch.cat([x, y, x * x, y * y, x * y], dim=1), win_size, stride=1).unbind(1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (_K1 * data_range) ** 2
    c2 = (_K2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(-2, -1))
