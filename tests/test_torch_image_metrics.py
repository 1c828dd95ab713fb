"""The port's PSNR/SSIM (its numpy copy and its torch version on the CPU)
against ``minimal_nerf_tpu.ops.image_metrics`` on seeded uint8 pairs, and
against that module's golden values (``tests/test_image_metrics.py``).

Tolerances: the numpy copy runs the JAX module's arithmetic, so it must
agree to rtol 1e-12. The torch version sums the same integer-valued window
terms (exact in float64) but takes the final means in another order; it
must agree to rtol 1e-12 as well, inside the bound of 1e-9 that scoring
allows (measured here: equal at these sizes, 2.2e-16 at 800x800)."""

import numpy as np
import pytest
import torch

from minimal_nerf_torch.ops import image_metrics as t_im
from minimal_nerf_tpu.ops import image_metrics as j_im

RTOL = 1e-12


def _pair(shape, seed, noise=20):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-noise, noise + 1, shape), 0, 255).astype(np.uint8)
    return a, b


def _golden_inputs():
    """The inputs of ``test_image_metrics.py::test_metric_golden_anchors``."""
    rng = np.random.default_rng(42)
    y, x = np.mgrid[0:48, 0:48]
    base = np.stack([(x * 5) % 256, (y * 3) % 256, ((x + y) * 2) % 256], -1).astype(np.uint8)
    noisy = np.clip(base.astype(int) + rng.integers(-15, 16, base.shape), 0, 255).astype(
        np.uint8)
    a2 = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    b2 = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    g1 = ((np.sin(x / 4) * 80) + 128).astype(np.uint8)
    g2 = ((np.sin(x / 4 + 0.3) * 80) + 128).astype(np.uint8)
    return base, noisy, a2, b2, g1, g2


GOLDEN = {  # name -> (metric, images, multichannel, frozen value)
    "ssim_rgb": ("ssim", (0, 1), True, 0.6642650912664754),
    "ssim_random": ("ssim", (2, 3), True, 0.013683007831055735),
    "ssim_gray": ("ssim", (4, 5), False, 0.8613236112704232),
    "psnr_rgb": ("psnr", (0, 1), True, 29.16017532906581),
    "psnr_random": ("psnr", (2, 3), True, 7.820246768797952),
}


@pytest.mark.parametrize("shape,seed", [((7, 7), 0), ((40, 40, 3), 1), ((48, 48, 3), 2),
                                        ((33, 29), 3)])
def test_metrics_match_jax(shape, seed):
    a, b = _pair(shape, seed)
    multichannel = len(shape) == 3
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want_ssim = j_im.structural_similarity(a, b, multichannel=multichannel)
    want_psnr = j_im.peak_signal_noise_ratio(a, b)
    np.testing.assert_allclose(t_im.structural_similarity(a, b, multichannel=multichannel),
                               want_ssim, rtol=RTOL)
    np.testing.assert_allclose(t_im.peak_signal_noise_ratio(a, b), want_psnr, rtol=RTOL)
    got_ssim = t_im.ssim(ta, tb, multichannel=multichannel)
    got_psnr = t_im.psnr(ta, tb)
    assert got_ssim.dtype == got_psnr.dtype == torch.float64
    assert got_ssim.dim() == got_psnr.dim() == 0
    np.testing.assert_allclose(got_ssim.item(), want_ssim, rtol=RTOL)
    np.testing.assert_allclose(got_psnr.item(), want_psnr, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_metrics_meet_golden_anchors(name):
    metric, (i, j), multichannel, frozen = GOLDEN[name]
    images = _golden_inputs()
    a, b = images[i], images[j]
    if metric == "ssim":
        plain = t_im.structural_similarity(a, b, multichannel=multichannel)
        tensor = t_im.ssim(torch.from_numpy(a), torch.from_numpy(b), multichannel=multichannel)
    else:
        plain = t_im.peak_signal_noise_ratio(a, b)
        tensor = t_im.psnr(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(plain, frozen, rtol=RTOL)
    np.testing.assert_allclose(tensor.item(), frozen, rtol=1e-9)


def test_float_images_with_data_range_match_jax():
    """Non-uint8 images: SSIM with a given ``data_range``; PSNR infers it
    from the true image's range, as skimage does."""
    rng = np.random.default_rng(5)
    a = rng.random((30, 31, 3))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(t_im.ssim(ta, tb, data_range=1.0).item(),
                               j_im.structural_similarity(a, b, data_range=1.0), rtol=RTOL)
    np.testing.assert_allclose(t_im.psnr(ta, tb).item(), j_im.peak_signal_noise_ratio(a, b),
                               rtol=RTOL)


def test_identical_images_and_bad_inputs():
    a, _ = _pair((16, 16, 3), 6)
    ta = torch.from_numpy(a)
    assert t_im.peak_signal_noise_ratio(a, a) == np.inf == t_im.psnr(ta, ta).item()
    assert t_im.ssim(ta, ta).item() == pytest.approx(1.0, abs=1e-12)
    assert t_im.structural_similarity(a, a) == pytest.approx(1.0, abs=1e-12)
    # the numpy PSNR is the JAX one and broadcasts; the numpy SSIM and both
    # torch metrics check shapes
    with pytest.raises(ValueError, match="shape mismatch"):
        t_im.structural_similarity(a, a[:8])
    with pytest.raises(ValueError, match="shape mismatch"):
        t_im.ssim(ta, ta[:8])
    with pytest.raises(ValueError, match="shape mismatch"):
        t_im.psnr(ta, ta[:8])
    with pytest.raises(ValueError, match="data_range"):
        t_im.structural_similarity(a.astype(np.float64), a.astype(np.float64))
    with pytest.raises(ValueError, match="data_range"):
        t_im.ssim(ta.double(), ta.double())
