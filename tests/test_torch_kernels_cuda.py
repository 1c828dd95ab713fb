"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip without a card. This file imports neither JAX nor
the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from minimal_nerf_torch.kernels import fused_raymarch as fr
from minimal_nerf_torch.models.mlp import init_nerf_mlp

# the bounds of chip_smoke.py: every element |k - p| <= atol + rtol * |p|,
# and mean |k - p| <= mean_rtol * mean |p|. fp32: same rounding points, other
# sum order; bf16: a different fp32 sum order now and then flips a bf16
# rounding of an activation (relative step 2^-8), which the element bound
# admits and the mean bound keeps rare
TOL = {None: (1e-5, 1e-4, 1e-5), torch.bfloat16: (3e-3, 3e-3, 1e-3)}
# He-uniform weights: the outputs depend on the input, so a wrong layer shows
HE_GAIN = np.sqrt(6.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    fr.launches = 0
    return torch.device("cuda")


def _assert_close(k, p, tol):
    atol, rtol, mean_rtol = tol
    k, p = k.cpu().numpy(), p.cpu().numpy()
    np.testing.assert_allclose(k, p, rtol=rtol, atol=atol)
    assert np.abs(k - p).mean() <= mean_rtol * np.abs(p).mean()


def _inputs(seed, n, s, dev):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = (rng.normal(size=(n, 3)) - [0.0, 0.0, 2.0]).astype(np.float32)
    ts = np.sort(rng.uniform(2.0, 6.0, size=(n, s)), axis=1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (o, d, ts)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("n,s", [(37, 64), (64, 192), (5, 250), (3, 1)])
def test_fused_kernel_matches_plain(cuda_device, dtype, n, s):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=cuda_device, gain=HE_GAIN), dtype)
    o, d, ts = _inputs(5, n, s, cuda_device)
    kc, kw = fr.fused_forward(fm, o, d, ts)
    pc, pw = fr.fused_forward_plain(fm, o, d, ts)
    torch.cuda.synchronize()
    _assert_close(kc, pc, TOL[dtype])
    _assert_close(kw, pw, TOL[dtype])
    assert fr.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("layer", [2, 5, 10])  # trunk[2], skip concat, direction part
def test_fused_tolerance_rejects_a_faulty_layer(cuda_device, dtype, layer):
    """A pass with one layer zeroed fails the tolerance the kernel meets."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=cuda_device, gain=HE_GAIN), dtype)
    o, d, ts = _inputs(5, 64, 192, cuda_device)
    pc, _ = fr.fused_forward_plain(fm, o, d, ts)
    ws = list(fm.ws)
    ws[layer] = torch.zeros_like(ws[layer])
    bc, _ = fr.fused_forward_plain(fm._replace(ws=ws), o, d, ts)
    with pytest.raises(AssertionError):
        _assert_close(bc, pc, TOL[dtype])


@pytest.mark.cuda
def test_fused_kernel_rejects_bad_inputs(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fm = fr.prepare_fused_mlp(init_nerf_mlp(g, device=cuda_device), torch.bfloat16)
    o, d, ts = _inputs(1, 4, 8, cuda_device)
    with pytest.raises(ValueError):
        fr.fused_forward(fm, o, d, ts.double())
    with pytest.raises(ValueError):
        fr.fused_forward(fm, o, d, ts.t())
    with pytest.raises(ValueError):
        fr.fused_forward(fm, o, d, torch.zeros(4, 2000, device=cuda_device))
    assert fr.launches == 0
