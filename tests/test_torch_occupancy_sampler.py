"""The occupancy sampler of the port (``ops.occupancy.occupancy_sample``, on
the CPU its plain version ``occupancy_sample_plain``) against the JAX
package's ``query_bin_weights`` + ``occupancy_coarse_samples`` on the JAX
draws, and the sampler kernel's host side (its constants, its input checks
and its limits) on the CPU.

Inputs are made with numpy from a seed; the draws are JAX's
(``jax.random.split`` of the sampler's key into ``eps`` and ``frac``), as
``tests/test_torch_occupancy.py`` replays them. The kernel itself runs only
on a card (``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimal_nerf_torch.kernels import occupancy_sampler as t_sampler
from minimal_nerf_torch.ops import occupancy as t_occ
from minimal_nerf_tpu.ops import occupancy as j_occ

NEAR, FAR = 2.0, 6.0
# floor 0.1 (a weight not exact in binary): PyTorch's CPU cumsum
# accumulates in double, so each prefix is the exact sum rounded once (the
# kernel's too); XLA's sums in float32 one term at a time, each prefix off
# by up to (k - 1) / 2 ulp after k terms (measured: up to 4.5 ulp at B = 64,
# 5 ulp after the normalisation). A u within that of a CDF value takes the
# next bin. Bound on such samples: at most 1 in 500 (measured: none).
MOVED_BIN_SHARE = 2e-3


def T(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _rays(seed, n, outside=6):
    """Rays from around the box's center in all directions (most leave the
    [-3.2, 3.2]^3 box before t = 6), the last ``outside`` wholly outside."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    o[n - outside:] += 20.0
    return o, d


def _words(seed, g):
    """Random packed words (about half of the cells occupied) as JAX uint32
    and the port's int32."""
    words = np.random.default_rng(seed).integers(0, 2 ** 32, size=g ** 3 // 32, dtype=np.uint32)
    return words, T(words.view(np.int32), np.int32)


def _jax_sampler(words, o, d, jcfg, b, s, key, jitter):
    weights = j_occ.query_bin_weights(jnp.asarray(words), jnp.asarray(o), jnp.asarray(d), jcfg,
                                      b, NEAR, FAR, probe_method="gather")
    samples, ts = j_occ.occupancy_coarse_samples(key, jnp.asarray(o), jnp.asarray(d), weights,
                                                 s, NEAR, FAR, in_bin_jitter=jitter)
    return np.asarray(weights), np.asarray(samples), np.asarray(ts)


def _cdf_and_bins(weights, eps, s, lib):
    """The normalised CDF and the clamped bin of each sample, as the
    sampler computes them, in ``lib`` (jnp or torch)."""
    b = weights.shape[1]
    if lib is jnp:
        cdf = jnp.cumsum(weights, axis=1)
        cdf = cdf / (cdf[:, -1:] + 1e-10)
        u = jnp.arange(s, dtype=jnp.float32)[None, :] / s + eps / s
        idx = jax.vmap(lambda a, v: jnp.searchsorted(a, v, side="left"))(cdf, u)
        return np.asarray(cdf), np.minimum(np.asarray(idx), b - 1)
    cdf = torch.cumsum(weights, dim=1)
    cdf = cdf / (cdf[:, -1:] + 1e-10)
    u = (torch.arange(s, dtype=torch.float32)[None, :] / s + eps / s).contiguous()
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u, right=False), max=b - 1)
    return cdf.numpy(), idx.numpy()


@pytest.mark.parametrize("floor", [0.25, 0.1])
@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("g,b,s", [(16, 32, 12), (32, 64, 16), (16, 64, 64), (32, 32, 64)])
def test_plain_sampler_matches_jax(g, b, s, jitter, floor):
    """Weights bit-identical; at floor 0.25 (every CDF prefix exact in
    float) ts and samples within atol 1e-6. At floor 0.1 the port's CDF
    prefixes are the exact sums rounded once, JAX's normalised CDF within
    its float32 summation bound of them ((B - 1) / 2 + 2 ulp), the samples
    whose bin moved counted and bounded (``MOVED_BIN_SHARE``), and the rays
    with no moved bin within atol 1e-6."""
    n = 48
    jcfg = j_occ.OccupancyConfig(resolution=g, num_bins=b, floor=floor, in_bin_jitter=jitter)
    tcfg = t_occ.OccupancyConfig(resolution=g, num_bins=b, floor=floor, in_bin_jitter=jitter)
    words, t_words = _words(g + b + s, g)
    o, d = _rays(s + b, n)
    key = jax.random.PRNGKey(g * b + s)
    want_w, want_s, want_t = _jax_sampler(words, o, d, jcfg, b, s, key, jitter)
    k_eps, k_jit = jax.random.split(key)
    eps = T(jax.random.uniform(k_eps, (n, 1)))
    frac = T(jax.random.uniform(k_jit, (n, s))) if jitter else None
    got_s, got_t, got_w = t_occ.occupancy_sample(t_words, T(o), T(d), eps, frac, tcfg, s, NEAR,
                                                 FAR, with_weights=True)
    assert got_t.shape == (n, s, 1) and got_s.shape == (n, s, 3) and got_w.shape == (n, b)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    assert set(np.unique(want_w[:-6])) == {0.0, floor_f32(floor), 1.0}
    assert (want_w[-6:] == 1.0).all()  # wholly outside: the uniform fallback
    assert (np.diff(got_t.numpy()[..., 0], axis=1) >= 0).all()

    keep, atol_t, atol_s = np.ones(n, bool), 1e-6, 1e-6
    if floor != 0.25:
        exact = np.cumsum(want_w.astype(np.float64), axis=1).astype(np.float32)
        np.testing.assert_array_equal(torch.cumsum(got_w, dim=1).numpy(), exact)
        j_cdf, j_idx = _cdf_and_bins(jnp.asarray(want_w), jnp.asarray(eps.numpy()), s, jnp)
        t_cdf, t_idx = _cdf_and_bins(got_w, eps, s, torch)
        ulp = np.spacing(np.maximum(np.abs(j_cdf), np.abs(t_cdf)).astype(np.float32))
        assert (np.abs(j_cdf - t_cdf) <= ((b - 1) / 2 + 2) * ulp).all()
        moved = j_idx != t_idx
        assert moved.sum() <= MOVED_BIN_SHARE * moved.size
        keep = ~moved.any(axis=1)
        if not jitter:
            # the exact inverse (u - lo) / (hi - lo) carries a CDF difference
            # e of lo and hi into the time as up to width * 2 e / (hi - lo)
            pad = lambda c: np.concatenate([np.zeros((n, 1), np.float32), c], axis=1)  # noqa: E731
            (t_lo, t_hi), (j_lo, j_hi) = [
                [np.take_along_axis(pad(c), t_idx + k, axis=1) for k in (0, 1)]
                for c in (t_cdf, j_cdf)]
            e = np.maximum(np.abs(t_lo - j_lo), np.abs(t_hi - j_hi))
            carried = (FAR - NEAR) / b * 2 * e / np.maximum(t_hi - t_lo, 1e-10)
            atol_t = (1e-6 + carried)[..., None]
            atol_s = 1e-6 + atol_t * np.abs(d)[:, None, :]
    diff_t, diff_s = np.abs(got_t.numpy() - want_t), np.abs(got_s.numpy() - want_s)
    assert (diff_t <= atol_t)[keep].all() and (diff_s <= atol_s)[keep].all()
    assert t_sampler.launches == 0


def floor_f32(x):
    return float(np.float32(x))


def _boundary_rays(rng, n, consts):
    """Rays whose position at one random bin midpoint lies within a few ulp
    of a cell boundary on one random axis: the cell there depends on how
    ``o + mid * d`` and ``(pos + bound) * scale`` are rounded."""
    o = rng.uniform(-2.0, 2.0, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    mids = _mids_f32(consts)
    b = rng.integers(0, consts.num_bins, size=n)
    axis = rng.integers(0, 3, size=n)
    cell = rng.integers(1, consts.resolution, size=n)
    edge = cell / np.float64(consts.scale) - np.float64(consts.bound)
    rows = np.arange(n)
    o[rows, axis] = (edge - np.float64(mids[b]) * d[rows, axis].astype(np.float64)).astype(
        np.float32)
    return o, d


def _mids_f32(consts):
    """The kernel's midpoints, one float32 rounding per operation:
    ``near + (b + 0.5) * width``."""
    f = np.float32
    return f(consts.near) + (np.arange(consts.num_bins, dtype=f) + f(0.5)) * f(consts.width)


def _cells_f32(o, d, consts, contract=False):
    """The kernel's cells in float32 numpy, one rounding per operation
    (with ``contract``, ``o + mid * d`` rounded once, as an FMA would)."""
    f = np.float32
    mids = _mids_f32(consts)[None, :, None]
    if contract:
        pos = (o[:, None, :].astype(np.float64) + mids.astype(np.float64)
               * d[:, None, :].astype(np.float64)).astype(f)
    else:
        pos = o[:, None, :] + mids * d[:, None, :]
    v = np.floor((pos + f(consts.bound)) * f(consts.scale)).astype(np.int32)
    inside = ((v >= 0) & (v < consts.resolution)).all(axis=-1)
    vc = np.clip(v, 0, consts.resolution - 1)
    g = consts.resolution
    return (vc[..., 0] * g + vc[..., 1]) * g + vc[..., 2], inside


@pytest.mark.parametrize("g,bound,b,near,far", [(16, 3.2, 32, 2.0, 6.0),
                                                (64, 3.2, 64, 2.0, 6.0),
                                                (128, 1.5, 48, 0.5, 3.7)])
def test_bin_constants_reproduce_bin_cells(g, bound, b, near, far):
    """The kernel's float32 constants and order of operations (emulated in
    numpy) give ``bin_cells``' cells and box test bit for bit, also on rays
    tuned to cell boundaries, where the same arithmetic contracted into an
    FMA gives other cells; the midpoints equal the plain version's and
    JAX's."""
    cfg = t_occ.OccupancyConfig(resolution=g, bound=bound)
    consts = t_sampler.bin_constants(cfg, b, near, far)
    for value, double in ((consts.scale, g / (2.0 * bound)), (consts.width, (far - near) / b),
                          (consts.bound, bound), (consts.near, near), (consts.floor, cfg.floor)):
        assert value == float(np.float32(double))
    width = (far - near) / b
    plain_mids = near + (torch.arange(b, dtype=torch.float32) + 0.5) * width
    jax_mids = near + (jnp.arange(b, dtype=jnp.float32) + 0.5) * width
    np.testing.assert_array_equal(_mids_f32(consts), plain_mids.numpy())
    np.testing.assert_array_equal(_mids_f32(consts), np.asarray(jax_mids))

    rng = np.random.default_rng(g + b)
    o, d = _boundary_rays(rng, 4096, consts)
    lin, inside = t_occ.bin_cells(T(o), T(d), cfg, b, near, far)
    want_lin, want_inside = _cells_f32(o, d, consts)
    np.testing.assert_array_equal(lin.numpy(), want_lin)
    np.testing.assert_array_equal(inside.numpy(), want_inside)
    fma_lin, _ = _cells_f32(o, d, consts, contract=True)
    assert (fma_lin != want_lin).sum() > 0


@pytest.mark.parametrize("jitter", [True, False])
def test_hook_draws_eps_then_frac_from_its_generator(jitter):
    """The hook draws ``eps [N, 1]`` and then, only with jitter, ``frac [N,
    S]``: the same samples as the plain version on those draws, and the
    generator left where the two draws leave it."""
    cfg = t_occ.OccupancyConfig(resolution=16, num_bins=32, in_bin_jitter=jitter)
    _, words = _words(4, 16)
    o, d = (T(a) for a in _rays(5, 24, outside=3))
    gen = torch.Generator().manual_seed(3)
    samples, ts = t_occ.make_occupancy_sampler(words, cfg)(o, d, 16, NEAR, FAR, generator=gen)
    again = torch.Generator().manual_seed(3)
    eps = torch.rand((24, 1), generator=again)
    frac = torch.rand((24, 16), generator=again) if jitter else None
    want_s, want_t, _ = t_occ.occupancy_sample_plain(words, o, d, eps, frac, cfg, 16, NEAR, FAR)
    assert torch.equal(ts, want_t) and torch.equal(samples, want_s)
    assert torch.equal(gen.get_state(), again.get_state())


def _good_inputs(n=8, s=16, g=16):
    _, words = _words(1, g)
    o, d = (T(a) for a in _rays(2, n, outside=1))
    return dict(occ_words=words, o_rays=o, d_rays=d, eps=torch.rand((n, 1)),
                frac=torch.rand((n, s)))


BAD_INPUTS = {
    "int64 words": lambda a: dict(a, occ_words=a["occ_words"].long()),
    "words of another grid": lambda a: dict(a, occ_words=a["occ_words"][:-1].contiguous()),
    "float64 origins": lambda a: dict(a, o_rays=a["o_rays"].double()),
    "non-contiguous directions": lambda a: dict(a, d_rays=a["d_rays"].t().contiguous().t()),
    "directions [N, 4]": lambda a: dict(a, d_rays=torch.zeros((8, 4))),
    "eps [N]": lambda a: dict(a, eps=a["eps"][:, 0]),
    "non-contiguous frac": lambda a: dict(a, frac=torch.rand((16, 8)).t()),
    "frac without jitter": None,
    "no frac with jitter": lambda a: dict(a, frac=None),
    "meta tensors": lambda a: {k: v.to("meta") for k, v in a.items()},
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_sampler_rejects_bad_inputs(case):
    """Wrong dtypes, shapes, layouts, devices and draws raise ValueError on
    the CPU as on the card (the meta device has no implementation)."""
    jitter = case != "frac without jitter"
    cfg = t_occ.OccupancyConfig(resolution=16, num_bins=32, in_bin_jitter=jitter)
    inputs = _good_inputs()
    if BAD_INPUTS[case] is not None:
        inputs = BAD_INPUTS[case](inputs)
    with pytest.raises(ValueError):
        t_occ.occupancy_sample(cfg=cfg, num_samples=16, near=NEAR, far=FAR, **inputs)
    if case == "meta tensors":
        with pytest.raises(ValueError, match="device"):
            t_occ.query_bin_weights(inputs["occ_words"], inputs["o_rays"], inputs["d_rays"],
                                    cfg, 32, NEAR, FAR)
    assert t_sampler.launches == 0


def test_kernel_limits_and_cpu_tensors():
    """The kernel takes 1..256 bins, 0..256 samples (0: the weights alone)
    and a floor >= 0; its wrapper refuses CPU tensors (no fallback)."""
    def consts(b, floor=0.25):
        return t_sampler.BinConstants(64, b, 3.2, 10.0, 0.0625, NEAR, floor)

    for b, s in ((1, 0), (256, 256), (64, 16)):
        t_sampler.check_kernel_limits(consts(b), s)
    for b, s, floor in ((0, 16, 0.25), (257, 16, 0.25), (64, 257, 0.25), (64, -1, 0.25),
                        (64, 16, -0.1)):
        with pytest.raises(ValueError):
            t_sampler.check_kernel_limits(consts(b, floor), s)
    a = _good_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        t_sampler.sample(a["occ_words"], a["o_rays"], a["d_rays"], a["eps"], a["frac"],
                         t_sampler.bin_constants(t_occ.OccupancyConfig(resolution=16), 32,
                                                 NEAR, FAR), 16)
    assert t_sampler.launches == 0
