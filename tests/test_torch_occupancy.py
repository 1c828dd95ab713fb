"""The port's occupancy grid (``minimal_nerf_torch/ops/occupancy.py``) and the
plain version of its probe kernel against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
JAX probe kernel runs in interpret mode, as ``tests/test_occupancy.py`` runs
it. The port's words are int32 with the JAX ``uint32`` bit pattern, compared
through ``.view(np.uint32)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimal_nerf_torch.kernels import occupancy_probe as t_probe
from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.ops import occupancy as t_occ
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.utils import profiling
from minimal_nerf_tpu.models import mlp as j_mlp
from minimal_nerf_tpu.ops import occupancy as j_occ
from minimal_nerf_tpu.training import config as j_config

HE_GAIN = np.sqrt(6.0)


def T(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _cfgs(**kw):
    return j_occ.OccupancyConfig(**kw), t_occ.OccupancyConfig(**kw)


def _words_u32(words: torch.Tensor) -> np.ndarray:
    assert words.dtype == torch.int32
    return words.numpy().view(np.uint32)


def _he_params(seed, pd=4, dd=2):
    """He-uniform weights (densities vary over the grid, about half of the
    cells above the threshold) for both packages."""
    keys = jax.random.split(jax.random.PRNGKey(seed))
    jp = {k: jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, np.float32) * (HE_GAIN if path[-1].key == "w" else 1.0),
        jax.device_get(j_mlp.init_nerf_mlp(key, pd, dd, width=64, rgb_width=32)))
        for k, key in zip(("coarse", "fine"), keys)}
    return jp, t_mlp.params_from_jax(jp, "cpu")


@pytest.mark.parametrize("force_all", [False, True])
@pytest.mark.parametrize("g", [16, 20])
def test_pack_occupancy_matches_jax(g, force_all):
    """Bit-identical words at G=16 (128 words) and G=20 (250 words), around
    the relative threshold, with and without the warmup's forcing."""
    jcfg, tcfg = _cfgs(resolution=g, threshold=1e-2, rel_threshold=1.0)
    ema = np.random.default_rng(g).uniform(0, 0.05, (g, g, g)).astype(np.float32)
    want = np.asarray(j_occ.pack_occupancy(jnp.asarray(ema), jcfg, force_all=force_all))
    got = t_occ.pack_occupancy(T(ema), tcfg, force_all=force_all)
    assert got.shape == (g ** 3 // 32,)
    np.testing.assert_array_equal(_words_u32(got), want)
    if force_all:
        assert (want == 0xFFFFFFFF).all()
    else:
        assert 0.3 < t_occ.occupancy_mask(T(ema), tcfg).float().mean() < 0.7
        assert (want >> 31).any()  # bit 31 is set in some word


@pytest.mark.parametrize("rel", [0.0, 1e-2, 0.5])
def test_effective_threshold_matches_jax(rel):
    jcfg, tcfg = _cfgs(resolution=16, threshold=1e-2, rel_threshold=rel)
    ema = np.random.default_rng(3).exponential(0.1, (16, 16, 16)).astype(np.float32)
    want = float(j_occ.effective_threshold(jnp.asarray(ema), jcfg))
    got = t_occ.effective_threshold(T(ema), tcfg)
    assert got.dtype == torch.float32
    # fp32 means of 4096 values, summed in other orders
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert (want > 1e-2) == (rel == 0.5)


@pytest.mark.parametrize("g,shape", [(16, (257, 13)), (64, (512, 64)), (32, (33,))])
def test_probe_bits_plain_matches_jax(g, shape):
    """The plain probe is bit-identical to all three JAX lowerings (the
    Pallas kernel in interpret mode, the gather, the one-hot matmul), at a
    ragged probe count and over word counts that need the TPU's padding."""
    rng = np.random.default_rng(11 + g)
    words = rng.integers(0, 2 ** 32, size=g ** 3 // 32, dtype=np.uint32)
    lin = rng.integers(0, g ** 3, size=shape, dtype=np.int32)
    got = t_probe.probe_bits_plain(T(words.view(np.int32), np.int32), T(lin, np.int32))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    for fn in (j_occ._probe_bits_pallas, j_occ._probe_bits_gather, j_occ._probe_bits_onehot):
        np.testing.assert_array_equal(got.numpy(), np.asarray(fn(jnp.asarray(words),
                                                                 jnp.asarray(lin))))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        t_probe.probe_bits(T(words.view(np.int32), np.int32), T(lin, np.int32)).numpy(),
        got.numpy())
    assert profiling.counter(t_probe.LAUNCHES) == 0


def test_probe_out_of_range_gives_zero_like_the_tpu_kernel():
    """Indices outside ``[0, 32 * n_words)`` give 0, as the TPU kernel's
    zero-padded table does (the gather lowering clamps instead)."""
    words = np.full(4, 0xFFFFFFFF, np.uint32)  # 128 cells, all occupied
    lin = np.array([-1, -33, 0, 127, 128, 4096, 2 ** 31 - 1], np.int32)
    got = t_probe.probe_bits_plain(T(words.view(np.int32), np.int32), T(lin, np.int32))
    np.testing.assert_array_equal(got.numpy(), [0, 0, 1, 1, 0, 0, 0])
    want = j_occ._probe_bits_pallas(jnp.asarray(words), jnp.asarray(lin))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_probe_wrapper_checks_its_inputs():
    words, lin = torch.zeros(4, dtype=torch.int32), torch.zeros(8, dtype=torch.int32)
    for bad_words, bad_lin in ((words.long(), lin), (words, lin.long()),
                               (words, torch.zeros(4, 2, dtype=torch.int32).t())):
        with pytest.raises(ValueError):
            t_probe.probe_bits(bad_words, bad_lin)
    with pytest.raises(ValueError, match="device"):
        t_probe.probe_bits(words.to("meta"), lin.to("meta"))


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("method", ["gather", "onehot", "pallas", "auto"])
def test_query_bin_weights_matches_jax(method):
    """Exact weights under every probe-method name a config may carry (all
    probe through the one wrapper), including rays that leave the box and
    rays wholly outside it (the uniform fallback)."""
    jcfg, tcfg = _cfgs(resolution=16, floor=0.25, probe_method=method)
    ema = np.random.default_rng(5).uniform(0, 0.03, (16, 16, 16)).astype(np.float32)
    words = j_occ.pack_occupancy(jnp.asarray(ema), jcfg)
    o, d = _rays(6, 65)
    o[-8:] += 20.0  # wholly outside the [-3.2, 3.2]^3 box
    want = np.asarray(j_occ.query_bin_weights(words, jnp.asarray(o), jnp.asarray(d), jcfg, 32,
                                              2.0, 6.0, probe_method="gather"))
    t_words = T(np.asarray(words).view(np.int32), np.int32)
    got = t_occ.query_bin_weights(t_words, T(o), T(d), tcfg, 32, 2.0, 6.0)
    assert got.dtype == torch.float32 and got.shape == (65, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want[:-8])) == {0.0, 0.25, 1.0}
    assert (want[-8:] == 1.0).all()  # no positive weight: uniform fallback


@pytest.mark.parametrize("in_bin_jitter", [False, True])
def test_occupancy_coarse_samples_match_jax(in_bin_jitter):
    """Samples and times on the JAX draws (eps and the in-bin jitter split
    from the sampler's key), fp32 within atol 1e-6; the bin weights include
    flat CDF runs (weight-0 bins) and an all-zero row."""
    n, b, s = 40, 16, 12
    rng = np.random.default_rng(7)
    weights = rng.choice([0.0, 0.25, 1.0], size=(n, b)).astype(np.float32)
    weights[3] = 0.0
    o, d = _rays(8, n)
    key = jax.random.PRNGKey(9)
    want_s, want_t = j_occ.occupancy_coarse_samples(
        key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(weights), s, 2.0, 6.0,
        in_bin_jitter=in_bin_jitter)
    k_eps, k_jit = jax.random.split(key)
    draws = (T(jax.random.uniform(k_eps, (n, 1))), T(jax.random.uniform(k_jit, (n, s))))
    got_s, got_t = t_occ.occupancy_coarse_samples(T(o), T(d), T(weights), s, 2.0, 6.0,
                                                  in_bin_jitter=in_bin_jitter, uniforms=draws)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)
    assert (np.diff(got_t.numpy()[..., 0], axis=1) >= 0).all()


def test_occupancy_sampler_draws_from_its_generator():
    """The sampler hook (signature of ``generate_coarse_samples``) draws eps
    then the jitter from the generator: the same as passing those draws."""
    cfg = t_occ.OccupancyConfig(resolution=8, num_bins=16)
    words = t_occ.pack_occupancy(torch.rand((8, 8, 8), generator=torch.Generator().manual_seed(0))
                                 * 0.05, cfg)
    o, d = (T(a) for a in _rays(10, 20))
    sampler = t_occ.make_occupancy_sampler(words, cfg)
    samples, ts = sampler(o, d, 10, 2.0, 6.0, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    draws = (torch.rand((20, 1), generator=g), torch.rand((20, 10), generator=g))
    again = sampler(o, d, 10, 2.0, 6.0, uniforms=draws)
    assert torch.equal(ts, again[1]) and torch.equal(samples, again[0])
    assert ts.shape == (20, 10, 1) and samples.shape == (20, 10, 3)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_update_grid_ema_and_bake_grid_match_jax(precision):
    """One EMA update (both grid sources) and a 2-pass bake on the JAX
    jitter. fp32: the densities agree to 1e-5 of the grid's largest (other
    sum orders; measured 5e-7); bf16: both round the same operands, and
    another fp32 sum order now and then flips an activation's bf16 rounding
    (a relative step of 2^-8), which moves that cell's density: measured
    2.3e-3 of the largest density at one cell of 512, mean 5e-6. Bounds:
    each cell within 1e-2 of the largest density, the mean within 1e-4 of
    it, and at most 1% of the cells off by more than 1e-3 of it."""
    dtype = (None, None) if precision == "fp32" else (jnp.bfloat16, torch.bfloat16)
    max_rel, mean_rel = (1e-5, 1e-6) if precision == "fp32" else (1e-2, 1e-4)
    jp, tp = _he_params(1)
    g = 8
    ema = np.random.default_rng(2).uniform(0, 2.0, (g, g, g)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jitter = T(jax.random.uniform(key, (g ** 3, 3), jnp.float32))

    def close(got, want):
        diff = np.abs(got.numpy() - np.asarray(want))
        scale = np.abs(np.asarray(want)).max()
        assert diff.max() <= max_rel * scale and diff.mean() <= mean_rel * scale
        assert (diff > 1e-3 * scale).mean() <= 0.01

    for source in ("coarse", "both"):
        jcfg, tcfg = _cfgs(resolution=g, grid_source=source)
        want = j_occ.update_grid_ema(jnp.asarray(ema), jp, 4, 2, jcfg, key,
                                     compute_dtype=dtype[0])
        got = t_occ.update_grid_ema(T(ema), tp, 4, 2, tcfg, compute_dtype=dtype[1],
                                    jitter=jitter)
        close(got, want)
        assert (np.asarray(want) > ema * 0.9 + 1e-6).any()  # some cells took the density
    jcfg, tcfg = _cfgs(resolution=g)
    want = j_occ.bake_grid(jp, 4, 2, jcfg, key, compute_dtype=dtype[0], passes=2)
    jitters = [T(jax.random.uniform(jax.random.fold_in(key, i), (g ** 3, 3), jnp.float32))
               for i in range(2)]
    got = t_occ.bake_grid(tp, 4, 2, tcfg, compute_dtype=dtype[1], passes=2, jitters=jitters)
    close(got, want)
    assert got.shape == (g, g, g) and (got.numpy() > 0).mean() > 0.2


def test_occupancy_config_rejects_unknown_values():
    """The four JAX probe-method names are accepted (checkpoints carry
    them); an unknown name, grid source or a ``G^3`` not divisible by 32 is
    refused."""
    for name in t_occ.PROBE_METHODS:
        assert t_occ.OccupancyConfig(probe_method=name).probe_method == name
    assert set(t_occ.PROBE_METHODS) == {"auto", "gather", "onehot", "pallas"}
    with pytest.raises(ValueError):
        t_occ.OccupancyConfig(probe_method="triton")
    with pytest.raises(ValueError):
        t_occ.OccupancyConfig(grid_source="middle")
    with pytest.raises(ValueError):
        t_occ.OccupancyConfig(resolution=10)


def test_occupancy_config_matches_jax():
    """Same fields and defaults; ``TrainConfig.occupancy_config`` maps the
    ``occ_*`` fields as JAX's does."""
    assert t_occ.OccupancyConfig().to_dict() == j_occ.OccupancyConfig().to_dict()
    kw = dict(occupancy=True, occ_resolution=32, occ_warmup_steps=32, occ_num_bins=48,
              occ_in_bin_jitter=False, occ_grid_source="both", occ_probe_method="gather")
    want = j_config.TrainConfig(**kw).occupancy_config.to_dict()
    assert t_config.TrainConfig(**kw).occupancy_config.to_dict() == want
    assert t_config.TrainConfig().occupancy_config is None
    again = t_occ.OccupancyConfig.from_dict(dict(want, unknown=1))
    assert dataclasses.asdict(again) == want
