"""JAX's default random numbers in numpy: the Threefry-2x32 keys (``PRNGKey``,
``split``, ``fold_in``) and ``uniform`` float32 draws, with JAX's
``jax_threefry_partitionable`` layout (its default), bit for bit; and the JAX
package's ``init_nerf_network`` drawn through them.

The card's machine has no JAX, and a run there that starts where a JAX run
started (``chip_smoke.py --trajectory``: the JAX side's init
``init_nerf_network(PRNGKey(seed))``) needs the JAX package's weights; these
functions make them on the host (``tests/test_torch_trajectory.py`` holds
them against JAX).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

Key = Tuple[np.uint32, np.uint32]
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    under ``key``, elementwise on uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**32``."""
    return (np.uint32(0), np.uint32(seed))


def split(key: Key, num: int = 2):
    """``jax.random.split(key, num)``: ``num`` keys."""
    b0, b1 = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return [(b0[i], b1[i]) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return (b0[0], b1[0])


def uniform(key: Key, shape, minval: np.float32, maxval: np.float32) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    n = int(np.prod(shape))
    b0, b1 = threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    minval, maxval = np.float32(minval), np.float32(maxval)
    # XLA fuses ``floats * (maxval - minval) + minval`` into one multiply-add
    # rounded once: the float64 product is exact, and its float64 sum rounds
    # to the same float32 here (held against JAX by the tests)
    scaled = (floats.astype(np.float64) * np.float64(maxval - minval)
              + np.float64(minval)).astype(np.float32)
    return np.maximum(minval, scaled).reshape(shape)


def _init_linear(key: Key, in_dim: int, out_dim: int) -> Dict[str, np.ndarray]:
    kw, kb = split(key)
    bound = np.float32(1.0) / np.sqrt(np.float32(in_dim))
    return {"w": uniform(kw, (in_dim, out_dim), -bound, bound),
            "b": uniform(kb, (out_dim,), -bound, bound)}


def init_nerf_mlp(key: Key, position_dim: int = 10, direction_dim: int = 4,
                  width: int = 256, rgb_width: int = 128) -> Dict[str, Any]:
    """The JAX package's ``init_nerf_mlp(key, ...)`` as numpy arrays."""
    pos_enc, dir_enc = 6 * position_dim, 6 * direction_dim
    keys = iter(split(key, 10))
    lin = lambda i, o: _init_linear(next(keys), i, o)  # noqa: E731
    return {
        "trunk": [lin(pos_enc, width), lin(width, width), lin(width, width), lin(width, width)],
        "feature": [lin(width + pos_enc, width), lin(width, width), lin(width, width)],
        "density": lin(width, 1),
        "rgb": [lin(width + dir_enc, rgb_width), lin(rgb_width, 3)],
    }


def init_nerf_network(seed: int, position_dim: int = 10,
                      direction_dim: int = 4) -> Dict[str, Any]:
    """The JAX package's ``init_nerf_network(PRNGKey(seed), config)`` as a
    numpy tree (``models.mlp.params_from_jax`` puts it on a device)."""
    k_coarse, k_fine = split(prng_key(seed))
    return {"coarse": init_nerf_mlp(k_coarse, position_dim, direction_dim),
            "fine": init_nerf_mlp(k_fine, position_dim, direction_dim)}
