"""The JAX package's random draws, recomputed with NumPy: the threefry2x32
counter-based generator as JAX configures it by default (partitionable
threefry), ``PRNGKey``, ``fold_in``, ``split`` and ``normal``.

The port draws its own noise from ``torch.Generator``s, so a seed gives other
numbers than in the JAX package. Where a run of the JAX package must be
replayed without JAX (the committed edit gate's inversion noise, recorded
with ``fold_in(PRNGKey(seed), t)``), these functions give the same keys bit
for bit and the same normals to a few ulp: ``erfinv`` is evaluated in fp64
here and by a fp32 polynomial in XLA.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key (k1, k2), all uint32."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = [k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA)]
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    ks = ks[1:] + ks[:1]
    rots = list(_ROTATIONS)
    for i in range(5):
        for r in rots[0]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[0]
        x1 = x1 + ks[1] + np.uint32(i + 1)
        ks = ks[1:] + ks[:1]
        rots = rots[1:] + rots[:1]
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32) (JAX's default
    32-bit mode): [0, seed]."""
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is outside [0, 2^32)")
    return np.array([0, int(seed)], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    a, b = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def _counters(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> [num, 2] keys."""
    hi, lo = _counters(num)
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([a, b], axis=1)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element, as ``jax.random.bits``."""
    hi, lo = _counters(math.prod(shape))
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return (a ^ b).reshape(shape)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: a uniform in
    (-1, 1) from the mantissa bits, then sqrt(2) erfinv."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    e = torch.erfinv(torch.from_numpy(u.astype(np.float64))).numpy()
    return (np.float32(np.sqrt(2)) * e.astype(np.float32)).astype(np.float32)
