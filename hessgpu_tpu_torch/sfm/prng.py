"""The JAX package's RANSAC draws, reproduced in NumPy.

The JAX package samples its RANSAC hypotheses with
jax.random.choice(PRNGKey(seed), n, shape, p=probs): a threefry-2x32 counter
hash of the key over the flat output index (JAX's partitionable layout), the
32-bit result turned into a uniform float32 in [0, 1), and an inverse-CDF
lookup in the float32 cumulative sum of probs. This module computes the
same indices, so a reconstruction seeded as the JAX package seeds its own
draws the same hypotheses.

The cumulative sum is summed in the order XLA's CPU backend sums it, which
decides the last bit of each entry: sequentially inside blocks of 16, each
block offset by the cumulative sum of the blocks' totals, taken the same
way (tests/test_torch_sfm_incremental.py holds the indices equal to
jax.random.choice's).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter pairs (x1, x2) under the key
    (k1, k2); uint32 arrays, wrapping arithmetic."""
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1 = x1 + ks[0]
    x2 = x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r))
            x2 = x1 ^ x2
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def uniform(seed: int, count: int) -> np.ndarray:
    """float32 uniforms in [0, 1) of jax.random.uniform(PRNGKey(seed),
    (count,)), flattened in row-major order. The key is (0, the seed's low
    32 bits), as PRNGKey makes it with 64-bit mode off."""
    k1 = np.uint32(0)
    k2 = np.uint32(int(seed) & 0xFFFFFFFF)
    counts = np.arange(count, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = _threefry2x32(k1, k2, hi, lo)
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


_CUMSUM_BLOCK = 16


def _cumsum(p: np.ndarray) -> np.ndarray:
    """float32 cumulative sum of p (n,) in XLA's blocked order."""
    n = len(p)
    if n <= _CUMSUM_BLOCK:
        return np.cumsum(p, dtype=np.float32)
    m = -(-n // _CUMSUM_BLOCK)
    q = np.zeros(m * _CUMSUM_BLOCK, np.float32)
    q[:n] = p
    within = np.cumsum(q.reshape(m, _CUMSUM_BLOCK), axis=1, dtype=np.float32)
    carry = np.zeros(m, np.float32)
    carry[1:] = _cumsum(within[:, -1])[:-1]
    return (within + carry[:, None]).reshape(-1)[:n]


def choice(seed: int, n: int, shape, probs) -> np.ndarray:
    """jax.random.choice(PRNGKey(seed), n, shape, replace=True, p=probs) as
    int64 indices; probs is float32 (n,)."""
    cdf = _cumsum(np.asarray(probs, np.float32))
    count = int(np.prod(shape))
    r = cdf[-1] * (np.float32(1.0) - uniform(seed, count))
    idx = np.searchsorted(cdf, r, side="left")
    return idx.astype(np.int64).reshape(tuple(shape))
