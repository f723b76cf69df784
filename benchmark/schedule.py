"""What a window sends: arrival times and which pooled image each request carries.

Open loop: ``round(rate * seconds)`` requests whose gaps are the quantiles of
an exponential distribution (a Poisson process's gaps) in a drawn order,
scaled so that the last one falls inside the window.  Closed loop: batches
of distinct images.  Either way the images are drawn epoch by epoch, each
epoch a permutation of the pool, so every seed sends the same multiset of
gaps and of images, in another order.
"""

from __future__ import annotations

from typing import List

import numpy as np


def image_sequence(pool_size: int, n: int, seed: int) -> np.ndarray:
    """n pool indices, one drawn permutation of the pool after another."""
    rng = np.random.default_rng([seed, 2])
    epochs = -(-n // pool_size)
    return np.concatenate([rng.permutation(pool_size) for _ in range(epochs)])[:n]


def open_loop(rate: float, seconds: float, pool_size: int, seed: int):
    """(due times in s from the window's start, pool index per request)."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng([seed, 3])
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due, image_sequence(pool_size, n, seed)


def batches(pool_size: int, batch: int, n_batches: int, seed: int) -> List[np.ndarray]:
    """Batches of ``batch`` distinct pool indices (``batch`` divides the pool)."""
    if pool_size % batch:
        raise ValueError(f"a batch of {batch} does not divide a pool of {pool_size}")
    seq = image_sequence(pool_size, batch * n_batches, seed)
    return [seq[i * batch: (i + 1) * batch] for i in range(n_batches)]


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """k of n indices drawn from the seed, in increasing order."""
    rng = np.random.default_rng([seed, 4])
    return np.sort(rng.choice(n, size=min(n, k), replace=False))
