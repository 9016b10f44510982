"""The GS shuffle ``P_(k, n)`` as index math (the part of
``repro/core/permutations.py`` that ``core/gs.py`` needs).

Gather semantics, as in the paper (Definition 5.2):

    y = P x   with   y[i] = x[sigma(i)],   sigma(i) = (i mod k) * (n // k) + i // k

which is ``reshape(k, n/k) -> transpose -> reshape(n)``. The inverse of
``P_(k, n)`` is ``P_(n/k, n)``.
"""
from __future__ import annotations

import numpy as np


def gs_sigma(k: int, n: int) -> np.ndarray:
    """Index map of ``P_(k, n)`` (gather semantics)."""
    if n % k != 0:
        raise ValueError(f"P_(k,n) requires k | n, got k={k}, n={n}")
    i = np.arange(n)
    return (i % k) * (n // k) + i // k


def inverse_sigma(sigma: np.ndarray) -> np.ndarray:
    """sigma^{-1}: if y = x[sigma] then x = y[inverse_sigma(sigma)]."""
    inv = np.empty_like(sigma)
    inv[sigma] = np.arange(sigma.shape[0])
    return inv
