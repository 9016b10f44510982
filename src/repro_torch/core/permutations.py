"""Permutations of Group-and-Shuffle matrices (port of
``repro/core/permutations.py``: the index maps, ``PermSpec``, ``apply_perm``
and ``apply_perm_T``).

Gather semantics, as in the paper (Definition 5.2):

    y = P x   with   y[i] = x[sigma(i)],   sigma(i) = (i mod k) * (n // k) + i // k

which is ``reshape(k, n/k) -> transpose -> reshape(n)``. The inverse of
``P_(k, n)`` is ``P_(n/k, n)``.

``apply_perm`` is differentiable: an index gather whose backward is the
inverse gather, so it saves no activation. (The GS shuffle itself is index
math in the kernels and a reshape in ``kernels/ref.py``; the JAX module's
reshape kinds of ``PermSpec`` are not needed here.)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch


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


@dataclasses.dataclass(frozen=True)
class PermSpec:
    """Symbolic permutation: the "identity" and "index" kinds of
    ``repro.core.permutations.PermSpec`` (an arbitrary sigma held in
    ``table``), the ones BOFT's butterfly levels use."""
    kind: str
    table: Optional[tuple] = None

    @staticmethod
    def identity() -> "PermSpec":
        return PermSpec("identity")

    @staticmethod
    def from_sigma(sigma: np.ndarray) -> "PermSpec":
        return PermSpec("index", table=tuple(int(v) for v in sigma))

    def sigma(self, n: int) -> np.ndarray:
        """The index map for size-n vectors."""
        if self.kind == "identity":
            return np.arange(n)
        if self.kind != "index":
            raise ValueError(f"unknown perm kind {self.kind}")
        if self.table is None or len(self.table) != n:
            raise ValueError(f"index permutation of length "
                             f"{len(self.table or ())} applied to n={n}")
        return np.asarray(self.table, dtype=np.int64)

    def inverse(self) -> "PermSpec":
        if self.kind == "identity":
            return self
        return PermSpec.from_sigma(inverse_sigma(self.sigma(len(self.table))))


@functools.lru_cache(maxsize=256)
def _indices(spec: PermSpec, n: int, device: torch.device):
    """(sigma, sigma^-1) of ``spec`` at size n as int64 tensors on device.
    Made outside inference mode, so a table first built while serving can
    still be saved for a backward pass later."""
    sigma = spec.sigma(n)
    with torch.inference_mode(False):
        return (torch.as_tensor(sigma, dtype=torch.int64, device=device),
                torch.as_tensor(inverse_sigma(sigma), dtype=torch.int64,
                                device=device))


class _Gather(torch.autograd.Function):
    """y = x[..., sigma]; the backward is the inverse gather of dy."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return x.index_select(-1, idx)

    @staticmethod
    def backward(ctx, dy):
        (inv,) = ctx.saved_tensors
        return dy.index_select(-1, inv), None, None


def apply_perm(x: torch.Tensor, spec: PermSpec, axis: int = -1) -> torch.Tensor:
    """``P x`` along ``axis`` (gather semantics y[i] = x[sigma(i)])."""
    if spec.kind == "identity":
        return x
    x = x.movedim(axis, -1)
    idx, inv = _indices(spec, x.shape[-1], x.device)
    return _Gather.apply(x, idx, inv).movedim(-1, axis)


def apply_perm_T(x: torch.Tensor, spec: PermSpec, axis: int = -1) -> torch.Tensor:
    """``P^T x`` (= P^{-1} x for permutations)."""
    return apply_perm(x, spec.inverse(), axis=axis)
