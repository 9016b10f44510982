"""Permutations of Group-and-Shuffle matrices (port of
``repro/core/permutations.py``: the index maps, ``PermSpec`` with every
kind, ``apply_perm`` and ``apply_perm_T``).

Gather semantics, as in the paper (Definition 5.2):

    y = P x   with   y[i] = x[sigma(i)],   sigma(i) = (i mod k) * (n // k) + i // k

which is ``reshape(k, n/k) -> transpose -> reshape(n)``. The inverse of
``P_(k, n)`` is ``P_(n/k, n)``. The "paired" variant (paper App. F) moves
pairs of adjacent channels together:

    sigma_paired(i) = (floor(i/2) mod k) * (n/k) + 2*floor(i/(2k)) + (i mod 2).

``apply_perm`` is differentiable: the "gs" / "gs_inv" kinds are a reshape
and a transpose, every other kind an index gather whose backward is the
inverse gather, so neither saves an activation.
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


def paired_sigma(k: int, n: int) -> np.ndarray:
    """Paired variant of ``P_(k, n)`` (paper App. F): shuffles channel pairs."""
    if n % (2 * k) != 0:
        raise ValueError(f"paired perm requires 2k | n, got k={k}, n={n}")
    i = np.arange(n)
    return ((i // 2) % k) * (n // k) + 2 * (i // (2 * k)) + (i % 2)


def inverse_sigma(sigma: np.ndarray) -> np.ndarray:
    """sigma^{-1}: if y = x[sigma] then x = y[inverse_sigma(sigma)]."""
    inv = np.empty_like(sigma)
    inv[sigma] = np.arange(sigma.shape[0])
    return inv


def compose_sigma(s1: np.ndarray, s2: np.ndarray) -> np.ndarray:
    """sigma of the matrix product ``P_{s1} @ P_{s2}`` (apply s2 first)."""
    return s2[s1]


def perm_matrix(sigma: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Dense matrix P with P[i, sigma[i]] = 1 (tests, materialization)."""
    return np.eye(sigma.shape[0], dtype=dtype)[sigma]


def is_permutation(sigma: np.ndarray) -> bool:
    return bool(np.all(np.sort(sigma) == np.arange(sigma.shape[0])))


_INVERSE_KIND = {"gs": "gs_inv", "gs_inv": "gs", "paired": "paired_inv",
                 "paired_inv": "paired"}


@dataclasses.dataclass(frozen=True)
class PermSpec:
    """Symbolic permutation (``repro.core.permutations.PermSpec``).

    kind:
      - "identity":  no-op
      - "gs":        P_(k, n)       (reshape / transpose)
      - "gs_inv":    P_(k, n)^{-1}  = P_(n/k, n)
      - "paired":    paired GS shuffle (gather)
      - "paired_inv"
      - "index":     arbitrary sigma (gather); ``table`` holds it
    """
    kind: str
    k: int = 0
    table: Optional[tuple] = None

    @staticmethod
    def identity() -> "PermSpec":
        return PermSpec("identity")

    @staticmethod
    def gs(k: int) -> "PermSpec":
        return PermSpec("gs", k=k)

    @staticmethod
    def gs_inv(k: int) -> "PermSpec":
        return PermSpec("gs_inv", k=k)

    @staticmethod
    def paired(k: int) -> "PermSpec":
        return PermSpec("paired", k=k)

    @staticmethod
    def from_sigma(sigma: np.ndarray) -> "PermSpec":
        return PermSpec("index", table=tuple(int(v) for v in sigma))

    def sigma(self, n: int) -> np.ndarray:
        """The index map for size-n vectors."""
        if self.kind == "identity":
            return np.arange(n)
        if self.kind == "gs":
            return gs_sigma(self.k, n)
        if self.kind == "gs_inv":
            return inverse_sigma(gs_sigma(self.k, n))
        if self.kind == "paired":
            return paired_sigma(self.k, n)
        if self.kind == "paired_inv":
            return inverse_sigma(paired_sigma(self.k, n))
        if self.kind != "index":
            raise ValueError(f"unknown perm kind {self.kind}")
        if self.table is None or len(self.table) != n:
            raise ValueError(f"index permutation of length "
                             f"{len(self.table or ())} applied to n={n}")
        return np.asarray(self.table, dtype=np.int64)

    def inverse(self) -> "PermSpec":
        if self.kind == "identity":
            return self
        if self.kind in _INVERSE_KIND:
            return PermSpec(_INVERSE_KIND[self.kind], k=self.k)
        if self.kind != "index":
            raise ValueError(f"unknown perm kind {self.kind}")
        return PermSpec.from_sigma(inverse_sigma(self.sigma(len(self.table))))

    def matrix(self, n: int, dtype=np.float32) -> np.ndarray:
        return perm_matrix(self.sigma(n), dtype=dtype)


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
    n = x.shape[-1]
    if spec.kind in ("gs", "gs_inv"):
        # P_(k, n) is reshape(k, n/k) -> transpose; its inverse reshape(n/k, k)
        if n % spec.k:
            raise ValueError(f"P_(k,n) requires k | n, got k={spec.k}, n={n}")
        rows = spec.k if spec.kind == "gs" else n // spec.k
        y = x.reshape(x.shape[:-1] + (rows, n // rows)).transpose(-1, -2)
        return y.reshape(x.shape).movedim(-1, axis)
    idx, inv = _indices(spec, n, x.device)
    return _Gather.apply(x, idx, inv).movedim(-1, axis)


def apply_perm_T(x: torch.Tensor, spec: PermSpec, axis: int = -1) -> torch.Tensor:
    """``P^T x`` (= P^{-1} x for permutations)."""
    return apply_perm(x, spec.inverse(), axis=axis)
