"""GSOFT layout of Group-and-Shuffle matrices and the block-diagonal
product (the parts of ``repro/core/gs.py`` the adapters need).

GSOFT uses the square two-factor GS matrix

    Q = P^T L P R,     P = P_(r, d),  r = d / b,

with L = diag(L_1..L_r), R = diag(R_1..R_r) of b x b blocks. It is dense
iff r <= b (Theorem 2 with m = 2). The shuffle is index math
(``core/permutations.py``); the fused application lives in ``kernels``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops

from .permutations import gs_sigma, inverse_sigma


@dataclasses.dataclass(frozen=True)
class GSOFTLayout:
    """``Q = P^T L P R`` over d = r * b with r blocks of b x b per factor."""
    d: int
    block_size: int

    @property
    def num_blocks(self) -> int:
        return self.d // self.block_size

    def sigma_mid(self) -> np.ndarray:
        """Gather map of P = P_(r, d): (P x)[i] = x[sigma_mid[i]]."""
        return gs_sigma(self.num_blocks, self.d)

    def sigma_left(self) -> np.ndarray:
        """Gather map of P^T = P^{-1}."""
        return inverse_sigma(self.sigma_mid())

    def materialize(self, L: np.ndarray, R: np.ndarray) -> np.ndarray:
        """Dense Q = P^T L P R from (r, b, b) factors (tests, small d only)."""
        r, b = self.num_blocks, self.block_size
        Lm = np.zeros((self.d, self.d), np.float64)
        Rm = np.zeros((self.d, self.d), np.float64)
        for g in range(r):
            Lm[g * b:(g + 1) * b, g * b:(g + 1) * b] = L[g]
            Rm[g * b:(g + 1) * b, g * b:(g + 1) * b] = R[g]
        eye = np.eye(self.d)
        return eye[self.sigma_left()] @ Lm @ eye[self.sigma_mid()] @ Rm

    @property
    def param_shape(self):
        return (self.num_blocks, self.block_size, self.block_size)


def gsoft_layout(d: int, block_size: int) -> GSOFTLayout:
    """The layout used by GSOFT: Q = P^T L P R with square b x b blocks."""
    if d % block_size != 0:
        raise ValueError(f"block size {block_size} must divide d={d}")
    return GSOFTLayout(d, block_size)


def block_diag_matmul(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = diag(B_1..B_k) x along the last axis of x.

    blocks: (k, rows, cols); x: (..., k*cols) -> (..., k*rows). The op the
    bdmm kernel implements: on the card it runs ``kernels.ops.bdmm`` (the
    ``bdmm`` kernel forward, ``bdmm_dblocks`` and, for an input that needs
    a gradient, ``bdmm`` backward), as the JAX package's ``bdmm_diff`` rule
    pairs the two Pallas kernels."""
    return kernel_ops.bdmm(blocks, x)


def pick_block_size(d: int, target_b: int) -> int:
    """Largest divisor b of d with b <= target_b and d/b <= b when possible.

    Guarantees the m=2 GSOFT density condition (r <= b) whenever any divisor
    satisfies it; otherwise returns the largest divisor <= target_b.
    """
    divs = [b for b in range(1, d + 1) if d % b == 0]
    ok = [b for b in divs if b <= target_b and d // b <= b]
    if ok:
        return max(ok)
    le = [b for b in divs if b <= target_b]
    return max(le) if le else min(divs)
