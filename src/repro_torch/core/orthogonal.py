"""Cayley parametrization of orthogonal GS blocks (port of
``repro/core/orthogonal.py``).

    Q = (I + K)(I - K)^{-1},      K = A - A^T  (skew-symmetric)

K = 0 gives Q = I, the identity initialization of every orthogonal method.
The map runs in fp32 whatever the input dtype, and casts back.
"""
from __future__ import annotations

from typing import Optional

import torch


def skew(a: torch.Tensor) -> torch.Tensor:
    """K = A - A^T over the last two dims (batched)."""
    return a - a.transpose(-1, -2)


def cayley(k_skew: torch.Tensor, *,
           neumann_order: Optional[int] = None) -> torch.Tensor:
    """Batched Cayley map Q = (I + K)(I - K)^{-1} over the last two dims.

    ``k_skew`` must already be skew-symmetric (use ``skew``). The exact path
    is one batched LU solve; ``neumann_order`` truncates (I - K)^{-1} to
    I + K + ... + K^order (Horner), matmuls only.
    """
    dtype = k_skew.dtype
    k32 = k_skew.to(torch.float32)
    eye = torch.eye(k32.shape[-1], dtype=torch.float32, device=k32.device)
    if neumann_order is not None:
        inv = eye.expand_as(k32)
        for _ in range(neumann_order):
            inv = eye + k32 @ inv
        q = (eye + k32) @ inv
    else:
        # solve(I + K, I - K)^T = (I + K)(I - K)^{-1}   since (I-K)^T = I+K
        q = torch.linalg.solve(eye + k32, eye - k32).transpose(-1, -2)
    return q.to(dtype)
