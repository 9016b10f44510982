"""Cayley parametrization of orthogonal GS blocks (port of
``repro/core/orthogonal.py``).

    Q = (I + K)(I - K)^{-1},      K = A - A^T  (skew-symmetric)

K = 0 gives Q = I, the identity initialization of every orthogonal method.
The map runs in fp32 whatever the input dtype, and casts back. The
diagnostics (``orthogonality_error``, ``project_orthogonal``) and the test
helper ``random_orthogonal_blocks`` are plain torch / numpy, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


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


def cayley_inverse(q: torch.Tensor) -> torch.Tensor:
    """K with cayley(K) = Q (for Q without a -1 eigenvalue):
    K = (Q - I)(Q + I)^{-1}, as solve((Q+I)^T, (Q-I)^T)^T: one batched LU
    in fp32, cast back."""
    q32 = q.to(torch.float32)
    eye = torch.eye(q32.shape[-1], dtype=torch.float32, device=q32.device)
    k = torch.linalg.solve((q32 + eye).transpose(-1, -2),
                           (q32 - eye).transpose(-1, -2))
    return k.transpose(-1, -2).to(q.dtype)


def orthogonal_blocks(params: torch.Tensor, *,
                      neumann_order: Optional[int] = None) -> torch.Tensor:
    """Free parameters (k, b, b) -> orthogonal blocks via skew + Cayley."""
    return cayley(skew(params), neumann_order=neumann_order)


def orthogonality_error(q: torch.Tensor) -> torch.Tensor:
    """max |Q^T Q - I| over a batch of blocks (diagnostics, tests)."""
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    gram = q.transpose(-1, -2) @ q
    return torch.max(torch.abs(gram - eye))


def project_orthogonal(a: torch.Tensor) -> torch.Tensor:
    """Nearest orthogonal matrix (the polar factor) per block, by SVD in
    fp32."""
    u, _, vt = torch.linalg.svd(a.to(torch.float32), full_matrices=False)
    return (u @ vt).to(a.dtype)


def random_orthogonal_blocks(rng: Union[np.random.Generator, torch.Generator],
                             k: int, b: int, dtype=torch.float32,
                             device: DeviceLike = "cuda") -> torch.Tensor:
    """Haar-distributed random orthogonal blocks (QR of a Gaussian with the
    signs of R's diagonal folded into Q), for tests. A numpy ``rng`` draws
    exactly the JAX package's blocks (float64 QR on the host); a
    ``torch.Generator`` draws on its own device."""
    if isinstance(rng, np.random.Generator):
        g = rng.normal(size=(k, b, b))
        qs = []
        for i in range(k):
            q, r = np.linalg.qr(g[i])
            qs.append(q * np.sign(np.diag(r))[None, :])
        return torch.as_tensor(np.stack(qs), dtype=dtype,
                               device=resolve_device(device))
    g = torch.randn((k, b, b), generator=rng, dtype=torch.float64,
                    device=rng.device)
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1)).unsqueeze(-2)
    return q.to(dtype)
