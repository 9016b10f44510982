"""Algorithm 1: the Frobenius projection onto GS(P_L, P, P_R) (port of
``repro/core/projection.py``).

By Proposition 1, P_L^T A P_R^T is a block matrix whose (k1, k2) block is a
sum of outer products u_{sigma(j)} v_j^T over a rank budget r_{k1,k2} that
the middle permutation fixes. The optimal projection truncates the SVD of
each block (Eckart-Young) and packs the factors back into the L / R blocks
at the positions sigma dictates, in JAX's order; surplus budget stays zero.

JAX runs one float64 numpy SVD per bucket in a Python loop. Here the
buckets are grouped by rank (every block has the same shape) and each group
is one batched ``torch.linalg.svd`` on the tensor's device: float64 on the
CPU, float32 on the card. The SVD is a library call, as in JAX, where it
lies outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from .gs import GSLayout, gs_materialize
from .permutations import inverse_sigma

__all__ = ["project_to_gs", "gs_reconstruction_error"]


def compute_dtype(device: torch.device) -> torch.dtype:
    """float64 on the CPU (JAX's precision), float32 on the card."""
    return torch.float64 if device.type == "cpu" else torch.float32


def project_to_gs(a: Union[torch.Tensor, np.ndarray], layout: GSLayout
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project dense ``a`` (out_dim x in_dim) onto GS(P_L, P, P_R).

    Returns stacked blocks (L, R) of shapes (k_L, b_L, b_L2) and
    (k_R, b_R, b_R2) minimizing ||A - P_L L P R P_R||_F, on ``a``'s device
    (numpy input: the CPU) in ``compute_dtype`` of that device."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    dev = a.device
    dt = compute_dtype(dev)
    a = a.to(dt)
    if tuple(a.shape) != (layout.out_dim, layout.in_dim):
        raise ValueError(f"expected {(layout.out_dim, layout.in_dim)}, "
                         f"got {tuple(a.shape)}")
    idx = lambda s: torch.as_tensor(s, dtype=torch.int64, device=dev)  # noqa: E731

    # strip the outer permutations: B = P_L^T A P_R^T (rows by
    # inv(sigma_L), columns by sigma_R under gather semantics)
    sig_l = layout.perm_left.sigma(layout.out_dim)
    sig_r = layout.perm_right.sigma(layout.in_dim)
    b = a[idx(inverse_sigma(sig_l))][:, idx(sig_r)]

    kL, bL1, bL2 = layout.lspec.param_shape
    kR, bR1, bR2 = layout.rspec.param_shape
    sigma = layout.perm_mid.sigma(layout.inner_dim)
    # blocks[k1, k2] = B[k1*bL1:(k1+1)*bL1, k2*bR2:(k2+1)*bR2]
    blocks = b.reshape(kL, bL1, kR, bR2).permute(0, 2, 1, 3)

    L = torch.zeros((kL, bL1, bL2), dtype=dt, device=dev)
    R = torch.zeros((kR, bR1, bR2), dtype=dt, device=dev)

    # bucket the inner indices j by (k1, k2) = (j // b_L2, sigma(j) // b_R1);
    # a stable sort keeps each bucket's j ascending, JAX's packing order
    j = np.arange(layout.inner_dim)
    key = (j // bL2) * kR + sigma // bR1
    order = np.argsort(key, kind="stable")
    keys, starts, counts = np.unique(key[order], return_index=True,
                                     return_counts=True)
    rank_cap = min(bL1, bR2)
    for r in np.unique(counts):
        sel = counts == r
        k1, k2 = keys[sel] // kR, keys[sel] % kR
        rr = min(int(r), rank_cap)
        js = order[starts[sel][:, None] + np.arange(rr)[None, :]]  # (n, rr)
        u, s, vt = torch.linalg.svd(blocks[idx(k1), idx(k2)],
                                    full_matrices=False)
        ssqrt = torch.sqrt(s[:, :rr])
        ucols = u[:, :, :rr] * ssqrt[:, None, :]        # columns of L_{k1}
        vrows = vt[:, :rr, :] * ssqrt[:, :, None]       # rows of R_{k2}
        rows1 = idx(np.repeat(k1[:, None], rr, axis=1))
        rows2 = idx(np.repeat(k2[:, None], rr, axis=1))
        L[rows1, :, idx(js % bL2)] = ucols.transpose(1, 2)
        R[rows2, idx(sigma[js] % bR1), :] = vrows
    return L, R


def gs_reconstruction_error(a: Union[torch.Tensor, np.ndarray],
                            layout: GSLayout, L, R) -> float:
    """||A - P_L L P R P_R||_F, computed on L's device in L's dtype."""
    A = gs_materialize(layout, L, R)
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return float(torch.linalg.norm(a.to(device=A.device, dtype=A.dtype) - A))
