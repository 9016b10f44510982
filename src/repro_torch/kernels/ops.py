"""Entry points for the GS rotations (port of the GS part of
``repro/kernels/ops.py``), with the JAX signatures.

Kernel choice follows the device, not a flag: a CUDA tensor always goes
through the CUDA kernel (or the wrapper raises), a CPU tensor through the
plain version. ``use_pallas`` is accepted so configs and call sites convert
one for one from the JAX package, and is ignored. ``gs_transform`` and
``gs_transform_T`` are differentiable through the autograd rules of
``dispatch.py`` (kernels both ways on the card). The kernels pick their own
launch geometry; the tuning registry of ``repro.kernels.dispatch`` is not
ported yet.
"""
from __future__ import annotations

import torch

from .dispatch import gs_diff, gs_T_diff
from .gs_fused import gs_fused_T


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (N, d), contiguous: the rows are the rotation's tokens."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def gs_transform(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                 use_pallas: bool = False) -> torch.Tensor:
    """y = P^T L P R x (GSOFT rotation) over the last dim of x.
    ``use_pallas`` is ignored (see module docstring)."""
    del use_pallas
    return gs_diff(L, R, _tokens(x)).reshape(x.shape)


def gs_transform_T(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                   use_pallas: bool = False) -> torch.Tensor:
    """y = R^T P^T L^T P x (transpose rotation Q^T x, i.e. x Q for row
    vectors) over the last dim of x. ``use_pallas`` is ignored."""
    del use_pallas
    return gs_T_diff(L, R, _tokens(x)).reshape(x.shape)


def gs_banked_transform_T(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                          use_pallas: bool = False) -> torch.Tensor:
    """Per-row transpose rotation y[i] = x[i] Q_i, Q_i = P^T L_i P R_i.

    L, R: (B, r, b, b) pre-gathered per-row orthogonal blocks; x: (B, T, d).
    The continuous-batching engine's multi-adapter hot path.
    ``use_pallas`` is ignored."""
    del use_pallas
    return gs_fused_T(x.contiguous(), L.contiguous(), R.contiguous())
