"""Differentiable kernel entry points (port of the ``bdmm_diff``,
``gs_diff`` and ``gs_T_diff`` custom-VJP rules of
``repro/kernels/dispatch.py``).

Each is a ``torch.autograd.Function`` whose forward and backward are the
port's kernels, as in the JAX rules:

* ``bdmm_diff(blocks, x, transpose_blocks=False)``: y = diag(W) x
  (``bdmm``), W = blocks or blocks^T read in place; the backward is
  ``bdmm_dblocks(dy, x)`` for the blocks (``bdmm_dblocks(x, dy)``, the
  transpose of W's gradient, when W = blocks^T) and, only when the input
  needs a gradient, ``bdmm(W^T, dy)`` for dx, W^T again read in place (a
  frozen weight slab never needs dx; the JAX rule always computes it).
* ``gs_diff(L, R, x)``: y = P^T L P R x (``gs_fused``); the backward is
  ``gs_fused_grads`` -> (dL, dR), or the fused ``gs_fused_bwd`` -> (dx, dL,
  dR) only when x needs a gradient.
* ``gs_T_diff(L, R, x)``: y = Q^T x = R^T P^T L^T P x (``gs_fused_T``).
  Since <dy, Q^T x> = <x, Q dy>, (dL, dR) come from ``gs_fused_grads`` with
  input and cotangent swapped, and dx, only when x needs it, is the
  forward rotation ``gs_fused`` of dy.
* ``ssd_diff(x, loga, B, C)``: the SSD scan (``ssd``'s forward kernel,
  which then also writes every chunk's start state); the backward is the
  port's own kernel ``ssd_bwd`` -> (dx, dloga, dB, dC), reading those
  states (the JAX package differentiates its plain scan instead: it has
  no backward kernel). CUDA tensors only: on the CPU ``ssd`` runs its
  plain version under torch autograd.

L, R: (r, b, b); x: (T, d); the ``*_rows`` forms take per-row factors L,
R (B, r, b, b) with x (B, T, d). dL and dR are cast to L's dtype. The GS rules,
like bdmm's, skip the dx slab for a frozen x (the weight a GSOFT adapter
rotates); the JAX rules always compute it. A CUDA tensor runs the kernels,
a CPU tensor their plain versions, both ways. The tuning
registry of the JAX module is not ported: the kernels pick their own launch
geometry. ``pick_chunk`` is the plain SSD scan's chunk rule.
"""
from __future__ import annotations

import torch

from .bdmm import bdmm, bdmm_dblocks
from .gs_fused import gs_fused, gs_fused_bwd, gs_fused_grads, gs_fused_T


class _GSDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, R, x):
        L, R, x = L.contiguous(), R.contiguous(), x.contiguous()
        ctx.save_for_backward(L, R, x)
        return gs_fused(x, L, R)

    @staticmethod
    def backward(ctx, dy):
        L, R, x = ctx.saved_tensors
        args = (x, dy.contiguous(), L, R)
        dx = None
        if ctx.needs_input_grad[2]:
            dx, dL, dR = gs_fused_bwd(*args)
            dx = dx.to(x.dtype)
        else:
            dL, dR = gs_fused_grads(*args)
        return dL.to(L.dtype), dR.to(R.dtype), dx


class _GSTDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, R, x):
        L, R, x = L.contiguous(), R.contiguous(), x.contiguous()
        ctx.save_for_backward(L, R, x)
        return gs_fused_T(x, L, R)

    @staticmethod
    def backward(ctx, dy):
        L, R, x = ctx.saved_tensors
        dy = dy.contiguous()
        dL, dR = gs_fused_grads(dy, x, L, R)
        dx = None
        if ctx.needs_input_grad[2]:
            dx = gs_fused(dy, L, R).to(x.dtype)
        return dL.to(L.dtype), dR.to(R.dtype), dx


class _BdmmDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, x, transpose_blocks):
        ctx.save_for_backward(blocks, x)
        ctx.transpose_blocks = transpose_blocks
        return bdmm(x, blocks.to(x.dtype).contiguous(),
                    transpose_blocks=transpose_blocks)

    @staticmethod
    def backward(ctx, dy):
        blocks, x = ctx.saved_tensors
        trans = ctx.transpose_blocks
        dy = dy.contiguous()
        p, q = blocks.shape[-2], blocks.shape[-1]
        dblocks = dx = None
        if ctx.needs_input_grad[0]:
            # blocks' own layout: dy^T x, or (dy^T x)^T = x^T dy when W = blocks^T
            grad = bdmm_dblocks(x, dy, p, q) if trans else bdmm_dblocks(dy, x, p, q)
            dblocks = grad.to(blocks.dtype)
        if ctx.needs_input_grad[1]:
            dx = bdmm(dy, blocks.to(x.dtype).contiguous(),
                      transpose_blocks=not trans)
        return dblocks, dx, None


class _SSDDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, loga, B, C):
        from .ssd import ssd_fwd         # ssd.py imports this module
        y, saved = ssd_fwd(x, loga, B, C, states=True)
        ctx.save_for_backward(x, loga, B, C, saved[0])
        ctx.tile = saved[1]
        return y

    @staticmethod
    def backward(ctx, dy):
        from .ssd import ssd_bwd
        x, loga, B, C, states = ctx.saved_tensors
        return ssd_bwd(x, loga, B, C, dy, saved=(states, ctx.tile))


def ssd_diff(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor) -> torch.Tensor:
    """Differentiable SSD scan on CUDA tensors: x (Nb, T, H, P), loga (Nb,
    T, H), B, C (Nb, T, H, N) -> y; the gradients of all four come from
    one ``ssd_bwd`` launch."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_diff runs the kernels: a CUDA tensor, not "
                         f"{x.device} (ssd's plain version is "
                         f"differentiable as it is)")
    return _SSDDiff.apply(x, loga, B, C)


def bdmm_diff(blocks: torch.Tensor, x: torch.Tensor,
              transpose_blocks: bool = False) -> torch.Tensor:
    """Differentiable per-row block-diagonal matmul: blocks (B, r, bo, bi),
    or (B, r, bi, bo) with ``transpose_blocks`` (W = blocks^T, read in
    place), x (B, T, r * bi) contiguous -> (B, T, r * bo). The kernels run
    in x's dtype (blocks are cast to it); dblocks comes back in blocks'
    dtype from the fp32 sums, as the JAX rule casts it."""
    return _BdmmDiff.apply(blocks, x, transpose_blocks)


def gs_diff_rows(L: torch.Tensor, R: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Differentiable fused GSOFT rotation per row, y[i] = P^T L_i P R_i
    x[i]: L, R (B, r, b, b), x (B, T, d). One ``gs_fused`` launch for all
    rows forward, one ``gs_fused_grads`` (or ``gs_fused_bwd``) backward: a
    stack of weights (layers x experts) rotates in one launch, as JAX's
    vmapped ``pallas_call``."""
    return _GSDiff.apply(L, R, x)


def gs_T_diff_rows(L: torch.Tensor, R: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Differentiable transpose rotation per row, y[i] = Q_i^T x[i] (one
    ``gs_fused_T`` launch forward, one ``gs_fused_grads`` backward)."""
    return _GSTDiff.apply(L, R, x)


def gs_diff(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Differentiable fused GSOFT rotation y = P^T L P R x: L, R (r, b, b),
    x (T, d), as the kernels' one-row batch."""
    return gs_diff_rows(L[None], R[None], x[None])[0]


def gs_T_diff(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Differentiable transpose rotation y = Q^T x = R^T P^T L^T P x."""
    return gs_T_diff_rows(L[None], R[None], x[None])[0]


def pick_chunk(t: int, chunk: int) -> int:
    """Largest divisor of t that is <= chunk (the plain SSD scan's chunk)."""
    q = min(chunk, t)
    while t % q:
        q -= 1
    return max(q, 1)
