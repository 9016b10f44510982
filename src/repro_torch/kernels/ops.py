"""Kernel entry points (port of ``repro/kernels/ops.py``: bdmm, GS,
Householder, Givens, quantized matmuls, paged and flash attention, the SSD
scan), with the JAX signatures.

Kernel choice follows the device, not a flag: a CUDA tensor always goes
through the CUDA kernel (or the wrapper raises), a CPU tensor through the
plain version. ``use_pallas`` is accepted so configs and call sites convert
one for one from the JAX package, and is ignored. ``bdmm``,
``bdmm_banked``, ``gs_transform`` and ``gs_transform_T`` are differentiable
through the autograd rules of ``dispatch.py`` (kernels both ways on the
card). ``gs_bank_transform_T`` and ``gs_q_matmul_bank`` are the port's own
serving entries: they take a bank and slot ids where JAX gathers first.
``householder_banked`` and ``givens_banked`` have no kernel, as in
the JAX package (``banked_kernel=""``): their plain versions run on every
device. ``ssd`` is differentiable too: on the card through
``dispatch.ssd_diff`` (the scan kernel forward, the port's ``ssd_bwd``
kernel backward), on the CPU by torch autograd of the plain scan, as the
JAX package differentiates its own. ``q_matmul``, ``gs_q_matmul``,
``gs_q_matmul_banked``, ``paged_attention`` and ``flash_mha`` serve
inference only on the card (no autograd rule; a tensor that needs a
gradient raises). The
kernels pick their own launch geometry; the tuning registry of
``repro.kernels.dispatch`` is not ported yet.
"""
from __future__ import annotations

import math

import torch

from . import ref
from .dispatch import (bdmm_diff, gs_diff, gs_diff_rows, gs_T_diff,
                       gs_T_diff_rows)
from .flash_attention import flash_attention
from .gs_fused import gs_fused_T, gs_fused_T_bank
from .paged_attention import paged_decode
from .q_matmul import gs_q_matmul as _gs_q_matmul
from .q_matmul import gs_q_matmul_bank as _gs_q_matmul_bank
from .q_matmul import q_matmul as _q_matmul
from .ssd import ssd as _ssd


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (N, d), contiguous: the rows are the rotation's tokens."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def _stack_rows(x: torch.Tensor, lead: torch.Size, *factors: torch.Tensor):
    """A stack's factors (lead..., f...) and x (lead..., T, d) as the
    kernels' rows: (n, f...) and (n, T, d) contiguous, n = prod(lead) (one
    copy of x at most)."""
    n = math.prod(lead)
    return ([f.reshape((n,) + f.shape[len(lead):]) for f in factors]
            + [x.reshape((n, -1, x.shape[-1])).contiguous()])


def bdmm(blocks: torch.Tensor, x: torch.Tensor,
         use_pallas: bool = False) -> torch.Tensor:
    """Block-diagonal matmul y = diag(blocks) x over the last dim of x.

    blocks: (r, bo, bi); x: (..., r * bi) -> (..., r * bo). A stack of
    blocks (lead..., r, bo, bi) takes x (lead..., T, r * bi): one launch,
    the stack's slices the kernel's rows. The kernel runs in x's dtype.
    ``use_pallas`` is ignored."""
    del use_pallas
    lead = blocks.shape[:-3]
    if lead:
        blocks, xr = _stack_rows(x, lead, blocks)
        return bdmm_diff(blocks, xr).reshape(x.shape[:-1] + (-1,))
    y = bdmm_diff(blocks.unsqueeze(0), _tokens(x).unsqueeze(0))[0]
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def bdmm_banked(blocks: torch.Tensor, x: torch.Tensor,
                use_pallas: bool = False,
                transpose_blocks: bool = False) -> torch.Tensor:
    """Per-row block-diagonal matmul: blocks (B, r, bo, bi), x (B, T, r*bi).

    Row i uses its own block set: one kernel launch over all rows (the JAX
    package vmaps the kernel). ``transpose_blocks`` multiplies by each
    row's blocks^T (blocks given (B, r, bi, bo)), read in place: JAX's
    ``bdmm_banked(blocks^T, x)`` without the copy. ``use_pallas`` is
    ignored."""
    del use_pallas
    return bdmm_diff(blocks, x.contiguous(), transpose_blocks)


def gs_transform(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                 use_pallas: bool = False) -> torch.Tensor:
    """y = P^T L P R x (GSOFT rotation) over the last dim of x.

    L, R: (r, b, b), x (..., d); or a stack L, R (lead..., r, b, b) with x
    (lead..., T, d): one launch forward and one backward for the whole
    stack, its slices the kernels' rows (JAX vmaps the ``pallas_call``).
    ``use_pallas`` is ignored (see module docstring)."""
    del use_pallas
    lead = L.shape[:-3]
    if lead:
        return gs_diff_rows(*_stack_rows(x, lead, L, R)).reshape(x.shape)
    return gs_diff(L, R, _tokens(x)).reshape(x.shape)


def gs_transform_T(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                   use_pallas: bool = False) -> torch.Tensor:
    """y = R^T P^T L^T P x (transpose rotation Q^T x, i.e. x Q for row
    vectors) over the last dim of x; a stack as ``gs_transform``.
    ``use_pallas`` is ignored."""
    del use_pallas
    lead = L.shape[:-3]
    if lead:
        return gs_T_diff_rows(*_stack_rows(x, lead, L, R)).reshape(x.shape)
    return gs_T_diff(L, R, _tokens(x)).reshape(x.shape)


def gs_banked_transform_T(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                          use_pallas: bool = False) -> torch.Tensor:
    """Per-row transpose rotation y[i] = x[i] Q_i, Q_i = P^T L_i P R_i.

    L, R: (B, r, b, b) pre-gathered per-row orthogonal blocks; x: (B, T, d).
    The continuous-batching engine's multi-adapter hot path.
    ``use_pallas`` is ignored."""
    del use_pallas
    return gs_fused_T(x.contiguous(), L.contiguous(), R.contiguous())


def gs_bank_transform_T(L_bank: torch.Tensor, R_bank: torch.Tensor,
                        ids: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-row transpose rotation with the factors read from a bank by slot
    id: y[i] = x[i] Q_{ids[i]}.

    L_bank, R_bank: (A, r, b, b), fp32 (a ``gsoft_bank_build`` entry) or
    x's dtype; ids: (B,) int64 slots; x: (B, T, d). The port's own entry,
    no JAX counterpart: JAX gathers and casts (``jnp.take(...).astype``)
    and calls ``gs_banked_transform_T``. CUDA: the kernel reads the ids and
    rounds the bank entries to x's dtype on the device (one launch, no
    gather or cast); CPU: the gather, the cast and the plain version."""
    return gs_fused_T_bank(x.contiguous(), L_bank, R_bank, ids)


def householder_banked(V: torch.Tensor, x: torch.Tensor,
                       use_pallas: bool = False) -> torch.Tensor:
    """Per-row Householder-product rotation y[i] = x[i] Q_i (HOFT bank).

    V: (B, k, d) pre-normalized unit reflection vectors; x: (B, T, d). No
    kernel (O(k d) per token, small beside the projection it precedes): the
    plain version on every device. ``use_pallas`` is ignored."""
    del use_pallas
    return ref.householder_banked_ref(V, x)


def givens_banked(C: torch.Tensor, S: torch.Tensor, x: torch.Tensor,
                  use_pallas: bool = False) -> torch.Tensor:
    """Per-row Givens-round rotation y[i] = x[i] Q_i (GOFT bank).

    C, S: (B, m, d//2) pre-evaluated cos/sin; x: (B, T, d). No kernel, as
    for the Householder bank. ``use_pallas`` is ignored."""
    del use_pallas
    return ref.givens_banked_ref(C, S, x)


def q_matmul(x: torch.Tensor, q: torch.Tensor, scale,
             use_pallas: bool = False) -> torch.Tensor:
    """Quantized-weight matmul y = x @ dequant(q, scale), the dequant in the
    epilogue. x: (..., K); q: (K, N) int8; scale (1, N) or a scalar. The
    serving hot path of ``ModelRuntime.quantized``. ``use_pallas`` is
    ignored."""
    del use_pallas
    y = _q_matmul(_tokens(x), q, scale)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def gs_q_matmul(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                q: torch.Tensor, scale,
                use_pallas: bool = False) -> torch.Tensor:
    """Fused activation-side GS rotation + quantized matmul:
    y = round(x Q_gs) @ dequant(q, scale). L, R: (r, b, b); x: (..., d).
    One row of the banked kernel. ``use_pallas`` is ignored."""
    del use_pallas
    x2 = _tokens(x)
    y = _gs_q_matmul(x2[None], L[None].contiguous(), R[None].contiguous(),
                     q, scale)[0]
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def gs_q_matmul_banked(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                       q: torch.Tensor, scale,
                       use_pallas: bool = False) -> torch.Tensor:
    """Per-row fused rotate + quantized matmul (multi-adapter quantized
    serving): L, R (B, r, b, b) per-row GS blocks in x's dtype, x (B, T, d),
    ONE shared quantized weight q (d, N). Row i computes round(x_i Q_i) @
    dequant(q): one launch for all rows (the JAX package vmaps the kernel).
    ``use_pallas`` is ignored."""
    del use_pallas
    return _gs_q_matmul(x.contiguous(), L.contiguous(), R.contiguous(), q,
                        scale)


def gs_q_matmul_bank(L_bank: torch.Tensor, R_bank: torch.Tensor,
                     ids: torch.Tensor, x: torch.Tensor, q: torch.Tensor,
                     scale) -> torch.Tensor:
    """``gs_q_matmul_banked`` with the factors read from a bank by slot id:
    y[i] = round(x[i] Q_{ids[i]}) @ dequant(q). L_bank, R_bank (A, r, b,
    b) fp32 or x's dtype, ids (B,) int64, x (B, T, d), q (d, N) int8. The
    port's own entry (JAX gathers, then calls ``gs_q_matmul_banked``): on
    the card one call, no gather or cast."""
    return _gs_q_matmul_bank(x.contiguous(), L_bank, R_bank, ids, q, scale)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor, kv_len, *,
                    scale: float = 0.0,
                    use_pallas: bool = False) -> torch.Tensor:
    """Single-token decode attention through a KV page table.

    q: (B, H, D) one query per row; k_pages / v_pages: (P, page, K, D)
    shared page pools; table: (B, W) page ids (unused entries point at the
    garbage page 0); kv_len: (B,) valid prefix length per row. The paged
    engine's decode hot path. ``use_pallas`` is ignored."""
    del use_pallas
    return paged_decode(q, k_pages, v_pages, table, kv_len, scale=scale)


def ssd(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 64,
        use_pallas: bool = False) -> torch.Tensor:
    """Mamba2 SSD scan. x (T, H, P) or batched (Nb, T, H, P); loga (.., T,
    H); B, C (.., T, H, N) -> y like x. CUDA: the SSD kernel, one launch
    for the whole batch (its own chunk); CPU: ``ref.ssd_chunked_ref`` at
    ``pick_chunk(T, chunk)``, as the JAX package's default path.
    ``use_pallas`` is ignored."""
    del use_pallas
    if x.dim() == 3:
        return _ssd(x[None], loga[None], B[None], C[None], chunk)[0]
    return _ssd(x, loga, B, C, chunk)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, use_pallas: bool = False,
              blk: int = 128) -> torch.Tensor:
    """Multi-head attention over (B, S, H, D) activations with GQA (k, v
    (B, Sk, KH, D), H a multiple of KH). CUDA: the flash kernel reads the
    (B, S, H, D) layout in place and KV head h // (H / KH); CPU:
    ``ref.flash_ref`` over repeated KV heads, as the JAX default path. A
    non-causal Sk that is not a multiple of ``min(blk, Sk)`` raises
    ValueError on both, as the JAX kernel does. ``use_pallas`` is
    ignored."""
    del use_pallas
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, blk_q=blk,
                          blk_k=blk)
    return out.transpose(1, 2)
