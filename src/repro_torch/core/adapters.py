"""PEFT adapters (port of ``repro/core/adapters.py``): GSOFT and Double
GSOFT (the paper), and the classes it unifies or compares against — OFT
(block-diagonal), BOFT (block butterfly), Householder products (HOFT),
Givens rounds (GOFT) and LoRA.

An adapter is an ``AdapterSpec`` (static dataclass) plus a dict of tensors.
The orthogonal methods apply Q on the input dim of a frozen weight W
(d_in, d_out), used as y = x @ W:

    W_eff = materialize(spec, params, W) = Q @ W      (training, merge)
    x -> x Q                                          (activation side)

GSOFT's Q = P^T L P R (Cayley-orthogonal b x b blocks); Double GSOFT
(paper §4) rotates both sides, W_eff = Q_U W Q_V, with Q_V on the output
dim (block size ``block_size_out``, 0 -> the input rule); LoRA adds
(alpha / r) A B and has no activation-side form.

The GS rotations and the block-diagonal products of OFT and BOFT go through
``kernels.ops``, so on the card they run the CUDA kernels (forward and,
through the autograd rules of ``kernels.dispatch``, backward) and on the
CPU their plain versions. Householder and Givens are plain torch on every
device (they have no kernel in the JAX package either). Public entry
points dispatch through the ``core.methods`` registry; an unknown method
raises KeyError.

Weight convention: W has shape (d_in, d_out); leading batch dims (stacked
layers, layers x experts) get independent adapters per slice, rotated as
one stack (``materialize``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import givens_rotate
from repro_torch.models.layers import cat_layers, stack_layers

from .gs import block_diag_matmul, gsoft_layout, pick_block_size
from .orthogonal import cayley, skew
from .permutations import PermSpec, apply_perm

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """Static description of one adapter attached to one weight. Field names
    and defaults equal ``repro.core.adapters.AdapterSpec``'s."""
    method: str
    d_in: int
    d_out: int
    block_size: int = 32
    block_size_out: int = 0        # double_gsoft output side (0 -> same rule)
    rank: int = 8                  # lora
    alpha: float = 16.0            # lora scaling
    boft_factors: int = 2          # BOFT m
    reflections: int = 4           # householder factor count (even)
    givens_rounds: int = 4         # givens brick-wall round count
    neumann_order: Optional[int] = None
    use_scale: bool = False
    use_pallas: bool = False       # kept for one-for-one conversion; unread
    batch: Tuple[int, ...] = ()

    def resolved_block(self, d: int, b: int) -> int:
        return b if d % b == 0 and (d // b) <= b else pick_block_size(d, b)


# ---------------------------------------------------------------------------
# BOFT butterfly permutations
# ---------------------------------------------------------------------------

def butterfly_sigma(d: int, b: int, level: int) -> np.ndarray:
    """Gather order for BOFT butterfly level (1-indexed).

    Half-blocks of size b/2 are paired at half-block stride 2^(level-1):
    level 1 groups contiguous blocks; deeper levels pair at doubling
    distance, reaching density at m = 1 + log2(d/b) (BOFT's bound)."""
    if b % 2 and level > 1:
        raise ValueError("BOFT butterfly needs even block size")
    h = b // 2 if b > 1 else 1
    nh = d // h
    s = 2 ** (level - 1)
    if nh % (2 * s):
        raise ValueError(f"butterfly level {level} invalid for d={d}, b={b}: "
                         f"{nh} half-blocks not divisible by {2 * s}")
    order = []
    for base in range(0, nh, 2 * s):
        for off in range(s):
            p1, p2 = base + off, base + off + s
            order.extend(range(p1 * h, (p1 + 1) * h))
            order.extend(range(p2 * h, (p2 + 1) * h))
    return np.asarray(order)


def max_butterfly_levels(d: int, b: int) -> int:
    """Deepest valid level: level l tiles the d/(b/2) half-blocks into
    groups of 2^l, so it needs 2^l | num_half_blocks."""
    nh = d // max(b // 2, 1)
    lvl = 0
    while nh % (2 ** (lvl + 1)) == 0 and 2 ** (lvl + 1) <= nh:
        lvl += 1
    return max(1, lvl)


def _boft_depth(spec: "AdapterSpec", b: int) -> int:
    return min(spec.boft_factors, max_butterfly_levels(spec.d_in, b))


@functools.lru_cache(maxsize=64)
def _butterfly_perm(d: int, b: int, level: int) -> Tuple[PermSpec, PermSpec]:
    """(P, P^-1) of butterfly level ``level``, built once per shape."""
    spec = PermSpec.from_sigma(butterfly_sigma(d, b, level))
    return spec, spec.inverse()


def _stack_slots(spec: AdapterSpec, identity: Params,
                 processed: Sequence[Optional[Params]]) -> Params:
    """Stack per-slot factors along a new A axis placed after the weight's
    batch dims (None -> the identity)."""
    axis = len(spec.batch)
    return {key: torch.stack([ident if p is None else p[key]
                              for p in processed], dim=axis)
            for key, ident in identity.items()}


# ---------------------------------------------------------------------------
# GSOFT  (Q = P^T L P R — the paper's two-factor GS rotation)
# ---------------------------------------------------------------------------

def _gs_rotate(d: int, b: int, L_k: torch.Tensor, R_k: torch.Tensor,
               W: torch.Tensor, neumann: Optional[int],
               transpose_side: bool) -> torch.Tensor:
    """Apply Q = P^T L P R, built from the unconstrained blocks L_k, R_k,
    to W.

    transpose_side=False:  Q @ W    (Q on rows / input dim; the columns of W
                                     are the rotation's tokens)
    transpose_side=True:   W @ Q    (Q on columns / output dim; the rows of W
                                     are the tokens of the transpose rotation)

    The Cayley solve runs in fp32; the orthogonal blocks are cast to W's
    dtype before the kernels, as in the JAX package."""
    gsoft_layout(d, b)                       # validates b | d
    L = cayley(skew(L_k), neumann_order=neumann).to(W.dtype)
    R = cayley(skew(R_k), neumann_order=neumann).to(W.dtype)
    if transpose_side:
        return kernel_ops.gs_transform_T(L, R, W)
    return kernel_ops.gs_transform(L, R, W.transpose(-1, -2)).transpose(-1, -2)


def gsoft_init(spec: AdapterSpec, generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = "cuda") -> Params:
    """Zero blocks: K = 0, so Q = I and W_eff == W."""
    del generator  # orthogonal methods start at Q = I
    device = resolve_device(device)
    b_in = spec.resolved_block(spec.d_in, spec.block_size)
    shape = (tuple(spec.batch)
             + gsoft_layout(spec.d_in, b_in).lspec.param_shape)
    return {"L": torch.zeros(shape, dtype=dtype, device=device),
            "R": torch.zeros(shape, dtype=dtype, device=device)}


def gsoft_materialize(spec: AdapterSpec, params: Params,
                      W: torch.Tensor) -> torch.Tensor:
    b = spec.resolved_block(spec.d_in, spec.block_size)
    return _gs_rotate(spec.d_in, b, params["L"], params["R"], W,
                      spec.neumann_order, transpose_side=False)


def gsoft_apply_T(spec: AdapterSpec, params: Params,
                  x: torch.Tensor) -> torch.Tensor:
    """x -> x Q = (Q^T x^T)^T: rotate the activations instead of the weight."""
    L = cayley(skew(params["L"]), neumann_order=spec.neumann_order)
    R = cayley(skew(params["R"]), neumann_order=spec.neumann_order)
    return kernel_ops.gs_transform_T(L.to(x.dtype), R.to(x.dtype), x)


def gsoft_param_count(spec: AdapterSpec) -> int:
    b = spec.resolved_block(spec.d_in, spec.block_size)
    return 2 * (spec.d_in // b) * b * b


def gsoft_bank_build(spec: AdapterSpec, params_by_slot: Sequence[Optional[Params]],
                     device: torch.device) -> Params:
    """{"L": (..., A, r, b, b), "R": ...} of PRE-ORTHOGONALIZED fp32 blocks
    (the Cayley map runs once at build time; adapters are frozen when
    serving). A None slot holds the identity."""
    b = spec.resolved_block(spec.d_in, spec.block_size)
    shape = tuple(spec.batch) + gsoft_layout(spec.d_in,
                                             b).lspec.param_shape
    eye = torch.eye(b, dtype=torch.float32, device=device).expand(shape)
    processed = [None if p is None else
                 {k: cayley(skew(p[k].to(device=device, dtype=torch.float32)),
                            neumann_order=spec.neumann_order)
                  for k in ("L", "R")}
                 for p in params_by_slot]
    return _stack_slots(spec, {"L": eye, "R": eye}, processed)


def gsoft_bank_shard_axes(factor: str, shape) -> Optional[int]:
    """Serve-time TP hook (``MethodOps.bank_shard_axes``): a GSOFT bank
    stack {"L"/"R": (..., A, r, b, b)} may split its BLOCK axis r over the
    mesh 'model' axis. Only worth it for banks that outgrow replication
    (thousands of resident slots)."""
    if factor in ("L", "R") and len(shape) >= 4:
        return len(shape) - 3            # ...the r (block) axis
    return None


def gsoft_bank_gather(entry: Params, ids: torch.Tensor, width: int,
                      all_gather) -> Tuple[Params, torch.Tensor]:
    """The factors of a batch's slots, whole, from a bank split over r
    (``gsoft_bank_shard_axes``): the rotation's permutation crosses
    blocks, so a rank holding r / tp blocks needs the rest. Each rank
    takes its blocks of the batch's slots and ``all_gather(t, dim)``
    joins them in rank order; the result is a (B, r, b, b) bank read by
    ids 0..B-1. ``width`` is the rotated row's d = r * b; an entry that
    already holds every block (not split) comes back as it is."""
    L = entry["L"]
    if L.shape[-3] * L.shape[-1] == width:
        return entry, ids
    out = {k: all_gather(v.index_select(0, ids).contiguous(), v.dim() - 3)
           for k, v in entry.items()}
    return out, torch.arange(ids.shape[0], device=ids.device)


def gs_rotate_banked(entry: Params, ids: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Per-row activation-side GSOFT: row i of x gets x_i Q_{ids[i]}.

    ``entry``: a ``gsoft_bank_build`` stack {"L": (A, r, b, b), "R": ...}
    (layer dims already sliced off); ids: (B,) slot per row; x: (B, T, d).
    On the card the ``gs_fused_T`` kernel reads each row's factors from the
    bank by slot id and rounds them to x.dtype itself (JAX gathers and
    casts first; the result is the same); on the CPU they are gathered."""
    return kernel_ops.gs_bank_transform_T(entry["L"], entry["R"], ids, x)


def gsoft_quant_fuse(entry: Params, ids: torch.Tensor,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """The hand-off to the fused rotate + quantized matmul
    (``ops.gs_q_matmul_bank``): the bank's (L, R) and the slot ids, read
    by the kernel on the card and rounded to the activations' ``dtype``
    there (rotations stay in float over int8 base weights). JAX hands over
    gathered blocks cast to ``dtype`` instead."""
    del dtype     # the kernel rounds to x's dtype, which the caller passes
    return entry["L"], entry["R"], ids


# ---------------------------------------------------------------------------
# Double GSOFT  (W_eff = Q_U W Q_V)
# ---------------------------------------------------------------------------

def _out_block(spec: AdapterSpec) -> int:
    return spec.resolved_block(spec.d_out, spec.block_size_out or spec.block_size)


def double_gsoft_init(spec: AdapterSpec,
                      generator: Optional[torch.Generator] = None,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = "cuda") -> Params:
    """GSOFT's input-side blocks plus zero output-side blocks L_v, R_v."""
    p = gsoft_init(spec, generator, dtype, device)
    shape = (tuple(spec.batch)
             + gsoft_layout(spec.d_out, _out_block(spec)).lspec.param_shape)
    p["L_v"] = torch.zeros(shape, dtype=dtype, device=p["L"].device)
    p["R_v"] = torch.zeros(shape, dtype=dtype, device=p["L"].device)
    return p


def double_gsoft_materialize(spec: AdapterSpec, params: Params,
                             W: torch.Tensor) -> torch.Tensor:
    b_in = spec.resolved_block(spec.d_in, spec.block_size)
    Wf = _gs_rotate(spec.d_in, b_in, params["L"], params["R"], W,
                    spec.neumann_order, transpose_side=False)
    return _gs_rotate(spec.d_out, _out_block(spec), params["L_v"],
                      params["R_v"], Wf, spec.neumann_order,
                      transpose_side=True)


def double_gsoft_param_count(spec: AdapterSpec) -> int:
    b_out = _out_block(spec)
    return gsoft_param_count(spec) + 2 * (spec.d_out // b_out) * b_out * b_out


# ---------------------------------------------------------------------------
# OFT  (block-diagonal Q)
# ---------------------------------------------------------------------------

def _eye_stack(b: int, shape: Tuple[int, ...], device) -> torch.Tensor:
    return torch.eye(b, dtype=torch.float32, device=device).expand(shape)


def _cayley_slots(spec: AdapterSpec, params_by_slot, device) -> list:
    """{"Q": Cayley(skew(K))} in fp32 per slot (None stays None)."""
    return [None if p is None else
            {"Q": cayley(skew(p["K"].to(device=device, dtype=torch.float32)),
                         neumann_order=spec.neumann_order)}
            for p in params_by_slot]


def oft_init(spec: AdapterSpec, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = "cuda") -> Params:
    del generator
    b = spec.resolved_block(spec.d_in, spec.block_size)
    shape = tuple(spec.batch) + (spec.d_in // b, b, b)
    return {"K": torch.zeros(shape, dtype=dtype, device=resolve_device(device))}


def oft_materialize(spec: AdapterSpec, params: Params,
                    W: torch.Tensor) -> torch.Tensor:
    """Block-diagonal orthogonal Q @ W (OFT): the columns of W are the
    ``bdmm`` kernel's tokens."""
    Q = cayley(skew(params["K"]), neumann_order=spec.neumann_order)
    return block_diag_matmul(Q, W.transpose(-1, -2)).transpose(-1, -2)


def oft_apply_T(spec: AdapterSpec, params: Params,
                x: torch.Tensor) -> torch.Tensor:
    Q = cayley(skew(params["K"]), neumann_order=spec.neumann_order)
    return block_diag_matmul(Q.transpose(-1, -2), x)


def oft_param_count(spec: AdapterSpec) -> int:
    b = spec.resolved_block(spec.d_in, spec.block_size)
    return (spec.d_in // b) * b * b


def oft_bank_build(spec: AdapterSpec, params_by_slot: Sequence[Optional[Params]],
                   device: torch.device) -> Params:
    """{"Q": (..., A, r, b, b)} PRE-ORTHOGONALIZED fp32 blocks."""
    b = spec.resolved_block(spec.d_in, spec.block_size)
    eye = _eye_stack(b, tuple(spec.batch) + (spec.d_in // b, b, b), device)
    return _stack_slots(spec, {"Q": eye},
                        _cayley_slots(spec, params_by_slot, device))


def oft_rotate_banked(entry: Params, ids: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Per-row x_i Q_{ids[i]} for block-diagonal Q: one banked ``bdmm``
    launch over all rows, the per-row blocks read transposed in place."""
    Q = entry["Q"].index_select(0, ids).to(x.dtype)          # (B, r, b, b)
    return kernel_ops.bdmm_banked(Q, x, transpose_blocks=True)


# ---------------------------------------------------------------------------
# BOFT  (butterfly product Q = B_m .. B_1)
# ---------------------------------------------------------------------------

def boft_init(spec: AdapterSpec, generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float32,
              device: DeviceLike = "cuda") -> Params:
    del generator
    b = spec.resolved_block(spec.d_in, spec.block_size)
    shape = tuple(spec.batch) + (_boft_depth(spec, b), spec.d_in // b, b, b)
    return {"K": torch.zeros(shape, dtype=dtype, device=resolve_device(device))}


def boft_materialize(spec: AdapterSpec, params: Params,
                     W: torch.Tensor) -> torch.Tensor:
    """Q = B_m .. B_1 with butterfly factors; returns Q @ W. Per level: a
    gather (group), a ``bdmm`` (rotate), the inverse gather (scatter back)."""
    b = spec.resolved_block(spec.d_in, spec.block_size)
    Q = cayley(skew(params["K"]), neumann_order=spec.neumann_order)
    y = W.transpose(-1, -2)                  # the columns of W as vectors
    for lvl in range(Q.shape[-4]):
        perm, inv = _butterfly_perm(spec.d_in, b, lvl + 1)
        y = apply_perm(block_diag_matmul(Q.select(-4, lvl),
                                         apply_perm(y, perm)), inv)
    return y.transpose(-1, -2)


def boft_apply_T(spec: AdapterSpec, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """x -> x Q = (Q^T x^T)^T: levels in reverse order, blocks transposed."""
    b = spec.resolved_block(spec.d_in, spec.block_size)
    Q = cayley(skew(params["K"]), neumann_order=spec.neumann_order)
    y = x
    for lvl in reversed(range(Q.shape[0])):
        perm, inv = _butterfly_perm(spec.d_in, b, lvl + 1)
        y = apply_perm(block_diag_matmul(Q[lvl].transpose(-1, -2),
                                         apply_perm(y, perm)), inv)
    return y


def boft_param_count(spec: AdapterSpec) -> int:
    b = spec.resolved_block(spec.d_in, spec.block_size)
    return _boft_depth(spec, b) * (spec.d_in // b) * b * b


def boft_bank_build(spec: AdapterSpec,
                    params_by_slot: Sequence[Optional[Params]],
                    device: torch.device) -> Params:
    """{"Q": (..., A, m, r, b, b)} PRE-ORTHOGONALIZED fp32 blocks."""
    b = spec.resolved_block(spec.d_in, spec.block_size)
    shape = tuple(spec.batch) + (_boft_depth(spec, b), spec.d_in // b, b, b)
    return _stack_slots(spec, {"Q": _eye_stack(b, shape, device)},
                        _cayley_slots(spec, params_by_slot, device))


def boft_rotate_banked(entry: Params, ids: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Per-row x_i Q_{ids[i]} for butterfly Q: per level (reversed), a
    butterfly gather, a banked ``bdmm`` with the per-row blocks read
    transposed in place, and the inverse gather. Each level's blocks are
    gathered on their own, so the kernel gets them contiguous."""
    Q = entry["Q"]                                        # (A, m, r, b, b)
    b = Q.shape[-1]
    y = x
    for lvl in reversed(range(Q.shape[1])):
        perm, inv = _butterfly_perm(x.shape[-1], b, lvl + 1)
        Ql = Q[:, lvl].index_select(0, ids).to(x.dtype)   # (B, r, b, b)
        y = apply_perm(kernel_ops.bdmm_banked(
            Ql, apply_perm(y, perm), transpose_blocks=True), inv)
    return y


# ---------------------------------------------------------------------------
# Householder products  (HOFT: Q = H_1 .. H_k,  H_i = I - 2 v_i v_i^T)
# ---------------------------------------------------------------------------

def _hh_reflections(spec: AdapterSpec) -> int:
    k = spec.reflections
    if k <= 0 or k % 2:
        raise ValueError(
            f"householder needs a positive EVEN reflection count (identity "
            f"init is a product of paired reflections); got {k}")
    return k


def _hh_identity(spec: AdapterSpec, k: int, device) -> torch.Tensor:
    """k (even) copies of e_1: H(e_1)^2 = I exactly."""
    v = torch.zeros(tuple(spec.batch) + (k, spec.d_in), dtype=torch.float32,
                    device=device)
    v[..., 0] = 1.0
    return v


def _hh_unit(v: torch.Tensor) -> torch.Tensor:
    """Safe fp32 unit vectors over the last axis; a (near-)zero vector falls
    back to e_1, so H stays exactly orthogonal for every parameter value."""
    v32 = v.to(torch.float32)
    n2 = (v32 * v32).sum(-1, keepdim=True)
    e0 = torch.zeros_like(v32)
    e0[..., 0] = 1.0
    v32 = torch.where(n2 > 1e-12, v32, e0)
    return v32 * torch.rsqrt((v32 * v32).sum(-1, keepdim=True))


def householder_init(spec: AdapterSpec,
                     generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32,
                     device: DeviceLike = "cuda") -> Params:
    del generator
    k = _hh_reflections(spec)
    return {"V": _hh_identity(spec, k, resolve_device(device)).to(dtype)}


def householder_materialize(spec: AdapterSpec, params: Params,
                            W: torch.Tensor) -> torch.Tensor:
    """Q @ W reflection by reflection: H W = W - 2 v (v^T W); no dense Q,
    and d_in needs no block divisibility."""
    k = _hh_reflections(spec)
    Vu = _hh_unit(params["V"]).to(W.dtype)                # (k, d)
    Wf = W
    for i in reversed(range(k)):                          # Q W = H_1(..H_k W)
        v = Vu[i]
        Wf = Wf - 2.0 * torch.outer(v, v @ Wf)
    return Wf


def householder_apply_T(spec: AdapterSpec, params: Params,
                        x: torch.Tensor) -> torch.Tensor:
    """x -> x Q = ((x H_1) H_2) .. H_k;  x H = x - 2 (x.v) v."""
    k = _hh_reflections(spec)
    Vu = _hh_unit(params["V"])
    y = x
    for i in range(k):
        v = Vu[i].to(x.dtype)
        y = y - 2.0 * (y @ v)[..., None] * v
    return y


def householder_param_count(spec: AdapterSpec) -> int:
    return _hh_reflections(spec) * spec.d_in


def householder_bank_build(spec: AdapterSpec,
                           params_by_slot: Sequence[Optional[Params]],
                           device: torch.device) -> Params:
    """{"V": (..., A, k, d)} PRE-NORMALIZED unit reflection vectors; the
    identity slot holds k copies of e_1."""
    k = _hh_reflections(spec)
    processed = [None if p is None else {"V": _hh_unit(p["V"].to(device))}
                 for p in params_by_slot]
    return _stack_slots(spec, {"V": _hh_identity(spec, k, device)}, processed)


def householder_rotate_banked(entry: Params, ids: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    """Per-row x_i Q_{ids[i]} for Householder products (plain torch: no
    kernel, as in the JAX package)."""
    V = entry["V"].index_select(0, ids).to(x.dtype)       # (B, k, d)
    return kernel_ops.householder_banked(V, x)


# ---------------------------------------------------------------------------
# Givens rounds  (GOFT: Q = G_m .. G_1, each G_l one brick-wall round of
# disjoint 2 x 2 plane rotations)
# ---------------------------------------------------------------------------

def _givens_num_rounds(spec: AdapterSpec) -> int:
    m = spec.givens_rounds
    if m <= 0:
        raise ValueError(f"givens needs a positive round count; got {m}")
    return m


def _givens_apply(theta: torch.Tensor, y: torch.Tensor,
                  transpose: bool) -> torch.Tensor:
    """Apply Q = G_{m-1}..G_0 (or Q^T) to vectors on the last axis of y.

    theta: (m, d//2) angles; round l pairs (off + 2k, off + 2k + 1) with
    off = l % 2 and uses its first (d - off) // 2 angles. Q^T = reversed
    rounds with negated angles. fp32 throughout, cast back at the end."""
    d = y.shape[-1]
    t32 = theta.to(torch.float32)
    c_all, s_all = torch.cos(t32), torch.sin(t32)
    y32 = y.to(torch.float32)
    m = theta.shape[0]
    for lvl in (reversed(range(m)) if transpose else range(m)):
        off = lvl % 2
        p = (d - off) // 2
        if p == 0:
            continue
        s = -s_all[lvl, :p] if transpose else s_all[lvl, :p]
        y32 = givens_rotate(y32, c_all[lvl, :p], s, off)
    return y32.to(y.dtype)


def givens_init(spec: AdapterSpec, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = "cuda") -> Params:
    del generator  # theta = 0 -> every round is I -> Q = I
    m = _givens_num_rounds(spec)
    return {"theta": torch.zeros(tuple(spec.batch) + (m, spec.d_in // 2),
                                 dtype=dtype, device=resolve_device(device))}


def givens_materialize(spec: AdapterSpec, params: Params,
                       W: torch.Tensor) -> torch.Tensor:
    """Q @ W round by round on the columns of W (no dense Q)."""
    del spec
    WT = _givens_apply(params["theta"], W.transpose(-1, -2), transpose=False)
    return WT.transpose(-1, -2)


def givens_apply_T(spec: AdapterSpec, params: Params,
                   x: torch.Tensor) -> torch.Tensor:
    """x -> x Q = (Q^T x^T)^T: rounds reversed, angles negated."""
    del spec
    return _givens_apply(params["theta"], x, transpose=True)


def givens_param_count(spec: AdapterSpec) -> int:
    return _givens_num_rounds(spec) * (spec.d_in // 2)


def givens_bank_build(spec: AdapterSpec,
                      params_by_slot: Sequence[Optional[Params]],
                      device: torch.device) -> Params:
    """{"c"/"s": (..., A, m, d//2)} PRE-EVALUATED cos/sin; the identity slot
    is c = 1, s = 0."""
    shape = tuple(spec.batch) + (_givens_num_rounds(spec), spec.d_in // 2)
    f32 = torch.float32
    ident = {"c": torch.ones(shape, dtype=f32, device=device),
             "s": torch.zeros(shape, dtype=f32, device=device)}
    processed = [None if p is None else
                 {"c": torch.cos(p["theta"].to(device=device, dtype=f32)),
                  "s": torch.sin(p["theta"].to(device=device, dtype=f32))}
                 for p in params_by_slot]
    return _stack_slots(spec, ident, processed)


def givens_rotate_banked(entry: Params, ids: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Per-row x_i Q_{ids[i]} for Givens rounds (plain torch: no kernel)."""
    C = entry["c"].index_select(0, ids)                   # (B, m, p)
    S = entry["s"].index_select(0, ids)
    return kernel_ops.givens_banked(C, S, x)


# ---------------------------------------------------------------------------
# LoRA  (low-rank residual — the non-orthogonal baseline)
# ---------------------------------------------------------------------------

def lora_init(spec: AdapterSpec, generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float32,
              device: DeviceLike = "cuda") -> Params:
    """A ~ N(0, 1/d_in) from ``generator`` (on ``device``), B = 0."""
    device = resolve_device(device)
    a = torch.randn(tuple(spec.batch) + (spec.d_in, spec.rank),
                    generator=generator, dtype=dtype, device=device)
    return {"A": a * (1.0 / math.sqrt(spec.d_in)),
            "B": torch.zeros(tuple(spec.batch) + (spec.rank, spec.d_out),
                             dtype=dtype, device=device)}


def lora_materialize(spec: AdapterSpec, params: Params,
                     W: torch.Tensor) -> torch.Tensor:
    scale = spec.alpha / spec.rank
    return W + scale * (params["A"] @ params["B"]).to(W.dtype)


def lora_param_count(spec: AdapterSpec) -> int:
    return spec.rank * (spec.d_in + spec.d_out)


# ---------------------------------------------------------------------------
# public entry points — registry dispatch only
# ---------------------------------------------------------------------------

def init_adapter(spec: AdapterSpec, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda") -> Params:
    """Initialize adapter params on ``device`` (orthogonal methods start at
    Q = I; LoRA at A ~ N from ``generator``, B = 0: either way
    W_eff(init) == W); without a card the default raises rather than using
    the CPU."""
    from . import methods
    device = resolve_device(device)
    p = methods.get(spec.method).init_params(spec, generator, dtype, device)
    if spec.use_scale:
        p["scale"] = torch.ones(tuple(spec.batch) + (spec.d_out,), dtype=dtype,
                                device=device)
    return p


STACK_CHUNK_BYTES = 2 << 30


def _stack_step(W: torch.Tensor) -> int:
    """Leading slices of a stack W that one chunk of ``materialize`` takes:
    as many as fit ``STACK_CHUNK_BYTES``, at least one."""
    return max(1, STACK_CHUNK_BYTES // (W[0].numel() * W.element_size()))


def rotation_launches(spec: AdapterSpec, W: torch.Tensor) -> int:
    """Kernel launches one rotation pass (one GS or ``bdmm`` call of the
    method's materialize) takes for W: one a chunk of a ``stacked``
    method's stack, one a slice for the others, one for a single weight."""
    from . import methods
    if not spec.batch:
        return 1
    if not methods.get(spec.method).stacked:
        return math.prod(spec.batch)
    return -(-W.shape[0] // _stack_step(W))


def materialize(spec: AdapterSpec, params: Params,
                W: torch.Tensor) -> torch.Tensor:
    """W_eff from frozen W + adapter params, differentiable w.r.t. the
    params. A stack W (batch..., d_in, d_out) (layers, or layers x
    experts) gets an adapter per slice, as JAX's ``vmap``: a ``stacked``
    method rotates the whole stack with one launch per rotation (the
    slices are the kernels' rows), in chunks of whole leading slices of at
    most ``STACK_CHUNK_BYTES`` of W (never less than one slice); the
    others (Householder, Givens: plain torch, no kernel) loop over the
    slices."""
    from . import methods
    ops = methods.get(spec.method)
    if spec.batch and not ops.stacked:
        inner = dataclasses.replace(spec, batch=tuple(spec.batch[1:]))
        # the weight-side rotation returns each slice as the transpose of
        # its contiguous token rows; stack_layers keeps that layout
        return stack_layers([
            materialize(inner, {k: v[i] for k, v in params.items()}, W[i])
            for i in range(W.shape[0])])
    if spec.batch:
        step = _stack_step(W)
        if W.shape[0] > step:
            return cat_layers([
                materialize(dataclasses.replace(
                    spec, batch=(min(step, W.shape[0] - i),)
                    + tuple(spec.batch[1:])),
                    {k: v[i:i + step] for k, v in params.items()},
                    W[i:i + step])
                for i in range(0, W.shape[0], step)])
    dtype = W.dtype
    Wf = ops.materialize(spec, params, W)
    if spec.use_scale:
        Wf = Wf * params["scale"].unsqueeze(-2).to(dtype)
    return Wf.to(dtype)


def num_adapter_params(spec: AdapterSpec) -> int:
    from . import methods
    n = methods.get(spec.method).param_count(spec)
    if spec.use_scale:
        n += spec.d_out
    return n * math.prod(spec.batch) if spec.batch else n


def merge(spec: AdapterSpec, params: Params, W: torch.Tensor) -> torch.Tensor:
    """Bake the adapter into the weight (inference; no runtime overhead)."""
    return materialize(spec, params, W)


def apply_activation_side(spec: AdapterSpec, params: Params,
                          x: torch.Tensor) -> torch.Tensor:
    """For input-rotation methods, y = x @ (Q W) == (x Q) @ W: rotate the
    activations instead of the weight."""
    from . import methods
    ops = methods.get(spec.method)
    if ops.apply_activation_side is None:
        raise ValueError(f"activation-side not defined for {spec.method}")
    return ops.apply_activation_side(spec, params, x)
