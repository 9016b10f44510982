"""PEFT adapters — the GSOFT and Double GSOFT part of
``repro/core/adapters.py``.

An adapter is an ``AdapterSpec`` (static dataclass) plus a dict of tensors.
GSOFT applies Q = P^T L P R (Cayley-orthogonal b x b blocks) on the input
dim of a frozen weight W (d_in, d_out), used as y = x @ W:

    W_eff = materialize(spec, params, W) = Q @ W      (training, merge)
    x -> x Q                                          (activation side)

Double GSOFT (paper §4) rotates both sides, W_eff = Q_U W Q_V, with Q_V on
the output dim (block size ``block_size_out``, 0 -> the input rule).

Every rotation goes through ``kernels.ops``, so on the card it runs the CUDA
kernels (forward and, through the autograd rules of ``kernels.dispatch``,
backward) and on the CPU their plain versions. Public entry points dispatch
through the ``core.methods`` registry; an unknown method raises KeyError.

Weight convention: W has shape (d_in, d_out); leading batch dims (stacked
layers) get independent adapters per slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import stack_layers

from .gs import gsoft_layout, pick_block_size
from .orthogonal import cayley, skew

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """Static description of one adapter attached to one weight. Field names
    and defaults equal ``repro.core.adapters.AdapterSpec``'s GSOFT fields."""
    method: str
    d_in: int
    d_out: int
    block_size: int = 32
    block_size_out: int = 0        # double_gsoft output side (0 -> same rule)
    neumann_order: Optional[int] = None
    use_scale: bool = False
    use_pallas: bool = False       # kept for one-for-one conversion; unread
    batch: Tuple[int, ...] = ()

    def resolved_block(self, d: int, b: int) -> int:
        return b if d % b == 0 and (d // b) <= b else pick_block_size(d, b)


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
    shape = tuple(spec.batch) + gsoft_layout(spec.d_in, b_in).param_shape
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
    shape = tuple(spec.batch) + gsoft_layout(spec.d_in, b).param_shape
    eye = torch.eye(b, dtype=torch.float32, device=device).expand(shape)
    processed = [None if p is None else
                 {k: cayley(skew(p[k].to(device=device, dtype=torch.float32)),
                            neumann_order=spec.neumann_order)
                  for k in ("L", "R")}
                 for p in params_by_slot]
    return _stack_slots(spec, {"L": eye, "R": eye}, processed)


def gs_rotate_banked(entry: Params, ids: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Per-row activation-side GSOFT: row i of x gets x_i Q_{ids[i]}.

    ``entry``: a ``gsoft_bank_build`` stack {"L": (A, r, b, b), "R": ...}
    (layer dims already sliced off); ids: (B,) slot per row; x: (B, T, d).
    The per-row factors are gathered and cast to x.dtype, then rotated by
    the ``gs_fused_T`` kernel on the card."""
    L = entry["L"].index_select(0, ids).to(x.dtype)          # (B, r, b, b)
    R = entry["R"].index_select(0, ids).to(x.dtype)
    return kernel_ops.gs_banked_transform_T(L, R, x)


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
    shape = tuple(spec.batch) + gsoft_layout(spec.d_out,
                                             _out_block(spec)).param_shape
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
# public entry points — registry dispatch only
# ---------------------------------------------------------------------------

def init_adapter(spec: AdapterSpec, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda") -> Params:
    """Initialize adapter params (orthogonal methods start at Q = I) on
    ``device``; without a card the default raises rather than using the
    CPU."""
    from . import methods
    device = resolve_device(device)
    p = methods.get(spec.method).init_params(spec, generator, dtype, device)
    if spec.use_scale:
        p["scale"] = torch.ones(tuple(spec.batch) + (spec.d_out,), dtype=dtype,
                                device=device)
    return p


def materialize(spec: AdapterSpec, params: Params,
                W: torch.Tensor) -> torch.Tensor:
    """W_eff from frozen W + adapter params, differentiable w.r.t. the
    params. Batch dims are a loop over the leading dim (the JAX package
    vmaps); each slice is one kernel launch per rotation."""
    from . import methods
    if spec.batch:
        inner = dataclasses.replace(spec, batch=tuple(spec.batch[1:]))
        # the weight-side rotation returns each slice as the transpose of
        # its contiguous token rows; stack_layers keeps that layout
        return stack_layers([
            materialize(inner, {k: v[i] for k, v in params.items()}, W[i])
            for i in range(W.shape[0])])
    dtype = W.dtype
    Wf = methods.get(spec.method).materialize(spec, params, W)
    if spec.use_scale:
        Wf = Wf * params["scale"][None, :].to(dtype)
    return Wf.to(dtype)
