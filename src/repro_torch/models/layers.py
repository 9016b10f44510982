"""Shared building blocks (port of ``repro/models/layers.py``, the parts the
ported families' serving and training paths use).

Conventions as in the JAX package: activations (B, S, D); weights
(d_in, d_out) used as y = x @ W, layer-stacked weights with a leading layer
dim; params are plain dicts of tensors.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.quant.core import QuantTensor

Rot = Optional[Callable[[str, torch.Tensor], torch.Tensor]]


def qlinear(x: torch.Tensor, w, rot: Rot = None, name: str = "",
            cast: bool = False) -> torch.Tensor:
    """Every base-weight projection routes through here. ``rot(name, x)`` is
    the optional per-request adapter rotation applied to the inputs of
    projection ``name``. ``cast=True`` casts a plain weight to the
    activation dtype first (the lm_head call site).

    ``w`` is a plain weight (y = x @ w) or a ``QuantTensor`` (int8 codes +
    per-channel scales): then the matmul runs ``ops.q_matmul`` with the
    dequant in the epilogue, and a rotator's ``quant_rotation`` hook hands
    GSOFT's bank and slot ids to the fused ``ops.gs_q_matmul_bank`` (one
    call for rotation and int8 matmul) while other method stacks rotate x
    first. Quantized matmuls return x's dtype.
    """
    if isinstance(w, QuantTensor):
        factors = None
        if rot is not None:
            if hasattr(rot, "quant_rotation"):
                x, factors = rot.quant_rotation(name, x, x.dtype)
            else:
                x = rot(name, x)
        if factors is not None:
            return kernel_ops.gs_q_matmul_bank(*factors, x, w.q, w.scale)
        return kernel_ops.q_matmul(x, w.q, w.scale)
    if rot is not None:
        x = rot(name, x)
    return x @ (w.to(x.dtype) if cast else w)


def row_linear(x: torch.Tensor, w, rot: Rot, name: str, tp) -> torch.Tensor:
    """Row-parallel projection under tensor parallelism (``tp`` a
    ``distrib.tp.TPShard``): x holds this rank's slice of the input
    features, w the matching rows, and the partial products all-reduce
    (``tp.leave``: reduce-scattered over the sequence under sequence
    parallelism).
    A rotation mixes every feature of its input, so a rotated input is
    all-gathered, rotated whole (the banked kernels at the full width) and
    cut back to the rank's window before the local matmul (for int8:
    ``q_matmul`` at the local K; the fused ``gs_q_matmul_bank`` needs the
    whole row)."""
    if rot is not None and getattr(rot, "adapts", lambda _n: True)(name):
        x = tp.local_cols(rot(name, tp.all_gather(x, -1)))
    return tp.leave(qlinear(x, w))


# ---------------------------------------------------------------------------
# layer stacks: one tensor (L, ...) per weight, used one layer at a time
# ---------------------------------------------------------------------------

def stack_layers(slices) -> torch.Tensor:
    """torch.stack of per-layer matrices, keeping their memory layout: when
    every slice is the transpose of a contiguous matrix (as the weight-side
    GS rotation and the matmul gradients of such a weight produce them),
    stack the contiguous matrices and transpose the stack (a view), instead
    of copying across strides."""
    if all(s.dim() >= 2 and s.transpose(-1, -2).is_contiguous() for s in slices):
        return torch.stack([s.transpose(-1, -2) for s in slices]).transpose(-1, -2)
    return torch.stack(slices)


def cat_layers(chunks) -> torch.Tensor:
    """torch.cat of layer stacks along dim 0, keeping their layout as
    ``stack_layers`` does (chunks that are transposes of contiguous stacks
    join as one such stack)."""
    if all(c.dim() >= 2 and c.transpose(-1, -2).is_contiguous()
           for c in chunks):
        return torch.cat([c.transpose(-1, -2) for c in chunks]).transpose(-1, -2)
    return torch.cat(chunks)


class _UnbindLayers(torch.autograd.Function):
    """torch.unbind over the layer dim whose backward stacks the layer
    gradients with ``stack_layers`` (autograd's own stacks them contiguous,
    a strided copy when they come transposed)."""

    @staticmethod
    def forward(ctx, t):
        ctx.shape, ctx.dtype, ctx.device = t.shape, t.dtype, t.device
        return tuple(t.unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        zero = None
        full = []
        for g in grads:
            if g is None:
                if zero is None:
                    zero = torch.zeros(ctx.shape[1:], dtype=ctx.dtype,
                                       device=ctx.device)
                g = zero
            full.append(g)
        return stack_layers(full)


def unbind_layers(t):
    """The layers of a layer-stacked tensor (or QuantTensor) as views (see
    _UnbindLayers)."""
    if isinstance(t, QuantTensor):
        return t.unbind()
    if t.requires_grad:
        return _UnbindLayers.apply(t)
    return t.unbind(0)


# ---------------------------------------------------------------------------
# init helpers (seeded torch.Generator on the target device)
# ---------------------------------------------------------------------------

def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    """The init functions' generator for draws on ``device``, seeded with
    ``seed``. The meta device (shapes only: ``models.api.param_count``)
    draws nothing and takes a CPU generator."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen


def _normal(shape, gen: torch.Generator, device, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def stacked_dense_init(gen: torch.Generator, n: int, d_in: int, d_out: int,
                       dtype, device, scale: Optional[float] = None):
    """(n, d_in, d_out), drawn one slice at a time so the fp32 draw never
    holds more than one layer (full-width weights are GBs)."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((n, d_in, d_out), dtype=dtype, device=device)
    for i in range(n):
        w[i] = _normal((d_in, d_out), gen, device, s, dtype)
    return w


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device):
    return _normal((vocab, d), gen, device, 1.0, dtype)


# ---------------------------------------------------------------------------
# norms + RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics; the normalized tensor drops to the input dtype before
    the (1 + scale) multiply. Scales are zero-initialized."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(dt)
    return y * (1.0 + scale).to(dt)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S). Rotates the two halves of D."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs       # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def keep_all(_path: str, leaf):
    """The default ``keep`` of the init functions: every leaf whole."""
    return leaf


def init_mlp(gen: torch.Generator, d: int, f: int, mlp_type: str, dtype,
             device, keep=keep_all,
             prefix: str = "") -> Dict[str, torch.Tensor]:
    """One unstacked MLP (the hybrid's shared block)."""
    return {k: keep(prefix + k, v[0])
            for k, v in init_stacked_mlp(gen, 1, d, f, mlp_type, dtype,
                                         device).items()}


def init_stacked_mlp(gen: torch.Generator, n: int, d: int, f: int,
                     mlp_type: str, dtype, device, keep=keep_all,
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"wi", "wo"} plus "wg" for the gated MLPs (swiglu, geglu); ``gelu``
    has no gate. ``keep(path, leaf)`` takes each weight as it is drawn (a
    split model keeps its rank's slice and drops the rest before the
    next)."""
    shapes = [("wi", d, f), ("wo", f, d)]
    if _gated(mlp_type):
        shapes.append(("wg", d, f))
    return {k: keep(f"{prefix}{k}", stacked_dense_init(gen, n, di, do, dtype,
                                                      device))
            for k, di, do in shapes}


def _gated(mlp_type: str) -> bool:
    if mlp_type not in ("swiglu", "geglu", "gelu"):
        raise ValueError(f"unknown mlp_type {mlp_type!r}")
    return mlp_type != "gelu"


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (JAX's ``gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, mlp_type: str,
              rot: Rot = None, tp=None) -> torch.Tensor:
    """The MLP: swiglu ``silu(x wg) * (x wi)``, geglu ``gelu(x wg) * (x
    wi)``, gelu ``gelu(x wi)``, then ``wo`` (GELU with the tanh
    approximation, as in JAX). ``rot(name, x)`` optionally rotates the
    inputs of wi / wg / wo. Under tensor parallelism with d_ff split, wi /
    wg are column-parallel (local d_ff; ``tp.enter`` at the input) and wo
    row-parallel."""
    gated = _gated(mlp_type)
    split = tp is not None and tp.ff_split
    if tp is not None:
        x = tp.enter(x, split)
    h = qlinear(x, p["wi"], rot, "wi")
    if gated:
        act = F.silu if mlp_type == "swiglu" else gelu_tanh
        h = act(qlinear(x, p["wg"], rot, "wg")) * h
    else:
        h = gelu_tanh(h)
    if split:
        return row_linear(h, p["wo"], rot, "wo", tp)
    y = qlinear(h, p["wo"], rot, "wo")
    return y if tp is None else tp.leave(y, False)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return torch.tanh(logits / cap) * cap


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  vocab_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over valid tokens; logits (B, S, Vp) may be vocab-padded (the
    padded columns are masked out). The max subtracted for stability is taken
    without gradient, as in the JAX package. Returns (loss, accuracy)."""
    vp = logits.shape[-1]
    l32 = logits.to(torch.float32)
    if vocab_size and vocab_size < vp:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        l32 = l32.masked_fill(pad, -1e30)
    m = torch.amax(l32, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(l32 - m), dim=-1)) + m[..., 0]
    gold = torch.gather(l32, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    correct = (torch.argmax(l32, dim=-1) == labels).to(torch.float32)
    valid = (torch.ones_like(nll) if valid is None
             else valid.to(torch.float32))
    denom = torch.clamp(valid.sum(), min=1.0)
    return (nll * valid).sum() / denom, (correct * valid).sum() / denom
