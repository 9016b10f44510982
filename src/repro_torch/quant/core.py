"""Symmetric int8 quantization and the ``QuantTensor`` a quantized weight
becomes (port of ``repro/quant/core.py``).

``quantize_int8`` / ``dequantize_int8`` take the JAX granularity knobs:

  * ``axis=None`` with no batch dims: one scalar scale (per tensor);
  * ``axis=k``: one scale per slice along ``k``, kept with ``keepdims`` so it
    broadcasts against the codes;
  * ``batch_dims``: leading axes that are independent tensors (stacked layer
    weights), whose scales keep those dims so slicing a layer slices both.

Rounding is half to even (``torch.round``, as ``jnp.round``), so the codes
equal the JAX package's. fp8 is a stub in the JAX package that only runs the
reference einsum; here it raises NotImplementedError (not ported).

``QuantTensor`` is a plain dataclass of int8 codes and fp32 keepdims scales,
mirroring the logical weight's ``shape`` / ``ndim`` / ``dim()`` / ``device``
so shape-driven code (PEFT spec inference, bank building) keeps working.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

INT8_MAX = 127.0

_FP8_MSG = ("fp8 quantization is not ported (the JAX package's fp8 path is a "
            "stub that runs only the reference einsum); use mode='int8'")


def _absmax(x32: torch.Tensor, dims=None) -> torch.Tensor:
    """max |x| over ``dims`` (all when None, keepdim otherwise) as
    max(max x, -min x): the same value without an |x| copy of x."""
    if dims is None:
        return torch.maximum(x32.amax(), -x32.amin())
    return torch.maximum(x32.amax(dim=dims, keepdim=True),
                         -x32.amin(dim=dims, keepdim=True))


def _absmax_scale(x32: torch.Tensor, axis: Optional[int], qmax: float,
                  batch_dims: int = 0, amax_reduce=None) -> torch.Tensor:
    if axis is None and batch_dims == 0:
        amax = _absmax(x32)                          # per-tensor scalar
    else:
        keep = {axis % x32.dim()} if axis is not None else set()
        reduce_axes = tuple(a for a in range(batch_dims, x32.dim())
                            if a not in keep)
        # no axis left to reduce: JAX's ``axis=() or None`` reduces them all
        amax = (_absmax(x32, reduce_axes) if reduce_axes
                else _absmax(x32).reshape((1,) * x32.dim()))
    if amax_reduce is not None:     # a slice of a split weight: the whole's
        amax = amax_reduce(amax)
    return torch.clamp(amax, min=1e-12) / qmax


def quantize_int8(x: torch.Tensor, axis: Optional[int] = None,
                  batch_dims: int = 0,
                  amax_reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization -> (q int8, scale fp32).

    The fp32 work runs in place on one fp32 copy of x (a full-width weight
    is GBs), and with ``batch_dims`` the leading slices are quantized one at
    a time (each is an independent tensor, so the result is the same).
    ``amax_reduce`` maps a slice's max |x| onto the whole tensor's (a
    weight split over ranks along a reduced dim)."""
    if batch_dims > 0 and x.shape[0] > 1:
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        scales = []
        for i in range(x.shape[0]):
            qi, si = quantize_int8(x[i:i + 1], axis, batch_dims,
                                   amax_reduce)
            q[i:i + 1] = qi
            scales.append(si)
        return q, torch.cat(scales)
    # a contiguous copy: the codes are what the kernels stream, row-major,
    # whatever the layout of x (a merged weight comes as a transposed view)
    x32 = x.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    scale = _absmax_scale(x32, axis, INT8_MAX, batch_dims, amax_reduce)
    x32.div_(scale).round_().clamp_(-INT8_MAX, INT8_MAX)
    return x32.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@dataclasses.dataclass(frozen=True)
class QuantMeta:
    """Static description of a QuantTensor (``repro.quant.QuantMeta``)."""
    mode: str = "int8"            # int8 (fp8 is not ported)
    dtype: str = "bfloat16"       # logical dtype of the original weight
    axis: Optional[int] = -1      # channel axis (None = per tensor)
    use_pallas: bool = False      # kept for one-for-one conversion; unread


_DTYPE_NAMES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy / JAX name of a torch dtype ("bfloat16", "float32", ...)."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class QuantTensor:
    """A quantized weight: int8 codes in the weight's shape and fp32 scales
    of the same rank (keepdims), so ``qt[i]`` slices one layer of both."""
    q: torch.Tensor
    scale: torch.Tensor
    meta: QuantMeta = QuantMeta()

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    def dim(self) -> int:
        return self.q.dim()

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPE_NAMES[self.meta.dtype]

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __getitem__(self, i) -> "QuantTensor":
        """Layer ``i`` of a stacked weight (views of codes and scales)."""
        return QuantTensor(self.q[i], self.scale[i], self.meta)

    def unbind(self):
        """The layers of a stacked weight as QuantTensor views."""
        return [QuantTensor(q, s, self.meta)
                for q, s in zip(self.q.unbind(0), self.scale.unbind(0))]

    def dequantize(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        w = self.q.to(torch.float32) * self.scale
        return w.to(dtype or self.dtype)


def is_quant_tensor(x: Any) -> bool:
    return isinstance(x, QuantTensor)


def quantize_tensor(w: torch.Tensor, mode: str = "int8",
                    axis: Optional[int] = -1,
                    use_pallas: bool = False,
                    amax_reduce=None) -> QuantTensor:
    """One weight -> QuantTensor (per-channel along ``axis`` by default).
    Leading dims beyond the trailing (d_in, d_out) matrix are stacked
    layers, each with its own scales."""
    batch_dims = max(w.dim() - 2, 0)
    if mode == "int8":
        q, scale = quantize_int8(w, axis=axis, batch_dims=batch_dims,
                                 amax_reduce=amax_reduce)
    elif mode == "fp8":
        raise NotImplementedError(_FP8_MSG)
    else:
        raise ValueError(f"unknown quantization mode {mode!r} "
                         "(have: int8, fp8)")
    meta = QuantMeta(mode=mode, dtype=dtype_name(w.dtype), axis=axis,
                     use_pallas=use_pallas)
    return QuantTensor(q=q, scale=scale, meta=meta)
