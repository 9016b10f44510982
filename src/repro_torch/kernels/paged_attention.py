"""Paged decode attention kernel: wrapper, plain version, launch counter.

Source: ``csrc/paged_attn.cu`` (CUDA C++ for sm_90a), built by ``build.py``.

``paged_decode(q, k_pages, v_pages, table, kv_len, scale)`` replaces
``repro/kernels/flash_attention.py`` ``paged_flash_decode``: one query token
per row (q (B, H, D)) attends over the pages of the shared pools
(k_pages, v_pages (P, page, K, D)) that its row of ``table`` (B, W) maps, up
to ``kv_len`` (B,) keys, with GQA (H = K * G). Every decode step's attention
on the paged serving path. A CUDA tensor runs the kernel or raises; a CPU
tensor runs the plain version (``ref.paged_attn_ref``). Inference only.

Numerics: the kernel follows the TPU kernel (q * scale rounded to q's dtype,
an online softmax over pages in fp32, p rounded to v's dtype before p . v);
the plain version takes one fp32 softmax over the gathered keys, as the JAX
oracle does. In f32 the two differ by rounding order; in bf16 by the two
roundings the kernel makes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# q, k pages, v pages, table, kv_len, out, B, H, K, D, page, W, scale, stream
_ARGTYPES = [_PTR] * 6 + [_INT] * 6 + [ctypes.c_float, _PTR]
_LIB = []


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("paged_attn")
        for dt in _DTYPES.values():
            fn = getattr(lib, f"pa_paged_decode_{dt}")
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.pa_error_string.argtypes = [ctypes.c_int]
        lib.pa_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def paged_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, table: torch.Tensor,
                       kv_len: torch.Tensor, scale: float = 0.0
                       ) -> torch.Tensor:
    """Plain version of ``paged_decode`` (``ref.paged_attn_ref``)."""
    return ref.paged_attn_ref(q, k_pages, v_pages, table, kv_len, scale=scale)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, table: torch.Tensor,
                 kv_len: torch.Tensor, scale: float = 0.0) -> torch.Tensor:
    """Single-token decode attention through a page table -> (B, H, D) in
    q's dtype. ``scale`` 0 means 1/sqrt(D). CUDA: the kernel (counted in
    ``paged_decode.launches``); CPU: the plain version."""
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"expected q (B, H, D) and k, v pages (P, page, K, "
                         f"D); got q {tuple(q.shape)}, k {tuple(k_pages.shape)}"
                         f", v {tuple(v_pages.shape)}")
    bsz, h, d = q.shape
    _, page, kh, dk = k_pages.shape
    if dk != d or h % kh != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)} (need the same D and "
                         f"H a multiple of K)")
    if table.dim() != 2 or table.shape[0] != bsz:
        raise ValueError(f"table must be (B, W), got {tuple(table.shape)}")
    if q.dtype not in _DTYPES or not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"q and the pages must share one dtype (bf16 or f32); "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if q.requires_grad:
        raise RuntimeError("paged_decode serves inference only: q must not "
                           "require a gradient")
    scale = scale or 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, table, kv_len, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cuda or cpu, not {q.device}")
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous()):
        raise ValueError("paged_decode needs contiguous q and pages")
    tbl = table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = torch.as_tensor(kv_len, device=q.device).to(torch.int32)
    lens = lens.reshape(-1).expand(bsz).contiguous()
    out = torch.empty_like(q)
    if bsz == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = getattr(lib, f"pa_paged_decode_{_DTYPES[q.dtype]}")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tbl.data_ptr(), lens.data_ptr(), out.data_ptr(), bsz, h, kh, d,
            page, tbl.shape[1], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.pa_error_string(err).decode()
        raise RuntimeError(f"paged_decode launch failed: {msg} (code {err})")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
