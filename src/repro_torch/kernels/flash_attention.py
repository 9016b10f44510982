"""Blocked flash-attention kernel: wrapper, plain version, launch counter.

Source: ``csrc/flash_attn.cu`` (CUDA C++ for sm_90a), built by ``build.py``.

``flash_attention(q, k, v, causal, scale, blk_q, blk_k)`` replaces
``repro/kernels/flash_attention.py`` ``flash_attention``: softmax attention
with an online softmax over key blocks, causal blocks above the diagonal
skipped. q (H, Sq, D), k, v (H, Sk, D) as the JAX kernel, or batched
(B, H, Sq, D) with k, v (B, KH, Sk, D) and H a multiple of KH (GQA: head h
reads KV head h // (H / KH), as ``ops.flash_mha`` repeats them); any
strides with D contiguous; any head width D. It lies on no model path: the
public entry point is ``ops.flash_mha``. A CUDA tensor runs the kernel or
raises; a CPU tensor runs the plain version (``flash_attention_plain``,
one fp32 softmax through ``ref.flash_ref``). Inference only.

Two routes (``flash_plan``): bf16 on the tensor cores, f32 on the CUDA
cores. Each CTA owns a block of query rows and one chunk of the output
features; past one chunk (128 features) the features are split over CTAs,
each recomputing the scores over all of D.

As the JAX kernel, a ragged Sk is masked when causal and refused when not:
``blk_q`` / ``blk_k`` serve only that rule (``Sk % min(blk_k, Sk)``); the
CUDA kernel picks its own tiles (64 keys). Numerics follow the TPU kernel (p rounded
to v's dtype before p . v); in f32 kernel and plain version differ by
rounding order, in bf16 by that rounding of p.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref
from .gs_fused import on_device

CHUNK = 128            # output features a CTA at most (both routes)
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# q, k, v, out, strides[12], B, H, KH, Sq, Sk, D, scale, causal, chunk, stream
_ARGTYPES = [_PTR] * 5 + [_INT] * 6 + [ctypes.c_float, _INT, _INT, _PTR]
_LIB = []


def flash_plan(d: int, dtype: torch.dtype) -> dict:
    """How the kernel covers head width ``d``: ``route`` ("tc": bf16 on the
    tensor cores; "cc": f32 on the CUDA cores), ``chunk`` (output features
    a CTA; feature chunk c is [c * chunk, min((c + 1) * chunk, d))) and
    ``splits`` (CTAs a query block and head, one a chunk, each computing
    the scores over all of D). bf16 pads D to a multiple of 16 (zeros) and
    takes it whole up to 128; f32 keeps a 128-wide output chunk."""
    if dtype == torch.bfloat16:
        padded = -(-d // 16) * 16
        chunk = padded if padded <= CHUNK else CHUNK
        return dict(route="tc", chunk=chunk, splits=-(-d // chunk))
    return dict(route="cc", chunk=CHUNK, splits=-(-d // CHUNK))


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("flash_attn")
        for dt in _DTYPES.values():
            fn = getattr(lib, f"fa_flash_attention_{dt}")
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          scale: float = 0.0) -> torch.Tensor:
    """Plain version of ``flash_attention`` (``ref.flash_ref``, KV heads
    repeated for GQA)."""
    rep = q.shape[-3] // k.shape[-3]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=-3)
        v = v.repeat_interleave(rep, dim=-3)
    return ref.flash_ref(q, k, v, causal=causal, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float = 0.0,
                    blk_q: int = 128, blk_k: int = 128) -> torch.Tensor:
    """Attention -> q's shape and dtype. ``scale`` 0 means 1/sqrt(D). CUDA:
    the kernel (counted in ``flash_attention.launches``); CPU: the plain
    version. Raises ValueError for a non-causal Sk that is not a multiple
    of ``min(blk_k, Sk)``, on every device, as the JAX kernel does."""
    del blk_q                    # the JAX kernel pads Sq; no rule rides on it
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.shape != k.shape:
        raise ValueError(f"expected q (H, Sq, D) or (B, H, Sq, D) and k, v "
                         f"of one shape; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kh != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} (same B and D, H a multiple of "
                         f"the KV heads)")
    if not causal and sk and sk % min(blk_k, sk):
        raise ValueError("non-causal flash needs Sk % blk_k == 0")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share one dtype (bf16 or f32); "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    scale = scale or 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal, scale=scale)
        return out[0] if squeeze else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if any(a.requires_grad for a in (q, k, v)):
        raise NotImplementedError("the flash_attention kernel serves "
                                  "inference only (no autograd rule)")
    q, k, v = (a if a.stride(-1) == 1 else a.contiguous() for a in (q, k, v))
    out = torch.empty_like(q) if sk else torch.zeros_like(q)
    if out.numel() == 0 or sk == 0:
        return out[0] if squeeze else out
    strides = (ctypes.c_longlong * 12)(
        *(s for a in (q, k, v, out) for s in a.stride()[:3]))
    lib = _lib()
    with on_device(q.device):
        err = getattr(lib, f"fa_flash_attention_{_DTYPES[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, h, kh, sq, sk, d,
            float(scale), int(causal), flash_plan(d, q.dtype)["chunk"],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.fa_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} (code "
                           f"{err})")
    flash_attention.launches += 1
    return out[0] if squeeze else out


flash_attention.launches = 0
