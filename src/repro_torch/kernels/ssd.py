"""Mamba2 SSD chunked-scan kernel: wrapper, plain version, launch counter.

Source: ``csrc/ssd.cu`` (CUDA C++ for sm_90a), built by ``build.py``.

``ssd(x, loga, B, C)`` replaces ``repro/kernels/ssd.py`` ``ssd_pallas``:
the SSD recurrence S_t = exp(loga_t) S_{t-1} + B_t x_t^T, y_t = C_t^T S_t
from a zero state, chunk-parallel, for x (Nb, T, H, P), loga (Nb, T, H),
B, C (Nb, T, H, N) in one dtype (bf16 or f32) -> y (Nb, T, H, P) in that
dtype; all state math fp32. Every Mamba layer of every prefill (and
forward) of the ``ssm`` and ``hybrid`` families runs it once, the whole
batch in one launch. A CUDA tensor runs the kernel or raises; a CPU tensor
runs the plain version (``ssd_plain``). Inference only: a tensor that needs
a gradient raises NotImplementedError (the JAX package trains these
families through reference-path autodiff; the port's SSM training waits
for an autograd rule).

The chunk is the kernel's own (``CHUNK`` = 64 steps, any T, the last chunk
padded); the plain version takes ``ref.ssd_chunked_ref`` at
``pick_chunk(T, chunk)``, as the JAX package's default path. The two agree
up to rounding. ``ssd_geometry`` picks the P tile: a row's P columns split
over CTAs while the grid would leave SMs idle.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .dispatch import pick_chunk
from .gs_fused import _num_sms

CHUNK = 64                   # the kernel's steps per chunk (csrc/ssd.cu kQ)
MIN_P_TILE = 16
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# x, loga, B, C, y, Nb, T, H, P, N, pt, stream
_ARGTYPES = [_PTR] * 5 + [_INT] * 6 + [_PTR]
_LIB = []


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("ssd")
        for dt in _DTYPES.values():
            fn = getattr(lib, f"ssd_chunked_scan_{dt}")
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def ssd_geometry(nb: int, h: int, p: int, sms: int) -> int:
    """The P tile: halved (from P, down to MIN_P_TILE) while the grid of
    nb * h * (P / tile) CTAs is smaller than the card's SM count."""
    pt = p
    while pt % 2 == 0 and pt > MIN_P_TILE and nb * h * (p // pt) < sms:
        pt //= 2
    return pt


def ssd_plain(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Plain version of ``ssd``: ``ref.ssd_chunked_ref`` at the largest
    chunk <= ``chunk`` that divides T."""
    return ref.ssd_chunked_ref(x, loga, B, C,
                               chunk=pick_chunk(x.shape[-3], chunk))


def ssd(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """SSD scan over (Nb, T, H, P) -> (Nb, T, H, P) in x's dtype. CUDA: the
    kernel (counted in ``ssd.launches``; its chunk is ``CHUNK``, ``chunk``
    is unread); CPU: the plain version at ``chunk``."""
    if x.dim() != 4 or loga.dim() != 3 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"expected x (Nb, T, H, P), loga (Nb, T, H), B, C "
                         f"(Nb, T, H, N); got {tuple(x.shape)}, "
                         f"{tuple(loga.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    nb, t, h, p = x.shape
    n = B.shape[-1]
    if tuple(loga.shape) != (nb, t, h) or tuple(B.shape[:3]) != (nb, t, h):
        raise ValueError(f"loga {tuple(loga.shape)} / B {tuple(B.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if x.dtype not in _DTYPES or not (x.dtype == loga.dtype == B.dtype
                                      == C.dtype):
        raise TypeError(f"x, loga, B and C must share one dtype (bf16 or "
                        f"f32); got {x.dtype}, {loga.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if x.device.type == "cpu":
        return ssd_plain(x, loga, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    if any(a.requires_grad for a in (x, loga, B, C)):
        raise NotImplementedError(
            "the ssd kernel has no autograd rule yet (SSM training is a "
            "later slice of the port)")
    x, loga, B, C = (a.contiguous() for a in (x, loga, B, C))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    pt = ssd_geometry(nb, h, p, _num_sms(x.device))
    lib = _lib()
    with torch.cuda.device(x.device):
        err = getattr(lib, f"ssd_chunked_scan_{_DTYPES[x.dtype]}")(
            x.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), nb, t, h, p, n, pt,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.ssd_error_string(err).decode()
        raise RuntimeError(f"ssd launch failed: {msg} (code {err}; "
                           f"Nb={nb} T={t} H={h} P={p} N={n} tile={pt})")
    ssd.launches += 1
    return y


ssd.launches = 0
