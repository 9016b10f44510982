"""Paged decode attention kernel: wrapper, plain version, launch counter.

Source: ``csrc/paged_attn.cu`` (CUDA C++ for sm_90a), built by ``build.py``.

``paged_decode(q, k_pages, v_pages, table, kv_len, scale)`` replaces
``repro/kernels/flash_attention.py`` ``paged_flash_decode``: one query token
per row (q (B, H, D)) attends over the pages of the shared pools
(k_pages, v_pages (P, page, K, D)) that its row of ``table`` (B, W) maps, up
to ``kv_len`` (B,) keys, with GQA (H = K * G). Every decode step's attention
on the paged serving path. A CUDA tensor runs the kernel or raises; a CPU
tensor runs the plain version (``ref.paged_attn_ref``). Inference only.

The kernel splits a row's live pages over a cluster of ``splits`` CTAs
(``paged_plan``; the ranges are ``paged_split``'s) and merges their online
softmax states in distributed shared memory, in one launch. It reads the
table through its row stride and kv_len as int32 or int64, so the serving
path's ``table[:, :-1]`` and ``pos + 1`` need no copy or cast.

Numerics: the kernel follows the TPU kernel (q * scale rounded to q's dtype,
an online softmax in fp32, p rounded to v's dtype before p . v); the plain
version takes one fp32 softmax over the gathered keys, as the JAX oracle
does. In f32 the two differ by rounding order; in bf16 by the two roundings
the kernel makes (p rounded against each split's own running max).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build, ref
from .gs_fused import _num_sms, on_device

TILE = 64              # keys a ring item of the kernel
HEADS = 8              # query heads a CTA
MAX_FEATURES = 256     # output features a CTA
MAX_SPLITS = 8         # CTAs a row: the cluster
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# q, k pages, v pages, table, table row stride, kv_len, kv_len is int64,
# out, B, H, K, D, page, W, splits, scale, stream
_ARGTYPES = ([_PTR] * 4 + [ctypes.c_longlong, _PTR, _INT, _PTR] + [_INT] * 7
             + [ctypes.c_float, _PTR])
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


def paged_plan(B: int, KH: int, W: int, page: int, max_len: int, sms: int,
               groups: int = HEADS, d: int = 128) -> dict:
    """The kernel's launch: ``splits`` CTAs a row (a cluster) so that the
    ``ctas`` = B * KH * head tiles * feature chunks * splits fill about one
    wave of ``sms``, each split holding at least one 64-key tile of the
    longest row (``max_len`` keys, at most W * page)."""
    head_tiles = -(-groups // HEADS)
    chunks = -(-d // MAX_FEATURES)
    base = B * KH * head_tiles * chunks
    pages = min(W, -(-max(int(max_len), 0) // page))
    splits = max(1, min(MAX_SPLITS, sms // base, -(-pages // -(-TILE // page))))
    return dict(splits=splits, head_tiles=head_tiles, feature_chunks=chunks,
                ctas=base * splits)


@functools.lru_cache(maxsize=256)
def _splits(B: int, KH: int, W: int, page: int, max_len: int, sms: int,
            groups: int, d: int) -> int:
    return paged_plan(B, KH, W, page, max_len, sms, groups, d)["splits"]


def paged_split(kv_len: int, W: int, page: int, splits: int) -> list:
    """The [begin, end) keys each of the ``splits`` CTAs of a row with
    ``kv_len`` keys reads, as the kernel computes them: the live pages (up
    to column W - 1) in contiguous ranges of whole tiles; empty ranges are
    (b, b)."""
    nkeys = min(max(int(kv_len), 0), W * page)
    live = -(-nkeys // page)
    unit = max(1, TILE // page)
    per = -(-live // splits)                    # pages a split,
    per = -(-per // unit) * unit                # rounded to whole tiles
    out = []
    for s in range(splits):
        pbeg, pend = s * per, min(live, s * per + per)
        out.append((pbeg * page, min(pend * page, nkeys) if pend > pbeg
                    else pbeg * page))
    return out


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
    tbl = table
    if (tbl.device != q.device or tbl.dtype != torch.int32
            or tbl.stride(1) != 1):
        tbl = tbl.to(device=q.device, dtype=torch.int32).contiguous()
    w = tbl.shape[1]
    lens = kv_len
    if isinstance(lens, torch.Tensor) and lens.device == q.device:
        max_len = w * page                     # no sync: the table's length
    else:
        lens = torch.as_tensor(lens)
        max_len = int(lens.max()) if lens.numel() else 0
        lens = lens.to(q.device)
    if lens.dtype not in (torch.int32, torch.int64):
        lens = lens.to(torch.int64)
    if lens.shape != (bsz,) or lens.stride(0) != 1:
        lens = lens.reshape(-1).expand(bsz).contiguous()
    out = torch.empty_like(q)
    if bsz == 0:
        return out
    splits = _splits(bsz, kh, w, page, max_len, _num_sms(q.device), h // kh,
                     d)
    lib = _lib()
    with on_device(q.device):
        err = getattr(lib, f"pa_paged_decode_{_DTYPES[q.dtype]}")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tbl.data_ptr(), tbl.stride(0), lens.data_ptr(),
            int(lens.dtype == torch.int64), out.data_ptr(), bsz, h, kh, d,
            page, w, splits, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.pa_error_string(err).decode()
        raise RuntimeError(f"paged_decode launch failed: {msg} (code {err})")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
