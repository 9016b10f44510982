"""Block-diagonal matmul kernels: wrappers, plain versions, launch counters.

Source: ``csrc/bdmm.cu`` (CUDA C++ for sm_90a), built by ``build.py``.

* ``bdmm(x, blocks)`` replaces ``repro/kernels/bdmm.py`` ``bdmm_pallas`` (and
  its per-row ``vmap``, ``ops.bdmm_banked``): y[z, t, g*bo + i] =
  sum_j blocks[z, g, i, j] x[z, t, g*bi + j]. blocks (B, r, bo, bi), x
  (B, T, r*bi) -> y (B, T, r*bo), one dtype (bf16 or f32), fp32 sums.
  OFT and BOFT run through it: the weight-side materialization (training,
  merge) with B = 1, the banked serving rotation with one row per request.
* ``bdmm_dblocks(dy, x, bo, bi)`` replaces ``bdmm_dblocks_pallas``: the
  gradient of the blocks, dblocks[z, g] = sum_t dy[z, t, g] x[z, t, g]^T,
  (B, r, bo, bi) in fp32. Deterministic: no atomics, a fixed summation
  order (repeated runs are bit-identical).

A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain version
beside it (``ref.py``). Nothing falls back. One call counts one launch on
the wrapper (``bdmm_dblocks``'s split sum is part of that call). The launch
geometry is chosen here (``bdmm_geometry``, ``dblocks_geometry``) and checked
again by the C side.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .gs_fused import _DTYPES, _num_sms

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# blocks, x, y, B, T, r, bo, bi, groups per CTA, tokens per tile, tokens per
# CTA, stream
_FWD_ARGTYPES = [_PTR] * 3 + [_INT] * 8 + [_PTR]
# dy, x, partial sums, dblocks, B, T, r, bo, bi, groups per CTA, splits,
# tokens per split, stream
_DB_ARGTYPES = [_PTR] * 4 + [_INT] * 8 + [_PTR]
_LIB = []
# the C side's limit on bo and bi (csrc/bdmm.cu kMaxBlock)
MAX_BLOCK = 128
_DB_TOKENS = 32          # tokens staged per dblocks iteration (kDbTokens)


def _lib() -> ctypes.CDLL:
    """The built ``csrc/bdmm.cu`` with its C signatures bound."""
    if not _LIB:
        lib = build.load("bdmm")
        for dt in _DTYPES.values():
            for entry, argtypes in (("bdmm", _FWD_ARGTYPES),
                                    ("bdmm_dblocks", _DB_ARGTYPES)):
                fn = getattr(lib, f"{entry}_{dt}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        lib.bdmm_max_block.restype = ctypes.c_int
        if lib.bdmm_max_block() != MAX_BLOCK:
            raise RuntimeError("csrc/bdmm.cu and kernels/bdmm.py disagree on "
                               "the largest block size")
        _LIB.append(lib)
    return _LIB[0]


def bdmm_geometry(bsz: int, t: int, r: int, bo: int, bi: int,
                  sms: int) -> tuple:
    """(groups per CTA, tokens per tile, tokens per CTA) of the ``bdmm``
    launch for blocks (bsz, r, bo, bi) and t tokens on a card of ``sms``
    SMs: at most 256 columns and 256 staged inputs per CTA; fewer groups
    per CTA while the grid would not cover two waves of the SMs (decode,
    short prefills); several token tiles per CTA on long inputs, so each
    CTA stages its blocks once for many tokens."""
    gt = max(1, min(r, 256 // max(bo, bi)))
    tt = 1 if t <= 1 else 8 if t <= 8 else 32
    tiles = -(-t // tt)
    while gt > 1 and -(-r // gt) * tiles * bsz < 2 * sms:
        gt //= 2
    per = max(1, min(16, (-(-r // gt) * tiles * bsz) // (8 * sms)))
    return gt, tt, per * tt


def dblocks_geometry(bsz: int, t: int, r: int, bo: int, bi: int,
                     sms: int) -> tuple:
    """(groups per CTA, token splits, tokens per split) of ``bdmm_dblocks``:
    one 4 x 4 output tile per thread up to 256 threads, at most 256 staged
    columns of each operand per CTA; enough token splits for about four
    CTAs per SM, each split a multiple of the staged token count."""
    bop, bip = -(-bo // 4) * 4, -(-bi // 4) * 4
    tiles = (bop // 4) * (bip // 4)
    gt = max(1, min(r, 256 // max(bop, bip), 256 // tiles))
    col = -(-r // gt)
    splits = max(1, min(-(-t // _DB_TOKENS), -(-4 * sms // (col * bsz))))
    tps = -(-(-(-t // splits)) // _DB_TOKENS) * _DB_TOKENS
    return gt, -(-t // tps), tps


def _check(x: torch.Tensor, blocks: torch.Tensor) -> None:
    if x.dim() != 3 or blocks.dim() != 4:
        raise ValueError(f"expected x (B, T, r * bi) and blocks (B, r, bo, bi);"
                         f" got x {tuple(x.shape)}, blocks "
                         f"{tuple(blocks.shape)}")
    bsz, r, _, bi = blocks.shape
    if x.shape[0] != bsz or x.shape[2] != r * bi:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} against blocks "
                         f"{tuple(blocks.shape)} (need d = r * bi)")
    if x.dtype != blocks.dtype:
        raise TypeError(f"x and blocks must share one dtype; got {x.dtype}, "
                        f"{blocks.dtype}")
    if x.device != blocks.device:
        raise ValueError("x and blocks must lie on one device")


def _kernel_args(*ts: torch.Tensor) -> None:
    """What the CUDA kernels take beyond the shapes."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"bdmm kernels run on cuda or cpu, not "
                         f"{ts[0].device}")
    if ts[0].dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, got {ts[0].dtype}")
    if not all(a.is_contiguous() for a in ts):
        raise ValueError("kernel needs contiguous inputs")


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        msg = _lib().gs_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} (code {err})")


def _block_limit(bo: int, bi: int) -> None:
    if max(bo, bi) > MAX_BLOCK:
        raise ValueError(f"block size ({bo}, {bi}) exceeds the bdmm kernels' "
                         f"limit {MAX_BLOCK}")


def bdmm_plain(x: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bdmm`` (``ref.bdmm_banked_ref``)."""
    return ref.bdmm_banked_ref(blocks, x)


def bdmm(x: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """y[z] = diag(blocks[z]) x[z] over the last dim, per row.

    x (B, T, r * bi); blocks (B, r, bo, bi) -> (B, T, r * bo) in x.dtype.
    CUDA: the kernel (counted in ``bdmm.launches``); CPU: the plain
    version."""
    _check(x, blocks)
    if x.device.type == "cpu":
        return bdmm_plain(x, blocks)
    _kernel_args(x, blocks)
    bsz, t, _ = x.shape
    r, bo, bi = blocks.shape[1:]
    _block_limit(bo, bi)
    y = torch.empty((bsz, t, r * bo), dtype=x.dtype, device=x.device)
    if t == 0 or bsz == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        gt, tt, tpc = bdmm_geometry(bsz, t, r, bo, bi, _num_sms(x.device))
        err = getattr(lib, f"bdmm_{_DTYPES[x.dtype]}")(
            blocks.data_ptr(), x.data_ptr(), y.data_ptr(), bsz, t, r, bo, bi,
            gt, tt, tpc, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "bdmm")
    bdmm.launches += 1
    return y


def bdmm_dblocks_plain(dy: torch.Tensor, x: torch.Tensor, bo: int,
                       bi: int) -> torch.Tensor:
    """Plain version of ``bdmm_dblocks`` (``ref.bdmm_dblocks_ref``)."""
    return ref.bdmm_dblocks_ref(dy, x, bo, bi)


def bdmm_dblocks(dy: torch.Tensor, x: torch.Tensor, bo: int,
                 bi: int) -> torch.Tensor:
    """dblocks[z, g, i, j] = sum_t dy[z, t, g*bo + i] x[z, t, g*bi + j].

    dy (B, T, r * bo), x (B, T, r * bi), one dtype -> (B, r, bo, bi) fp32.
    CUDA: the kernel (counted in ``bdmm_dblocks.launches``); CPU: the plain
    version."""
    if dy.dim() != 3 or x.dim() != 3 or dy.shape[:2] != x.shape[:2] \
            or dy.shape[2] % bo or x.shape[2] % bi \
            or dy.shape[2] // bo != x.shape[2] // bi:
        raise ValueError(f"expected dy (B, T, r * bo) and x (B, T, r * bi) "
                         f"with bo={bo}, bi={bi}; got dy {tuple(dy.shape)}, "
                         f"x {tuple(x.shape)}")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy and x must share dtype and device; got "
                         f"{dy.dtype} {dy.device}, {x.dtype} {x.device}")
    if x.device.type == "cpu":
        return bdmm_dblocks_plain(dy, x, bo, bi)
    _kernel_args(dy, x)
    _block_limit(bo, bi)
    bsz, t = x.shape[:2]
    r = x.shape[2] // bi
    f32 = torch.float32
    if t == 0 or bsz == 0:               # no token: zero sums, no launch
        return torch.zeros((bsz, r, bo, bi), dtype=f32, device=x.device)
    dblocks = torch.empty((bsz, r, bo, bi), dtype=f32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        gt, splits, tps = dblocks_geometry(bsz, t, r, bo, bi,
                                           _num_sms(x.device))
        part = (torch.empty((splits, bsz, r, bo, bi), dtype=f32,
                            device=x.device) if splits > 1 else dblocks)
        err = getattr(lib, f"bdmm_dblocks_{_DTYPES[x.dtype]}")(
            dy.data_ptr(), x.data_ptr(), part.data_ptr(), dblocks.data_ptr(),
            bsz, t, r, bo, bi, gt, splits, tps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "bdmm_dblocks")
    bdmm_dblocks.launches += 1
    return dblocks


bdmm.launches = 0
bdmm_dblocks.launches = 0
