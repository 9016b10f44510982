"""Fused GSOFT rotation kernels: wrappers, plain versions, launch counters.

Sources: ``csrc/gs_fused_T.cu`` and ``csrc/gs_fused.cu`` (CUDA C++ for
sm_90a, sharing ``csrc/gs_common.cuh``), built by ``build.py``.

* ``gs_fused_T(x, L, R)`` replaces ``repro/kernels/gs_fused.py``
  ``gs_fused_T_pallas`` (and its per-row ``vmap``,
  ``ops.gs_banked_transform_T``): y[i] = R_i^T P^T L_i^T P x[i] = x[i] Q_i,
  the activation-side adapter rotation of banked serving;
  ``gs_fused_T_bank(x, L, R, ids)`` is the same with the factors read from
  a bank (A, r, b, b) at the rows' slot ids, on the device (no gather, no
  cast: an fp32 bank entry is rounded to x's dtype in registers).
* ``gs_fused(x, L, R)`` replaces ``gs_fused_pallas``: y[i] = P^T L_i P R_i x[i]
  = Q_i x[i]: the rotation of W's columns every GSOFT step materializes,
  Double GSOFT's dx of its output side, and the offline merge.

Both take x (B, T, d) and per-row factors L, R (B, r, b, b), d = r * b, in
one dtype (bf16 or f32). A CUDA tensor runs the kernel or raises; a CPU
tensor runs the plain version beside it (``ref.py``). Nothing falls back.

``t_plan`` picks ``gs_fused_T``'s route. Route 1 (bf16, b = 32, r >= b:
decode rows, every prefill bucket, Double GSOFT's output sides, the dx of
the GS backward) runs on the tensor cores: one CTA per entry of the plan
(a run of up to 32 consecutive output groups, the L-block entries and the
window of natural groups it needs: ``t_entry``) and token split, factors
read once per CTA, any width d. Short T spreads each 32-group tile over 2
or 4 entries so that the factor read fills a wave of SMs. Route 2 (f32, b
!= 32, r < b) keeps an fp32 tile of whole rows in shared memory, split
over a cluster of 8 CTAs at decode; a row wider than ``MAX_TILE_ELEMS``
(tokens per tile 0 in the plan) runs two wide passes through an fp32
workspace instead (``csrc/gs_common.cuh``), any d. Both routes
read a bank by slot id. See ``csrc/gs_fused_T.cu``.

``fwd_plan`` picks ``gs_fused``'s route. Route 1 (bf16, b = 32, r >= b:
every slab GSOFT and Double GSOFT train) runs on the tensor cores: one CTA
per tile of the backward's plan (``tc_table``: the output groups whose
windows of source groups overlap, a super-block of b^2 features when b
divides r) and token split, factors read once per CTA, any width d. Route 2
(f32, other b, r < b) is an fp32 tile kernel like the transpose's route 2,
and past ``MAX_TILE_ELEMS`` the same two wide passes.

Numerics: the kernels keep the intermediate in fp32 (route 1 of either:
as bf16 hi + lo, about 2^-17 relative), the plain version (like the JAX
oracle) rounds it to x.dtype. In f32 the two agree to rounding order; in
bf16 they differ by that one rounding of the intermediate, at most about
2^-8 of its magnitude, carried through an orthogonal second factor.

The backward, ``csrc/gs_fused_bwd.cu``:

* ``gs_fused_bwd(x, dy, L, R) -> (dx, dL, dR)`` replaces
  ``gs_fused_bwd_pallas``: the gradients of <dy, gs_fused(x, L, R)>, dx in
  x.dtype and dL, dR (B, r, b, b) in fp32;
* ``gs_fused_grads(x, dy, L, R) -> (dL, dR)`` replaces
  ``gs_fused_grads_pallas``: the same without dx, what a GSOFT step runs
  for a frozen weight.

``bwd_plan`` picks the route. Route 1 (bf16, b = 32, r >= b: every weight
slab the GSOFT paths train) is one tensor-core pass with no workspace: the
output groups are cut into tiles that need only their own source groups
(``tile_groups``; super-blocks of b^2 features when b divides r), each tile
into CTAs of 8 groups (``tc_table``), the tokens into splits; dx is then
the transpose rotation of dy (route 1 of ``gs_fused_T``, through the same
``t_plan``, counted as part of this one call). Route 2 (f32, other b up to
256, r < b) is the two-pass kernel with an fp32 workspace. Both keep every
intermediate at least as precise as bf16 hi + lo (route 1's sums) or fp32,
as does their plain version, so the two differ by summation order and that
split (2^-17 relative) only; dx is rounded to bf16 by both. One call counts
one launch, whatever it runs.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import build, ref

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# route 2 of gs_fused: x, L, R, y, B, T, r, b, tokens per tile, stream
_FWD_ARGTYPES = [_PTR] * 4 + [_INT] * 5 + [_PTR]
# route 2 of gs_fused_T: x, L, R, ids, slots, y, B, T, r, b, tokens per
# tile, cluster, stream
_T_ARGTYPES = [_PTR] * 4 + [_INT] + [_PTR] + [_INT] * 6 + [_PTR]
# route 1 of gs_fused_T: x, L, R, ids, slots, plan table, y, B, T, r,
# entries, splits, tokens per split, tokens per tile, window, groups per
# entry, stage-1 and stage-2 units a warp, stream
_T_TC_ARGTYPES = [_PTR] * 4 + [_INT] + [_PTR] * 2 + [_INT] * 11 + [_PTR]
# route 2: x, dy, L, R, R^T, dx, workspace, partial sums, dL, dR, B, T, r,
# b, tokens per tile, token splits, pass-2 CTAs per block, stream
_BWD_ARGTYPES = [_PTR] * 10 + [_INT] * 7 + [_PTR]
# route 1: x, dy, L, R, plan table, partial sums, dL, dR, B, T, r, entries,
# splits, tokens per split, window, dy columns, stream
_TC_ARGTYPES = [_PTR] * 8 + [_INT] * 8 + [_PTR]
# route 1 of gs_fused: x, L, R, plan table, y, B, T, r, tiles, splits,
# tokens per split, window, stream
_FWD_TC_ARGTYPES = [_PTR] * 5 + [_INT] * 7 + [_PTR]
# route 2 of gs_fused past the tile limit: x, L, R, workspace, y, B, T, r,
# b, stream
_FWD_WIDE_ARGTYPES = [_PTR] * 5 + [_INT] * 4 + [_PTR]
# route 2 of gs_fused_T past the tile limit: x, L, R, ids, slots,
# workspace, y, B, T, r, b, stream
_T_WIDE_ARGTYPES = [_PTR] * 4 + [_INT] + [_PTR] * 2 + [_INT] * 4 + [_PTR]
# the C functions of each source with their argument types
_ENTRIES = {
    "gs_fused_T": {"gs_fused_T_f32_f32": _T_ARGTYPES,
                   "gs_fused_T_bf16_bf16": _T_ARGTYPES,
                   "gs_fused_T_bf16_f32": _T_ARGTYPES,
                   "gs_T_tc_f32": _T_TC_ARGTYPES,
                   "gs_T_tc_bf16": _T_TC_ARGTYPES} | {
                       f"gs_fused_T_wide_{dt}": _T_WIDE_ARGTYPES
                       for dt in ("f32_f32", "bf16_bf16", "bf16_f32")},
    "gs_fused": {"gs_fused_f32": _FWD_ARGTYPES,
                 "gs_fused_bf16": _FWD_ARGTYPES,
                 "gs_fused_tc_bf16": _FWD_TC_ARGTYPES,
                 "gs_fused_wide_f32": _FWD_WIDE_ARGTYPES,
                 "gs_fused_wide_bf16": _FWD_WIDE_ARGTYPES},
    "gs_fused_bwd": {f"{e}_{dt}": _BWD_ARGTYPES
                     for e in ("gs_fused_bwd", "gs_fused_grads")
                     for dt in ("f32", "bf16")} | {
                         "gs_grads_tc_bf16": _TC_ARGTYPES}}
_LIBS = {}
_SMS = {}
_TABLES = {}
# constants of csrc/gs_common.cuh and csrc/gs_fused_bwd.cu the launch plan
# mirrors (checked against the library when it loads)
MAX_TILE_ELEMS = 32768    # tokens per tile x d of the fp32 tile kernels
T_CLUSTER = 8             # gs_fused_T route 2: CTAs sharing a tile
REDUCE_TOKENS = 64        # tokens per staged chunk of route 2's pass 2
REDUCE_TILES = 1024       # 4 x 4 tiles of a b x b block one pass-2 CTA holds
BWD_MAX_BLOCK = 256       # largest block size of the backward
TC_BLOCK = 32             # route 1: the block size it takes
TC_SLOTS = 8              # ... output groups per CTA
TC_TOKENS = 16            # ... tokens per staged tile
TC_MAX_WINDOW = 39        # ... source groups a CTA stages
TC_TAB = 8 + 4 * TC_SLOTS  # ... ints per CTA in the plan table
FWD_MAX_WINDOW = 2 * TC_BLOCK - 1  # gs_fused route 1: source groups a tile stages
# gs_fused_T route 1 (csrc/gs_fused_T.cu, namespace tT): warps of a CTA,
# stage-1 and stage-2 units a warp holds, header ints of a plan entry,
# window groups an entry stages, shared memory a CTA may take
T_WARPS = 16
T_MAX_LU = 6
T_MAX_RU = 4
T_HDR = 8
T_TAB = T_HDR + T_WARPS * T_MAX_LU
T_MAX_WINDOW = 96
SMEM_LIMIT = 232448


def _lib(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C signatures bound
    (and the constants its launch plan mirrors checked once)."""
    if name not in _LIBS:
        lib = build.load(name)
        for entry, argtypes in _ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        lib.gs_max_tile_elems.restype = ctypes.c_int
        if lib.gs_max_tile_elems() != MAX_TILE_ELEMS:
            raise RuntimeError(f"{name}.cu's tile limit differs from the "
                               f"launch plan's {MAX_TILE_ELEMS}")
        if name == "gs_fused_T":
            _check_t_lib(lib)
        if name == "gs_fused":
            lib.gs_fwd_constants.argtypes = [_PTR]
            lib.gs_fwd_constants.restype = None
            _check_fwd_lib(lib)
        if name == "gs_fused_bwd":
            lib.gs_reduce_tokens.restype = ctypes.c_int
            lib.gs_bwd_constants.argtypes = [_PTR]
            lib.gs_bwd_constants.restype = None
            _check_bwd_lib(lib)
        _LIBS[name] = lib
    return _LIBS[name]


def _num_sms(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _check(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
           dy: Optional[torch.Tensor] = None) -> None:
    if x.dim() != 3 or L.dim() != 4 or R.shape != L.shape:
        raise ValueError(f"expected x (B, T, d) and L, R (B, r, b, b); got "
                         f"x {tuple(x.shape)}, L {tuple(L.shape)}, "
                         f"R {tuple(R.shape)}")
    bsz, r, b, b2 = L.shape
    if b != b2 or x.shape[0] != bsz or x.shape[2] != r * b:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} against "
                         f"factors {tuple(L.shape)} (need d = r * b)")
    if not (x.dtype == L.dtype == R.dtype):
        raise TypeError(f"x, L, R must share one dtype; got {x.dtype}, "
                        f"{L.dtype}, {R.dtype}")
    if not (x.device == L.device == R.device):
        raise ValueError("x, L, R must lie on one device")
    if dy is not None:
        if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
            raise ValueError(f"dy must match x in shape, dtype and device; got "
                             f"dy {tuple(dy.shape)} {dy.dtype} {dy.device}, x "
                             f"{tuple(x.shape)} {x.dtype} {x.device}")


def _tile_tokens(t: int, d: int, max_tile: int) -> int:
    """Tokens per tile: the largest power of two (<= 8) with tt * d within
    the kernel's register tile, and no more than T needs; 0 when one token's
    row is already wider (route 2 then runs its wide passes)."""
    if d > max_tile:
        return 0
    tt = 1
    while tt < 8 and 2 * tt * d <= max_tile and tt < t:
        tt *= 2
    return tt


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` unless it is already current (the C
    entry points launch on the current device); a no-op context costs the
    per-token serving calls nothing."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _raise(lib, entry: str, err: int) -> None:
    if err != 0:
        msg = lib.gs_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} (code {err})")


def _launch_cc(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
               plan: "FwdPlan") -> torch.Tensor:
    """Route 2 of ``gs_fused``, counted on ``gs_fused.launches`` once
    launched without error: the fp32 tile kernel (given L^T and R^T so its
    factor reads are coalesced) or, for rows past ``MAX_TILE_ELEMS``
    (``plan.tokens`` 0), the two wide passes through an fp32 workspace."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, got {x.dtype}")
    if not (x.is_contiguous() and L.is_contiguous() and R.is_contiguous()):
        raise ValueError("kernel needs contiguous x, L, R")
    bsz, t, _ = x.shape
    y = torch.empty_like(x)
    if bsz == 0 or t == 0:
        return y
    lib = _lib("gs_fused")
    dt = _DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.tokens == 0:
            entry = f"gs_fused_wide_{dt}"
            ws = torch.empty(x.shape, dtype=torch.float32, device=x.device)
            err = getattr(lib, entry)(
                x.data_ptr(), L.data_ptr(), R.data_ptr(), ws.data_ptr(),
                y.data_ptr(), bsz, t, L.shape[1], L.shape[2], stream)
        else:
            entry = f"gs_fused_{dt}"
            LT = L.transpose(-1, -2).contiguous()
            RT = R.transpose(-1, -2).contiguous()
            err = getattr(lib, entry)(
                x.data_ptr(), LT.data_ptr(), RT.data_ptr(), y.data_ptr(), bsz,
                t, L.shape[1], L.shape[2], plan.tokens, stream)
    _raise(lib, entry, err)
    gs_fused.launches += 1
    return y


def _launch_tc(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
               plan: "FwdPlan") -> torch.Tensor:
    """Route 1 of ``gs_fused`` (bf16 by its plan), counted on
    ``gs_fused.launches`` once launched without error."""
    if not (x.is_contiguous() and L.is_contiguous() and R.is_contiguous()):
        raise ValueError("kernel needs contiguous x, L, R")
    lib = _lib("gs_fused")
    y = torch.empty_like(x)
    if x.shape[0] == 0 or x.shape[1] == 0:
        return y
    with torch.cuda.device(x.device):
        err = lib.gs_fused_tc_bf16(
            x.data_ptr(), L.data_ptr(), R.data_ptr(),
            _tc_table_on(x.device, L.shape[1]).data_ptr(), y.data_ptr(),
            x.shape[0], x.shape[1], L.shape[1], plan.tiles, plan.splits,
            plan.tokens, plan.window,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, "gs_fused", err)
    gs_fused.launches += 1
    return y


def rotate_T_into(y: torch.Tensor, x: torch.Tensor, L: torch.Tensor,
                  R: torch.Tensor, ids: Optional[torch.Tensor] = None,
                  stream: Optional[int] = None) -> None:
    """Launch ``gs_fused_T``'s kernel (the route ``t_plan`` picks) into
    ``y`` on x's device, which must be current (``on_device``), and
    ``stream`` (default: the current one): y[i] = x[i] Q_i with row i's
    factors L[i], R[i], or, given ``ids``, L[ids[i]], R[ids[i]] of a bank.
    Counts nothing (the callers count their own call); raises if the
    launch fails. x, L, R contiguous CUDA tensors: x bf16 or f32, L and R
    in x's dtype or fp32 (a bank with bf16 x); ids int64."""
    lib = _lib("gs_fused_T")
    bsz, t, d = x.shape
    slots, r, b = L.shape[0], L.shape[1], L.shape[2]
    xdt, fdt = _DTYPES[x.dtype], _DTYPES[L.dtype]
    if xdt == "f32" and fdt != "f32":
        raise TypeError("f32 x takes f32 factors")
    plan = t_plan(bsz, t, r, b, xdt, _num_sms(x.device))
    idp = ids.data_ptr() if ids is not None else None
    if stream is None:
        stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.route == "tc":
        entry = f"gs_T_tc_{fdt}"
        err = getattr(lib, entry)(
            x.data_ptr(), L.data_ptr(), R.data_ptr(), idp, slots,
            _t_table_on(x.device, r, plan.ng).data_ptr(), y.data_ptr(), bsz,
            t, r, plan.entries, plan.splits, plan.tokens, plan.tt,
            plan.window, plan.ng, plan.lu, plan.ru, stream)
    elif plan.tt == 0:               # route 2 past the tile limit
        entry = f"gs_fused_T_wide_{xdt}_{fdt}"
        ws = torch.empty((bsz, t, d), dtype=torch.float32, device=x.device)
        err = getattr(lib, entry)(
            x.data_ptr(), L.data_ptr(), R.data_ptr(), idp, slots,
            ws.data_ptr(), y.data_ptr(), bsz, t, r, b, stream)
    else:
        entry = f"gs_fused_T_{xdt}_{fdt}"
        err = getattr(lib, entry)(
            x.data_ptr(), L.data_ptr(), R.data_ptr(), idp, slots,
            y.data_ptr(), bsz, t, r, b, plan.tt, plan.cluster, stream)
    _raise(lib, entry, err)


def gs_fused_T_plain(x: torch.Tensor, L: torch.Tensor,
                     R: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gs_fused_T``: y[i] = R_i^T P^T L_i^T P x[i]."""
    return ref.gs_banked_T_ref(L, R, x)


def gs_fused_plain(x: torch.Tensor, L: torch.Tensor,
                   R: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gs_fused``: y[i] = P^T L_i P R_i x[i]."""
    return torch.stack([ref.gs_fused_ref(L[i], R[i], x[i])
                        for i in range(x.shape[0])])


def gs_fused_T(x: torch.Tensor, L: torch.Tensor,
               R: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i] Q_i (transpose rotation) with per-row factors.

    x (B, T, d); L, R (B, r, b, b). CUDA: the kernel (counted in
    ``gs_fused_T.launches``); CPU: the plain version."""
    _check(x, L, R)
    if x.device.type == "cpu":
        return gs_fused_T_plain(x, L, R)
    if x.device.type != "cuda":
        raise ValueError(f"gs_fused_T runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, got {x.dtype}")
    if not (x.is_contiguous() and L.is_contiguous() and R.is_contiguous()):
        raise ValueError("kernel needs contiguous x, L, R")
    y = torch.empty_like(x)
    if x.shape[0] == 0 or x.shape[1] == 0:
        return y
    with on_device(x.device):
        rotate_T_into(y, x, L, R)
    gs_fused_T.launches += 1
    return y


def check_bank(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
               ids: torch.Tensor) -> None:
    """Shapes, types and devices of a bank call: x (B, T, d) bf16 or f32,
    L and R (A, r, b, b) with d = r * b in fp32 or x's dtype, ids (B,)
    int64 slot ids, all on one device."""
    if x.dim() != 3 or L.dim() != 4 or R.shape != L.shape:
        raise ValueError(f"expected x (B, T, d) and a bank L, R (A, r, b, "
                         f"b); got x {tuple(x.shape)}, L {tuple(L.shape)}, "
                         f"R {tuple(R.shape)}")
    _, r, b, b2 = L.shape
    if b != b2 or x.shape[2] != r * b:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} against the "
                         f"bank {tuple(L.shape)} (need d = r * b)")
    if ids.dim() != 1 or ids.shape[0] != x.shape[0]:
        raise ValueError(f"ids must be (B,) = ({x.shape[0]},), got "
                         f"{tuple(ids.shape)}")
    if ids.dtype != torch.int64:
        raise TypeError(f"ids must be int64 slot ids, got {ids.dtype}")
    xdt = x.dtype
    if xdt not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32 x, got {xdt}")
    if L.dtype != R.dtype or L.dtype not in (torch.float32, xdt):
        raise TypeError(f"the bank must be fp32 or x's dtype {xdt}; got "
                        f"{L.dtype}, {R.dtype}")
    dev = x.device
    if not (dev == L.device == R.device == ids.device):
        raise ValueError("x, the bank and ids must lie on one device")


def gs_fused_T_bank_plain(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gs_fused_T_bank``: gather row i's factors at
    ids[i], cast them to x's dtype, then ``gs_fused_T_plain``."""
    return gs_fused_T_plain(x, L.index_select(0, ids).to(x.dtype),
                            R.index_select(0, ids).to(x.dtype))


def gs_fused_T_bank(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i] Q_{ids[i]} with the factors of a bank: x (B, T, d); L, R
    (A, r, b, b), fp32 or x's dtype; ids (B,) int64.

    CUDA: the kernel reads each row's slot id on the device and rounds the
    bank entry to x's dtype in registers (counted in ``gs_fused_T.launches``
    and ``gs_fused_T.slot_launches``; no gather, no cast, no host sync);
    CPU: the plain version. An id outside [0, A) is clamped into range on
    the card (the plain version raises)."""
    check_bank(x, L, R, ids)
    if x.device.type == "cpu":
        return gs_fused_T_bank_plain(x, L, R, ids)
    if x.device.type != "cuda":
        raise ValueError(f"gs_fused_T runs on cuda or cpu, not {x.device}")
    if not all(a.is_contiguous() for a in (x, L, R, ids)):
        raise ValueError("kernel needs contiguous x, L, R, ids")
    y = torch.empty_like(x)
    if x.shape[0] == 0 or x.shape[1] == 0:
        return y
    with on_device(x.device):
        rotate_T_into(y, x, L, R, ids)
    gs_fused_T.launches += 1
    gs_fused_T.slot_launches += 1
    return y


def gs_fused(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """y[i] = Q_i x[i] (forward rotation) with per-row factors.

    x (B, T, d); L, R (B, r, b, b). CUDA: the kernel (counted in
    ``gs_fused.launches``); CPU: the plain version."""
    _check(x, L, R)
    if x.device.type == "cpu":
        return gs_fused_plain(x, L, R)
    if x.device.type != "cuda":
        raise ValueError(f"gs_fused runs on cuda or cpu, not {x.device}")
    bsz, t, _ = x.shape
    plan = fwd_plan(bsz, t, L.shape[1], L.shape[2], _DTYPES.get(x.dtype, ""),
                    _num_sms(x.device))
    if plan.route == "tc":
        return _launch_tc(x, L, R, plan)
    return _launch_cc(x, L, R, plan)


gs_fused_T.launches = 0
gs_fused_T.slot_launches = 0      # of them, through a bank read by slot id
gs_fused.launches = 0


def tile_groups(r: int, b: int, k: int) -> list:
    """(s0, q, g) of the output groups tile k owns, sorted: group g starts
    at position g * b = q * r + s0 of dw = P dy with s0 in [k * b, k * b +
    b), so it covers source groups s0 .. s0 + b - 1 of row q (those past
    r - 1 wrap to row q + 1). For r >= b a tile holds one group per q."""
    out = []
    for q in range(b):
        g = -(-(q * r + k * b) // b)
        s0 = g * b - q * r
        if g < r and s0 < r:
            out.append((s0, q, g))
    return sorted(out)


def tc_table(r: int, b: int = TC_BLOCK, slots: int = TC_SLOTS) -> tuple:
    """The route-1 plan of one row's factors: (table, tiles, parts,
    largest window, largest dy column span). One table entry per CTA (tile
    k, part c) of ``TC_TAB`` ints: [w0, W, qlo, dq, simple, 0, 0, 0] then,
    per slot, [q, g, s0 - w0, 0] (q = -1: no group). The CTA owns the
    slots' output groups (dL[g]) and the rows of dR their positions map to;
    it stages source groups w0 .. w0 + W - 1 (past r - 1: wrapped) of x and
    dy columns qlo .. qlo + dq - 1. ``simple``: b | r, so its slots are
    columns qlo + s of one super-block."""
    tiles, parts = -(-r // b), -(-b // slots)
    rows, maxw, maxdq = [], 1, 8
    for k in range(tiles):
        groups = tile_groups(r, b, k)
        for c in range(parts):
            mine = groups[c * slots:(c + 1) * slots]
            entry = [0] * (8 + 4 * slots)
            for s in range(slots):
                entry[8 + 4 * s] = -1
            if mine:
                w0 = mine[0][0]
                width = mine[-1][0] + b - w0
                cols = [q for _, q, _ in mine] + [q + 1 for s0, q, _ in mine
                                                  if s0 + b > r]
                qlo = min(cols) // 8 * 8
                dq = (max(cols) - qlo) // 8 * 8 + 8
                simple = (len(mine) == slots and dq == 8 and w0 + width <= r
                          and all(s0 == w0 and q == qlo + i
                                  for i, (s0, q, _) in enumerate(mine)))
                entry[:5] = [w0, width, qlo, dq, int(simple)]
                for s, (s0, q, g) in enumerate(mine):
                    entry[8 + 4 * s:8 + 4 * s + 3] = [q, g, s0 - w0]
                maxw, maxdq = max(maxw, width), max(maxdq, dq)
            rows.append(entry)
    return np.asarray(rows, np.int32), tiles, parts, maxw, maxdq


class BwdPlan(NamedTuple):
    """How one backward call is launched (``bwd_plan``)."""
    route: str      # "tc": route 1, one pass on the tensor cores; "two_pass"
    entries: int    # tc: CTAs per split and row (tiles x parts)
    parts: int      # tc: CTAs per tile (its slots)
    splits: int     # token splits (partial sums added in order)
    tokens: int     # tc: tokens per split; two_pass: pass-1 tokens per tile
    window: int     # tc: largest window of source groups a CTA stages
    dq: int         # tc: largest dy column span a CTA stages
    ichunks: int    # two_pass: CTAs per b x b block in pass 2 (rows split)


@functools.lru_cache(maxsize=None)
def _tc_geometry(r: int) -> tuple:
    return tc_table(r)


def _one_wave_splits(ctas: int, most: int, sms: int) -> int:
    """Token splits (at most ``most``) whose ``ctas`` x splits CTAs fill
    one wave of ``sms`` best; 1 when even one split takes more."""
    return max(1, min(most, sms // ctas))


@functools.lru_cache(maxsize=None)
def bwd_plan(bsz: int, t: int, r: int, b: int, dtype: str, sms: int) -> BwdPlan:
    """The backward's launch plan for x (bsz, t, r * b) in ``dtype``
    ("bf16" or "f32") on a card of ``sms`` SMs.

    Route 1 ("tc": bf16, b = 32, r >= b): one CTA per (tile part, token
    split, row), each CTA alone on its SM (its shared memory), so the token
    splits fill one wave. Route 2 ("two_pass": any other shape, b <= 256):
    pass 1 in tiles of up to 8 tokens (0: a row past ``MAX_TILE_ELEMS``,
    the wide passes), pass 2 in splits of 64-token chunks for about two
    CTAs per SM, a block's rows split over CTAs so each holds at most
    ``REDUCE_TILES`` 4 x 4 tiles."""
    if dtype == "bf16" and b == TC_BLOCK and r >= b:
        _, tiles, parts, maxw, maxdq = _tc_geometry(r)
        entries = tiles * parts
        splits = _one_wave_splits(entries * bsz, -(-t // TC_TOKENS), sms)
        tps = -(-(-(-t // splits)) // TC_TOKENS) * TC_TOKENS
        return BwdPlan("tc", entries, parts, -(-t // tps), tps, maxw, maxdq, 0)
    n4 = -(-b // 4)
    ichunks = -(-(n4 * n4) // REDUCE_TILES)
    splits = max(1, min(-(-t // REDUCE_TOKENS),
                        -(-2 * sms // (bsz * r * ichunks))))
    return BwdPlan("two_pass", 0, 0, splits, _tile_tokens(t, r * b,
                                                          MAX_TILE_ELEMS),
                   0, 0, ichunks)


class FwdPlan(NamedTuple):
    """How one ``gs_fused`` call is launched (``fwd_plan``)."""
    route: str      # "tc": route 1 on the tensor cores; "cc": the fp32 tiles
    tiles: int      # tc: CTAs per split and row (tiles of output groups)
    splits: int     # tc: token splits
    tokens: int     # tc: tokens per split; cc: tokens per tile
    window: int     # tc: largest window of source groups a tile stages


def tile_windows(r: int) -> list:
    """(w0, W) of each route-1 tile of ``r`` groups: the union of its
    ``tc_table`` entries' windows (entry 0 starts it; empty entries have
    W = 0)."""
    table, tiles, parts, _, _ = _tc_geometry(r)
    out = []
    for k in range(tiles):
        ent = table[k * parts:(k + 1) * parts]
        w0 = int(ent[0, 0])
        end = max(int(e[0] + e[1]) for e in ent if e[1] > 0)
        out.append((w0, end - w0))
    return out


@functools.lru_cache(maxsize=None)
def fwd_plan(bsz: int, t: int, r: int, b: int, dtype: str, sms: int) -> FwdPlan:
    """``gs_fused``'s launch plan for x (bsz, t, r * b) in ``dtype`` ("bf16"
    or "f32") on a card of ``sms`` SMs.

    Route 1 ("tc": bf16, b = 32, r >= b): one CTA per (tile, token split,
    row), each alone on its SM (its shared memory), the splits filling one
    wave. Route 2 ("cc": any other shape): one CTA per tile of up to 8
    tokens, whole rows of d <= ``MAX_TILE_ELEMS``; past it tokens 0, the
    wide passes."""
    if dtype == "bf16" and b == TC_BLOCK and r >= b:
        tiles = -(-r // b)
        window = max(w for _, w in tile_windows(r))
        splits = _one_wave_splits(tiles * bsz, -(-t // TC_TOKENS), sms)
        tps = -(-(-(-t // splits)) // TC_TOKENS) * TC_TOKENS
        return FwdPlan("tc", tiles, -(-t // tps), tps, window)
    return FwdPlan("cc", 0, 1, _tile_tokens(t, r * b, MAX_TILE_ELEMS), 0)


class TPlan(NamedTuple):
    """How one ``gs_fused_T`` call is launched (``t_plan``)."""
    route: str      # "tc": route 1 on the tensor cores; "cc": the fp32 tiles
    entries: int    # tc: CTAs per split and row (runs of output groups)
    ng: int         # tc: output groups per entry (32, 16 or 8)
    tt: int         # tokens per staged tile (tc: 16 when b | r, else 8)
    splits: int     # tc: token splits
    tokens: int     # tc: tokens per split
    window: int     # tc: largest window of natural groups an entry stages
    cluster: int    # cc: CTAs per tile
    lu: int = 0     # tc: stage-1 units a warp holds at most
    ru: int = 0     # tc: stage-2 units a warp holds at most


def t_entry(r: int, g0: int, ng: int) -> tuple:
    """Route 1 of ``gs_fused_T`` for the output groups g0 .. g0 + ng - 1
    (features g0 b .. (g0 + ng) b - 1 of y, b = 32): (units, wstart, W).

    Row i of the transposed structure holds the s-space positions i r + g
    (s = P x): entries o_i = (i r + g0) mod b .. of L-block G_i = (i r +
    g0) // b, and of G_i + 1 past the block's end (b not dividing r). A
    unit (i, beta, mu, elo, ehi) computes outputs 16 mu .. 16 mu + 15 of
    L-block G_i + beta, of which [elo, ehi) are the entry's. L-block G_i +
    beta reads feature i of the natural groups g0 - o_i + 32 beta .. + 31
    (taken mod r, one feature on per wrap): the entry stages natural groups
    wstart .. wstart + W - 1 of every token."""
    units, lo, hi = [], None, None
    for i in range(TC_BLOCK):
        oi = (i * r + g0) % TC_BLOCK
        for beta, (elo, ehi) in enumerate(((oi, min(TC_BLOCK, oi + ng)),
                                           (0, oi + ng - TC_BLOCK))):
            if ehi <= elo:
                continue
            start = g0 - oi + TC_BLOCK * beta
            lo = start if lo is None else min(lo, start)
            hi = start + TC_BLOCK if hi is None else max(hi, start + TC_BLOCK)
            units += [(i, beta, mu, elo, ehi) for mu in (0, 1)
                      if max(elo, 16 * mu) < min(ehi, 16 * mu + 16)]
    return units, lo, hi - lo


# the (stage-1, stage-2) units a warp holds that route 1 is instantiated
# for, by tokens per tile (csrc/gs_fused_T.cu launch_T_tc)
T_UNITS = {16: ((2, 1), (2, 2), (4, 4)), 8: ((4, 1), (4, 2), (6, 4))}


@functools.lru_cache(maxsize=None)
def t_table(r: int, ng: int) -> tuple:
    """Route 1's plan table for r groups in entries of ng output groups:
    (table (entries, ``T_TAB``) int32, largest window, most stage-1 units
    of an entry). Entry e: [g0, its groups, wstart, W, units, 0, 0, 0] then
    one int per unit, i | beta << 5 | mu << 6 | elo << 8 | ehi << 16."""
    rows, maxw, maxu = [], 1, 1
    for g0 in range(0, r, ng):
        n = min(ng, r - g0)
        units, wstart, width = t_entry(r, g0, n)
        assert len(units) <= T_TAB - T_HDR and width <= T_MAX_WINDOW
        entry = [g0, n, wstart, width, len(units), 0, 0, 0]
        entry += [i | beta << 5 | mu << 6 | elo << 8 | ehi << 16
                  for i, beta, mu, elo, ehi in units]
        rows.append(entry + [0] * (T_TAB - len(entry)))
        maxw, maxu = max(maxw, width), max(maxu, len(units))
    return np.asarray(rows, np.int32), maxw, maxu


def t_smem(tt: int, window: int, ng: int, stages: int) -> int:
    """Bytes of shared memory of route 1's CTA (csrc/gs_fused_T.cu
    ``tT::Layout``: the plan entry, a trash row, the x ring, XT / Z and
    V)."""
    sp = window * TC_BLOCK * 2 + 16
    np_ = 48 if tt == 16 else 16
    ip = window * np_
    ip += 16 if (ip // 16) % 2 == 0 else 0
    gp = TC_BLOCK * np_ + 16
    zp = ng * TC_BLOCK * 2 + 16
    return (T_TAB * 4 + 64 + stages * tt * sp + max(TC_BLOCK * ip, tt * zp)
            + 2 * ng * gp)


@functools.lru_cache(maxsize=None)
def t_plan(bsz: int, t: int, r: int, b: int, dtype: str, sms: int) -> TPlan:
    """``gs_fused_T``'s launch plan for x (bsz, t, r * b) in ``dtype``
    ("bf16" or "f32") on a card of ``sms`` SMs.

    Route 1 ("tc": bf16, b = 32, r >= b): entries of 32 output groups,
    halved (to 16, then 8) while the halved entries x rows x 16- or 8-token
    tiles still fit in one wave, so a short T reads its factors on more
    SMs; then token splits filling that wave (one CTA an SM). Route 2
    ("cc"): tiles of up to 8 tokens of whole rows, each split over a
    cluster of ``T_CLUSTER`` CTAs when the split grid still fits in one
    wave (decode rows, short prefills: a CTA then reads 1/8 of the
    factors; past one wave the split only repeats the tile loads); a row
    past ``MAX_TILE_ELEMS`` takes tt 0, the wide passes."""
    if dtype == "bf16" and b == TC_BLOCK and r >= b:
        tt = 16 if r % TC_BLOCK == 0 else 8
        ntok = -(-t // tt)
        ng = TC_BLOCK
        while ng > 8 and -(-r // (ng // 2)) * bsz * ntok <= sms:
            ng //= 2
        entries = -(-r // ng)
        splits = _one_wave_splits(entries * bsz, ntok, sms)
        tps = -(-(-(-t // splits)) // tt) * tt
        _, window, units = t_table(r, ng)
        lu, ru = next((lu, ru) for lu, ru in T_UNITS[tt]
                      if units <= T_WARPS * lu and 2 * ng <= T_WARPS * ru)
        return TPlan("tc", entries, ng, tt, -(-t // tps), tps, window, 1, lu,
                     ru)
    tt = _tile_tokens(t, r * b, MAX_TILE_ELEMS)
    cluster = T_CLUSTER if tt and bsz * -(-t // tt) * T_CLUSTER <= sms else 1
    return TPlan("cc", 0, 0, tt, 1, t, 0, cluster)


def _t_table_on(device: torch.device, r: int, ng: int) -> torch.Tensor:
    """Route 1's plan table of (r, ng) as an int32 tensor on ``device``
    (built once per device, r and ng)."""
    key = ("T", device, r, ng)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(t_table(r, ng)[0]).to(device)
    return _TABLES[key]


def _check_t_lib(lib: ctypes.CDLL) -> None:
    """Route 1's plan mirrors gs_fused_T.cu's constants; refuse a mismatch."""
    lib.gs_T_constants.argtypes = [_PTR]
    lib.gs_T_constants.restype = None
    lib.gs_cluster_size.restype = ctypes.c_int
    lib.gs_T_smem.argtypes = [_INT] * 4
    lib.gs_T_smem.restype = ctypes.c_int
    got = (ctypes.c_int * 7)()
    lib.gs_T_constants(got)
    want = (TC_BLOCK, T_WARPS, T_MAX_LU, T_MAX_RU, T_TAB, T_MAX_WINDOW, T_HDR)
    smem = [(lib.gs_T_smem(*a), t_smem(*a))
            for a in ((16, 32, 32, 2), (8, 95, 32, 2), (8, 78, 16, 1))]
    if (tuple(got) != want or lib.gs_cluster_size() != T_CLUSTER
            or any(a != b for a, b in smem)):
        raise RuntimeError(f"gs_fused_T.cu constants {tuple(got)} / shared "
                           f"memory {smem} differ from the launch plan's "
                           f"{want}")


def _check_fwd_lib(lib: ctypes.CDLL) -> None:
    """Route 1's plan mirrors gs_fused.cu's constants; refuse a mismatch."""
    got = (ctypes.c_int * 6)()
    lib.gs_fwd_constants(got)
    want = (TC_BLOCK, TC_SLOTS, TC_TOKENS, FWD_MAX_WINDOW, TC_TAB,
            -(-TC_BLOCK // TC_SLOTS))
    if tuple(got) != want or lib.gs_max_tile_elems() != MAX_TILE_ELEMS:
        raise RuntimeError(f"gs_fused.cu constants {tuple(got)} differ from "
                           f"the launch plan's {want}")


def _tc_table_on(device: torch.device, r: int) -> torch.Tensor:
    """The route-1 plan table of ``r`` groups as an int32 tensor on
    ``device`` (built once per device and r)."""
    key = (device, r)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(_tc_geometry(r)[0]).to(device)
    return _TABLES[key]


def _check_bwd_lib(lib: ctypes.CDLL) -> None:
    """The plan mirrors the source's constants; refuse a mismatch."""
    got = (ctypes.c_int * 7)()
    lib.gs_bwd_constants(got)
    want = (TC_BLOCK, TC_SLOTS, TC_TOKENS, TC_MAX_WINDOW, REDUCE_TILES,
            BWD_MAX_BLOCK, TC_TAB)
    if tuple(got) != want or lib.gs_reduce_tokens() != REDUCE_TOKENS or \
            lib.gs_max_tile_elems() != MAX_TILE_ELEMS:
        raise RuntimeError(f"gs_fused_bwd.cu constants {tuple(got)} differ "
                           f"from the launch plan's {want}")


def _launch_bwd(wrapper, with_dx: bool, x: torch.Tensor, dy: torch.Tensor,
                L: torch.Tensor, R: torch.Tensor):
    """Run the backward (``csrc/gs_fused_bwd.cu``; for dx on route 1 also
    the transpose rotation of ``csrc/gs_fused_T.cu``) and count the call on
    ``wrapper.launches`` once it launched without error. Returns (dx, dL,
    dR) or (dL, dR)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, got {x.dtype}")
    if not all(a.is_contiguous() for a in (x, dy, L, R)):
        raise ValueError("kernel needs contiguous x, dy, L, R")
    bsz, t, d = x.shape
    r, b = L.shape[1], L.shape[2]
    if b > BWD_MAX_BLOCK:
        raise ValueError(f"block size b={b} exceeds the backward kernel's "
                         f"limit {BWD_MAX_BLOCK}")
    lib = _lib("gs_fused_bwd")
    f32 = torch.float32
    dx = torch.empty_like(x) if with_dx else None
    if t == 0 or bsz == 0:               # no token: zero sums, no launch
        grads = (torch.zeros(L.shape, dtype=f32, device=x.device),
                 torch.zeros(L.shape, dtype=f32, device=x.device))
        return (dx,) + grads if with_dx else grads
    dL = torch.empty(L.shape, dtype=f32, device=x.device)
    dR = torch.empty(L.shape, dtype=f32, device=x.device)
    dt = _DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        plan = bwd_plan(bsz, t, r, b, dt, _num_sms(x.device))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        part = (torch.empty((2, plan.splits) + tuple(L.shape), dtype=f32,
                            device=x.device) if plan.splits > 1 else dL)
        if plan.route == "tc":
            entry = "gs_grads_tc"
            err = lib.gs_grads_tc_bf16(
                x.data_ptr(), dy.data_ptr(), L.data_ptr(), R.data_ptr(),
                _tc_table_on(x.device, r).data_ptr(), part.data_ptr(),
                dL.data_ptr(), dR.data_ptr(), bsz, t, r, plan.entries,
                plan.splits, plan.tokens, plan.window, plan.dq, stream)
            if err == 0 and with_dx:     # dx = Q^T dy, route 1 of t_plan
                rotate_T_into(dx, dy, L, R, stream=stream)
        else:
            ws = torch.empty((3, bsz, t, d), dtype=f32, device=x.device)
            RT = R.transpose(-1, -2).contiguous()
            entry = "gs_fused_bwd" if with_dx else "gs_fused_grads"
            err = getattr(lib, f"{entry}_{dt}")(
                x.data_ptr(), dy.data_ptr(), L.data_ptr(), R.data_ptr(),
                RT.data_ptr(), dx.data_ptr() if with_dx else None,
                ws.data_ptr(), part.data_ptr(), dL.data_ptr(), dR.data_ptr(),
                bsz, t, r, b, plan.tokens, plan.splits, plan.ichunks, stream)
    _raise(lib, entry, err)
    wrapper.launches += 1
    return (dx, dL, dR) if with_dx else (dL, dR)


def gs_fused_bwd_plain(x: torch.Tensor, dy: torch.Tensor, L: torch.Tensor,
                       R: torch.Tensor):
    """Plain version of ``gs_fused_bwd``, row by row (``ref.py``)."""
    dx = torch.empty_like(x)
    dL = torch.empty(L.shape, dtype=torch.float32, device=x.device)
    dR = torch.empty_like(dL)
    for i in range(x.shape[0]):
        dx[i], dL[i], dR[i] = ref.gs_fused_bwd_ref(L[i], R[i], x[i], dy[i])
    return dx, dL, dR


def gs_fused_grads_plain(x: torch.Tensor, dy: torch.Tensor, L: torch.Tensor,
                         R: torch.Tensor):
    """Plain version of ``gs_fused_grads``, row by row (``ref.py``)."""
    return gs_fused_bwd_plain(x, dy, L, R)[1:]


def gs_fused_bwd(x: torch.Tensor, dy: torch.Tensor, L: torch.Tensor,
                 R: torch.Tensor):
    """(dx, dL, dR): the gradients of <dy, gs_fused(x, L, R)>, per row.

    x, dy (B, T, d); L, R (B, r, b, b). dx in x.dtype, dL and dR in fp32.
    CUDA: the kernel (counted in ``gs_fused_bwd.launches``); CPU: the plain
    version."""
    _check(x, L, R, dy)
    if x.device.type == "cpu":
        return gs_fused_bwd_plain(x, dy, L, R)
    if x.device.type != "cuda":
        raise ValueError(f"gs_fused_bwd runs on cuda or cpu, not {x.device}")
    return _launch_bwd(gs_fused_bwd, True, x, dy, L, R)


def gs_fused_grads(x: torch.Tensor, dy: torch.Tensor, L: torch.Tensor,
                   R: torch.Tensor):
    """(dL, dR) of <dy, gs_fused(x, L, R)>, per row, fp32; no dx.

    CUDA: the kernel (counted in ``gs_fused_grads.launches``); CPU: the
    plain version."""
    _check(x, L, R, dy)
    if x.device.type == "cpu":
        return gs_fused_grads_plain(x, dy, L, R)
    if x.device.type != "cuda":
        raise ValueError(f"gs_fused_grads runs on cuda or cpu, not {x.device}")
    return _launch_bwd(gs_fused_grads, False, x, dy, L, R)


gs_fused_bwd.launches = 0
gs_fused_grads.launches = 0
