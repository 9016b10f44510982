"""Fused GSOFT rotation kernels: wrappers, plain versions, launch counters.

Sources: ``csrc/gs_fused_T.cu`` and ``csrc/gs_fused.cu`` (CUDA C++ for
sm_90a, sharing ``csrc/gs_common.cuh``), built by ``build.py``.

* ``gs_fused_T(x, L, R)`` replaces ``repro/kernels/gs_fused.py``
  ``gs_fused_T_pallas`` (and its per-row ``vmap``,
  ``ops.gs_banked_transform_T``): y[i] = R_i^T P^T L_i^T P x[i] = x[i] Q_i,
  the activation-side adapter rotation of banked serving.
* ``gs_fused(x, L, R)`` replaces ``gs_fused_pallas``: y[i] = P^T L_i P R_i x[i]
  = Q_i x[i], used by the offline merge on the columns of W.

Both take x (B, T, d) and per-row factors L, R (B, r, b, b), d = r * b, in
one dtype (bf16 or f32). A CUDA tensor runs the kernel or raises; a CPU
tensor runs the plain version beside it (``ref.py``). Nothing falls back.

What bounds the kernels on the H100, and what the design does about it: at
decode (T = 1 per row) the work is reading the per-row factors, 2 * d * b
elements, against 2 * d for x and y, so the kernel is bound by memory
traffic. A tile of tokens stays in shared memory as fp32 with the shuffled
intermediate, so the activation slab crosses device memory once each way;
each factor element is loaded once per tile and reused for all its tokens;
at decode the transpose kernel splits each row over a cluster of 8 CTAs so
8 SMs share the factor read. At the MLP input width d = 29568 one token's
fp32 tile is 118 KB, so the tile is one token there and the kernels ask for
dynamic shared memory above 48 KB. See the sources for the details.

Numerics: the kernel keeps the intermediate in fp32, the plain version (like
the JAX oracle) rounds it to x.dtype. In f32 the two agree to rounding
order; in bf16 they differ by that one rounding of the intermediate, at most
about 2^-8 of its magnitude, carried through an orthogonal second factor.

The backward, ``csrc/gs_fused_bwd.cu``:

* ``gs_fused_bwd(x, dy, L, R) -> (dx, dL, dR)`` replaces
  ``gs_fused_bwd_pallas``: the gradients of <dy, gs_fused(x, L, R)>, dx in
  x.dtype and dL, dR (B, r, b, b) in fp32;
* ``gs_fused_grads(x, dy, L, R) -> (dL, dR)`` replaces
  ``gs_fused_grads_pallas``: the same without dx.

Both keep every intermediate in fp32, as does their plain version, so the
two differ by summation order only, in bf16 as in f32 (dx is then rounded
to bf16 by both). One call launches the kernel's two passes (and, with
several token splits, the partial-sum reduction) and counts one launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# x, L, R, y, B, T, r, b, tokens per tile[, cluster], stream
_FWD_ARGTYPES = {"gs_fused_T": [_PTR] * 4 + [_INT] * 6 + [_PTR],
                 "gs_fused": [_PTR] * 4 + [_INT] * 5 + [_PTR]}
# x, dy, L, R, R^T, dx, workspace, partial sums, dL, dR, B, T, r, b,
# tokens per tile, token splits, stream
_BWD_ARGTYPES = [_PTR] * 10 + [_INT] * 6 + [_PTR]
# the C functions of each source
_ENTRIES = {"gs_fused_T": {"gs_fused_T": _FWD_ARGTYPES["gs_fused_T"]},
            "gs_fused": {"gs_fused": _FWD_ARGTYPES["gs_fused"]},
            "gs_fused_bwd": {"gs_fused_bwd": _BWD_ARGTYPES,
                             "gs_fused_grads": _BWD_ARGTYPES}}
_LIBS = {}
_SMS = {}
# largest block size of the backward kernel's b x b sums (csrc/gs_fused_bwd.cu)
BWD_MAX_BLOCK = 128


def _lib(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C signatures bound
    (and its constants read once: ``tile``, for the transpose kernel
    ``cluster``, for the backward ``reduce_tokens``)."""
    if name not in _LIBS:
        lib = build.load(name)
        for entry, argtypes in _ENTRIES[name].items():
            for dt in _DTYPES.values():
                fn = getattr(lib, f"{entry}_{dt}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        lib.gs_max_tile_elems.restype = ctypes.c_int
        lib.tile = int(lib.gs_max_tile_elems())
        if name == "gs_fused_T":
            lib.gs_cluster_size.restype = ctypes.c_int
            lib.cluster = int(lib.gs_cluster_size())
        if name == "gs_fused_bwd":
            lib.gs_reduce_tokens.restype = ctypes.c_int
            lib.reduce_tokens = int(lib.gs_reduce_tokens())
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
    the kernel's register tile, and no more than T needs."""
    tt = 1
    while tt < 8 and 2 * tt * d <= max_tile and tt < t:
        tt *= 2
    return tt


def launch_geometry(name: str, bsz: int, t: int, d: int, b: int = 0) -> tuple:
    """(tokens per tile, CTAs per tile) that ``name``'s kernel is launched
    with for x (bsz, t, d); for the backward (``gs_fused_bwd``, block size
    ``b``), (tokens per tile of pass 1, token splits of pass 2)."""
    lib = _lib(name)
    tt = _tile_tokens(t, d, lib.tile)
    if name == "gs_fused_bwd":
        return tt, _reduce_splits(bsz, t, d // b, lib.reduce_tokens)
    if name != "gs_fused_T":
        return tt, 1
    # split each tile over a cluster of CTAs when the split grid still fits
    # in one wave of the card's SMs (decode rows, short prefills): a CTA then
    # reads 1/cluster of the factors. Past one wave the split only repeats
    # the tile loads, so larger grids run unsplit.
    split = lib.cluster
    sms = _num_sms(torch.device("cuda", torch.cuda.current_device()))
    return tt, split if bsz * -(-t // tt) * split <= sms else 1


def _reduce_splits(bsz: int, t: int, r: int, reduce_tokens: int) -> int:
    """Token splits of the backward's pass 2, whose grid is one CTA per
    (b x b block, split, row): enough splits for about two CTAs per SM,
    never more than the chunks of ``reduce_tokens`` tokens there are."""
    sms = _num_sms(torch.device("cuda", torch.cuda.current_device()))
    return max(1, min(-(-t // reduce_tokens), -(-2 * sms // (bsz * r))))


def _launch(wrapper, x: torch.Tensor, L: torch.Tensor,
            R: torch.Tensor) -> torch.Tensor:
    """Run ``wrapper``'s kernel and count the launch on ``wrapper.launches``
    (only once the kernel was launched without error)."""
    name = wrapper.__name__
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, got {x.dtype}")
    if not (x.is_contiguous() and L.is_contiguous() and R.is_contiguous()):
        raise ValueError("kernel needs contiguous x, L, R")
    lib = _lib(name)
    bsz, t, d = x.shape
    r, b = L.shape[1], L.shape[2]
    if d > lib.tile:
        raise ValueError(f"d={d} exceeds the kernel's tile limit {lib.tile}")
    y = torch.empty_like(x)
    if t == 0 or bsz == 0:
        return y
    with torch.cuda.device(x.device):
        tt, split = launch_geometry(name, bsz, t, d)
        args = [x.data_ptr(), L.data_ptr(), R.data_ptr(), y.data_ptr(),
                bsz, t, r, b, tt]
        if name == "gs_fused_T":
            args.append(split)
        args.append(torch.cuda.current_stream(x.device).cuda_stream)
        err = getattr(lib, f"{name}_{_DTYPES[x.dtype]}")(*args)
    if err != 0:
        msg = lib.gs_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (code {err})")
    wrapper.launches += 1
    return y


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
    return _launch(gs_fused_T, x, L, R)


def gs_fused(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """y[i] = Q_i x[i] (forward rotation) with per-row factors.

    x (B, T, d); L, R (B, r, b, b). CUDA: the kernel (counted in
    ``gs_fused.launches``); CPU: the plain version."""
    _check(x, L, R)
    if x.device.type == "cpu":
        return gs_fused_plain(x, L, R)
    if x.device.type != "cuda":
        raise ValueError(f"gs_fused runs on cuda or cpu, not {x.device}")
    # the forward kernel takes L^T and R^T so its factor reads are coalesced
    return _launch(gs_fused, x, L.transpose(-1, -2).contiguous(),
                   R.transpose(-1, -2).contiguous())


gs_fused_T.launches = 0
gs_fused.launches = 0


def _launch_bwd(wrapper, with_dx: bool, x: torch.Tensor, dy: torch.Tensor,
                L: torch.Tensor, R: torch.Tensor):
    """Run the backward kernel (``csrc/gs_fused_bwd.cu``) and count the call
    on ``wrapper.launches`` once it launched without error. Returns
    (dx, dL, dR) or (dL, dR)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, got {x.dtype}")
    if not all(a.is_contiguous() for a in (x, dy, L, R)):
        raise ValueError("kernel needs contiguous x, dy, L, R")
    lib = _lib("gs_fused_bwd")
    bsz, t, d = x.shape
    r, b = L.shape[1], L.shape[2]
    if d > lib.tile:
        raise ValueError(f"d={d} exceeds the kernel's tile limit {lib.tile}")
    if b > BWD_MAX_BLOCK:
        raise ValueError(f"block size b={b} exceeds the backward kernel's "
                         f"limit {BWD_MAX_BLOCK}")
    f32 = torch.float32
    dx = torch.empty_like(x) if with_dx else None
    if t == 0 or bsz == 0:               # no token: zero sums, no launch
        grads = (torch.zeros(L.shape, dtype=f32, device=x.device),
                 torch.zeros(L.shape, dtype=f32, device=x.device))
        return (dx,) + grads if with_dx else grads
    dL = torch.empty(L.shape, dtype=f32, device=x.device)
    dR = torch.empty(L.shape, dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        tt, splits = launch_geometry("gs_fused_bwd", bsz, t, d, b)
        ws = torch.empty((3, bsz, t, d), dtype=f32, device=x.device)
        part = (torch.empty((2, splits) + tuple(L.shape), dtype=f32,
                            device=x.device) if splits > 1 else dL)
        RT = R.transpose(-1, -2).contiguous()
        entry = "gs_fused_bwd" if with_dx else "gs_fused_grads"
        err = getattr(lib, f"{entry}_{_DTYPES[x.dtype]}")(
            x.data_ptr(), dy.data_ptr(), L.data_ptr(), R.data_ptr(),
            RT.data_ptr(), dx.data_ptr() if with_dx else None, ws.data_ptr(),
            part.data_ptr(), dL.data_ptr(), dR.data_ptr(), bsz, t, r, b, tt,
            splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.gs_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} (code {err})")
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
