"""Quantized-weight matmul kernels: wrappers, plain versions, launch counters.

Source: ``csrc/q_matmul.cu`` (CUDA C++ for sm_90a), built by ``build.py``.

* ``q_matmul(x, q, scale)`` replaces ``repro/kernels/q_matmul.py``
  ``q_matmul_pallas``: y = (x @ q) * scale for x (M, K) bf16 / f32, q (K, N)
  int8, scale (N,) fp32 per output channel; y in x's dtype. Every quantized
  projection without a fusible rotation, and the LM head.
* ``gs_q_matmul(x, L, R, q, scale)`` replaces ``gs_q_matmul_pallas`` and its
  per-row ``vmap`` (``ops.gs_q_matmul_banked``): y[i] = round(x[i] Q_i) @ q *
  scale for x (B, T, d) with per-row GSOFT factors L, R (B, r, b, b) in x's
  dtype; ``gs_q_matmul_bank(x, L, R, ids, q, scale)`` reads them from a
  bank (A, r, b, b) at the rows' slot ids on the device instead.

A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain version
(``ref.py``). The kernels serve inference only: a tensor that needs a
gradient raises. The wrapper picks the launch geometry (see
``qmm_geometry`` / ``gsq_plan``); the sources say what bounds the kernels
and what their design does about it.

``gs_q_matmul`` is one call of two kernels on the stream: the rotation
(``gs_fused_T``'s kernel, ``gs_fused.rotate_T_into``) writes the rotated
slab round(x Q) once, and the product (bf16: ``csrc/q_matmul.cu``
``gsq_product_kernel`` on the tensor cores, launched behind it with
programmatic dependent launch; f32: ``q_matmul``'s fp32 kernel) streams the
codes once. It counts one launch on ``gs_q_matmul.launches`` (and, through
a bank, on ``gs_q_matmul.slot_launches``), none on ``gs_fused_T``'s.

Numerics: the codes are widened exactly and all sums are fp32, as in the
plain version; only the summation order differs. ``gs_q_matmul`` keeps the
rotation's intermediate as bf16 hi + lo or fp32 where the plain version
(like the JAX oracle) rounds it to x's dtype; both round the rotated slab
to x's dtype before the product, as the TPU kernel does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, gs_fused, ref

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# x, q, scale, y, M, K, N, tokens per tile, boxes across a tile, ring
# stages, K splits, K rows per split, CTAs, stream
_QMM_ARGTYPES = [_PTR] * 4 + [_INT] * 9 + [_PTR]
# xr, q, scale, y, M, K, N, tokens per tile, columns per CTA, K splits, K
# rows per split, vec, stream
_GSQ_ARGTYPES = [_PTR] * 4 + [_INT] * 8 + [_PTR]
QMM_BOX_N = 128             # q_matmul: columns a TMA box of codes (csrc)
QMM_KT = 64                 # ... K rows a stage
QMM_MAX_SPLITS = 16         # ... K splits (a cluster along K)
QMM_MAX_STAGES = 8          # ... deepest ring
QMM_SPLIT_MIN_ROWS = 512    # ... fewest K rows a split takes
QMM_TILE = (1, 6)           # ... (boxes across a tile, ring stages)
QMM_DECODE_TILE = (2, 4)    # ... decode rows that leave CTAs idle
GSQ_KT = 64                 # gs_q_matmul's product: K rows a stage (csrc)
GSQ_MAX_SPLITS = 8          # ... K splits (a cluster along K; csrc)
GSQ_SPLIT_MIN_ROWS = 512    # ... fewest K rows a split takes
_LIB = []
_SMS = {}
_OCC = {}
_PLANS = {}


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("q_matmul")
        for dt in _DTYPES.values():
            getattr(lib, f"qmm_q_matmul_{dt}").argtypes = _QMM_ARGTYPES
            getattr(lib, f"qmm_q_matmul_{dt}").restype = ctypes.c_int
        lib.qmm_gsq_product_bf16.argtypes = _GSQ_ARGTYPES
        lib.qmm_gsq_product_bf16.restype = ctypes.c_int
        lib.qmm_error_string.argtypes = [ctypes.c_int]
        lib.qmm_error_string.restype = ctypes.c_char_p
        lib.qmm_gsq_constants.argtypes = [_PTR]
        lib.qmm_gsq_constants.restype = None
        lib.qmm_constants.argtypes = [_PTR]
        lib.qmm_constants.restype = None
        lib.qmm_occupancy.argtypes = [_INT] * 5 + [_PTR]
        lib.qmm_occupancy.restype = ctypes.c_int
        got = (ctypes.c_int * 2)()
        lib.qmm_gsq_constants(got)
        got4 = (ctypes.c_int * 4)()
        lib.qmm_constants(got4)
        want4 = (QMM_BOX_N, QMM_KT, QMM_MAX_SPLITS, QMM_MAX_STAGES)
        if (tuple(got) != (GSQ_KT, GSQ_MAX_SPLITS)
                or tuple(got4) != want4):
            raise RuntimeError(f"q_matmul.cu constants {tuple(got)} / "
                               f"{tuple(got4)} differ from the launch plans' "
                               f"{(GSQ_KT, GSQ_MAX_SPLITS)} / {want4}")
        _LIB.append(lib)
    return _LIB[0]


def _num_sms() -> int:
    dev = torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def scale_vector(scale, n: int, device) -> torch.Tensor:
    """A per-output-channel (1, N) / (N,) or scalar scale as a contiguous
    fp32 (N,) vector (the kernels' epilogue operand; a view when the scale
    already is one, as a ``QuantTensor``'s is)."""
    if (isinstance(scale, torch.Tensor) and scale.dtype == torch.float32
            and scale.numel() == n and scale.is_contiguous()
            and scale.device == device):
        return scale.view(n)
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    return (s.reshape(-1) if s.dim() else s.reshape(1)).expand(n).contiguous()


def _occupancy(es: int, ntok: int, ntw: int, stages: int,
               splits: int = 1) -> tuple:
    """(CTAs resident an SM, largest cluster the card places, clusters of
    ``splits`` CTAs resident at once) of ``q_matmul``'s kernel in that
    configuration on the current device (the occupancy calculator: shared
    memory, registers, threads, the GPCs' room for clusters); zeros where
    a CTA does not fit."""
    key = (torch.cuda.current_device(), es, ntok, ntw, stages, splits)
    if key not in _OCC:
        lib = _lib()
        got = (ctypes.c_int * 3)()
        _err(lib, "q_matmul occupancy query",
             lib.qmm_occupancy(es, ntok, ntw, stages, splits, got))
        _OCC[key] = tuple(got)
    return _OCC[key]


class QmmPlan(NamedTuple):
    """``q_matmul``'s launch: tokens a tile, 128-column boxes across a tile,
    ring stages, K splits, K rows a split, CTAs."""
    ntok: int
    ntw: int
    stages: int
    splits: int
    per: int
    grid: int


def qmm_geometry(m: int, k: int, n: int, es: int = 2, *, ntw: int = None,
                 stages: int = None, splits: int = None) -> QmmPlan:
    """``q_matmul``'s launch for x (m, k) of ``es``-byte elements, q (k, n).
    8-token tiles for m <= 8 (decode rows), else 16. Items (a tile of
    ``ntw`` boxes of ``QMM_BOX_N`` columns x a token tile) that fill the
    card's resident CTAs (``_occupancy`` x the SMs: the slots) are walked by
    those CTAs, persistent, each keeping the whole of K: tiles of
    ``QMM_TILE`` (the LM head: 1188 items, 3 rounds of 396). Fewer items
    split K over a cluster (one item a CTA, at least ``QMM_SPLIT_MIN_ROWS``
    rows of whole stages a split), as deep as the card still holds every
    cluster at once (``_occupancy``'s clusters resident, at most
    ``QMM_MAX_SPLITS``): one split deeper leaves clusters for a second wave
    and ran 20-70 % slower on the H100 at every tile (``PERF.md`` §6,
    ``tools/ssd_qmm_sweep.py``). Decode rows whose ``QMM_TILE`` items leave
    CTAs idle take ``QMM_DECODE_TILE`` (wider tiles, a shallower ring: 5-10
    % faster at wq, MLP wo and wi). ``ntw``, ``stages`` and ``splits``
    force those fields (the sweep; a split within the cluster the card
    places)."""
    ntok = 8 if m <= 8 else 16
    sms = _num_sms()

    def items_of(w: int) -> int:
        return -(-n // (QMM_BOX_N * w)) * -(-m // ntok)

    tile = QMM_TILE
    if (ntok == 8 and items_of(tile[0])
            < _occupancy(es, ntok, *tile)[0] * sms):
        tile = QMM_DECODE_TILE
    ntw = tile[0] if ntw is None else ntw
    stages = tile[1] if stages is None else stages
    per_sm, cluster, _ = _occupancy(es, ntok, ntw, stages)
    if per_sm <= 0:
        raise ValueError(f"q_matmul: {ntw} boxes across and {stages} stages "
                         f"do not fit an SM at {ntok} tokens of {es} bytes")
    items, max_splits = items_of(ntw), min(QMM_MAX_SPLITS, cluster)
    if splits is None:
        splits = 1
        if items < per_sm * sms:
            while (splits < max_splits
                   and k >= (splits + 1) * QMM_SPLIT_MIN_ROWS
                   and items <= _occupancy(es, ntok, ntw, stages,
                                           splits + 1)[2]):
                splits += 1
    splits = max(1, min(splits, max_splits))
    per = -(-(-(-k // splits)) // QMM_KT) * QMM_KT
    splits = -(-k // per)
    grid = items * splits if splits > 1 else min(items, per_sm * sms)
    return QmmPlan(ntok, ntw, stages, splits, per, grid)


@functools.lru_cache(maxsize=None)
def gsq_plan(m: int, k: int, n: int, sms: int) -> tuple:
    """(tokens per tile, columns per CTA, K splits, K rows per split) of
    ``gs_q_matmul``'s bf16 product for xr (m, k), q (k, n): 8-token tiles
    and 128 columns a CTA for m <= 8 (decode rows), else 16 tokens and 64
    columns; K split over up to 8 CTAs (a cluster) of at least 512 rows
    each; then the columns narrowed (to 32) until the CTAs number twice the
    SMs. More, shorter code streams ran faster on the H100 at every
    qwen2-72b projection (``PERF.md`` §6), so the split is as deep as
    the cluster allows."""
    ntok = 8 if m <= 8 else 16
    tiles = -(-m // ntok)
    nt = 128 if ntok == 8 else 64
    splits = 1
    while splits < GSQ_MAX_SPLITS and k >= 2 * splits * GSQ_SPLIT_MIN_ROWS:
        splits *= 2
    while -(-n // nt) * tiles * splits < 2 * sms and nt > 32:
        nt //= 2
    per = -(-(-(-k // splits)) // GSQ_KT) * GSQ_KT
    return ntok, nt, -(-k // per), per


def _check(x: torch.Tensor, q: torch.Tensor, k: int) -> None:
    if q.dim() != 2 or q.dtype != torch.int8:
        raise TypeError(f"q must be (K, N) int8 codes, got {q.dtype} "
                        f"{tuple(q.shape)}")
    if q.shape[0] != k:
        raise ValueError(f"x's last dim {k} != q's K {q.shape[0]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32 activations, got {x.dtype}")
    if x.device != q.device:
        raise ValueError("x and q must lie on one device")
    if x.requires_grad:
        raise RuntimeError("the quantized matmul kernels serve inference "
                           "only: x must not require a gradient")


def _err(lib, name: str, code: int) -> None:
    if code != 0:
        msg = lib.qmm_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (code {code})")


def _vec(q: torch.Tensor, n: int, c: int) -> int:
    """1 when every row of codes can be read with c-byte vector loads."""
    return int(n % c == 0 and q.data_ptr() % 16 == 0)


def _launch_qmm(lib, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                y: torch.Tensor, m: int, k: int, n: int, stream: int,
                plan: QmmPlan = None) -> int:
    """``q_matmul``'s kernel on x (m, k) into y (m, n) by ``plan``
    (``qmm_geometry``'s, cached per device and shape, unless given); its
    error code."""
    p = plan
    if p is None:
        key = (x.device.index, m, k, n, x.element_size())
        p = _PLANS.get(key)
        if p is None:
            p = _PLANS[key] = qmm_geometry(m, k, n, x.element_size())
    return getattr(lib, f"qmm_q_matmul_{_DTYPES[x.dtype]}")(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), m, k, n,
        p.ntok, p.ntw, p.stages, p.splits, p.per, p.grid, stream)


def q_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale) -> torch.Tensor:
    """Plain version of ``q_matmul`` (``ref.q_matmul_ref``)."""
    return ref.q_matmul_ref(x, q, scale)


def q_matmul(x: torch.Tensor, q: torch.Tensor, scale) -> torch.Tensor:
    """y = (x @ q) * scale. x (M, K); q (K, N) int8; scale (1, N), (N,) or
    a scalar. CUDA: the kernel (counted in ``q_matmul.launches``); CPU: the
    plain version."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    _check(x, q, x.shape[1])
    if x.device.type == "cpu":
        return q_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"q_matmul runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and q.is_contiguous()):
        raise ValueError("q_matmul needs contiguous x and q")
    m, k = x.shape
    n = q.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    lib = _lib()
    with gs_fused.on_device(x.device):
        s = scale_vector(scale, n, x.device)
        err = _launch_qmm(lib, x, q, s, y, m, k, n,
                          torch.cuda.current_stream(x.device).cuda_stream)
    _err(lib, "q_matmul", err)
    q_matmul.launches += 1
    return y


def gs_q_matmul_plain(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                      q: torch.Tensor, scale) -> torch.Tensor:
    """Plain version of ``gs_q_matmul`` (``ref.gs_q_matmul_banked_ref``)."""
    return ref.gs_q_matmul_banked_ref(L, R, x, q, scale)


def gs_q_matmul_bank_plain(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                           ids: torch.Tensor, q: torch.Tensor,
                           scale) -> torch.Tensor:
    """Plain version of ``gs_q_matmul_bank``: gather row i's factors at
    ids[i], cast them to x's dtype, then ``gs_q_matmul_plain``."""
    return gs_q_matmul_plain(x, L.index_select(0, ids).to(x.dtype),
                             R.index_select(0, ids).to(x.dtype), q, scale)


def _gsq_checks(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                q: torch.Tensor) -> None:
    _check(x, q, x.shape[2])
    if L.requires_grad or R.requires_grad:
        raise RuntimeError("gs_q_matmul serves inference only: the factors "
                           "must not require a gradient")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gs_q_matmul runs on cuda or cpu, not {x.device}")


def _gsq_launch(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                ids, q: torch.Tensor, scale) -> torch.Tensor:
    """The rotation into xr, then the product behind it (one call)."""
    if not all(a.is_contiguous() for a in (x, L, R, q)):
        raise ValueError("gs_q_matmul needs contiguous x, L, R and q")
    bsz, t, d = x.shape
    n = q.shape[1]
    y = torch.empty((bsz, t, n), dtype=x.dtype, device=x.device)
    if bsz * t == 0:
        return y
    lib = _lib()
    m = bsz * t
    dev = x.device
    with gs_fused.on_device(dev):
        s = scale_vector(scale, n, dev)
        xr = torch.empty_like(x)
        stream = torch.cuda.current_stream(dev).cuda_stream
        gs_fused.rotate_T_into(xr, x, L, R, ids, stream)
        if x.dtype == torch.bfloat16:
            ntok, nt, splits, per = gsq_plan(m, d, n, _num_sms())
            err = lib.qmm_gsq_product_bf16(
                xr.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), m, d,
                n, ntok, nt, splits, per, _vec(q, n, 16), stream)
        else:                           # f32: q_matmul's kernel on xr
            err = _launch_qmm(lib, xr, q, s, y, m, d, n, stream)
    _err(lib, "gs_q_matmul", err)
    gs_q_matmul.launches += 1
    return y


def gs_q_matmul(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                q: torch.Tensor, scale) -> torch.Tensor:
    """y[i] = round(x[i] Q_i) @ q * scale, Q_i = P^T L_i P R_i. x (B, T, d);
    L, R (B, r, b, b) in x's dtype; q (d, N) int8. CUDA: the kernels
    (counted once in ``gs_q_matmul.launches``); CPU: the plain version."""
    if x.dim() != 3 or L.dim() != 4 or R.shape != L.shape:
        raise ValueError(f"expected x (B, T, d) and L, R (B, r, b, b); got "
                         f"x {tuple(x.shape)}, L {tuple(L.shape)}, "
                         f"R {tuple(R.shape)}")
    bsz, r, b, b2 = L.shape
    if b != b2 or x.shape[0] != bsz or x.shape[2] != r * b:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} against "
                         f"factors {tuple(L.shape)} (need d = r * b)")
    _gsq_checks(x, L, R, q)
    if not (L.dtype == R.dtype == x.dtype):
        raise TypeError(f"x, L, R must share one dtype; got {x.dtype}, "
                        f"{L.dtype}, {R.dtype}")
    if x.device.type == "cpu":
        return gs_q_matmul_plain(x, L, R, q, scale)
    return _gsq_launch(x, L, R, None, q, scale)


def gs_q_matmul_bank(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                     ids: torch.Tensor, q: torch.Tensor,
                     scale) -> torch.Tensor:
    """y[i] = round(x[i] Q_{ids[i]}) @ q * scale with the factors of a bank:
    x (B, T, d); L, R (A, r, b, b), fp32 or x's dtype; ids (B,) int64; q
    (d, N) int8. CUDA: the kernels read each row's slot id on the device
    (counted once in ``gs_q_matmul.launches`` and ``.slot_launches``; no
    gather, no cast); CPU: the plain version."""
    gs_fused.check_bank(x, L, R, ids)
    _gsq_checks(x, L, R, q)
    if x.device.type == "cpu":
        return gs_q_matmul_bank_plain(x, L, R, ids, q, scale)
    if not ids.is_contiguous():
        raise ValueError("gs_q_matmul needs contiguous ids")
    y = _gsq_launch(x, L, R, ids, q, scale)
    gs_q_matmul.slot_launches += 1
    return y


q_matmul.launches = 0
gs_q_matmul.launches = 0
gs_q_matmul.slot_launches = 0     # of them, through a bank read by slot id
