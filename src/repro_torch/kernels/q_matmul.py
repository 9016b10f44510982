"""Quantized-weight matmul kernels: wrappers, plain versions, launch counters.

Source: ``csrc/q_matmul.cu`` (CUDA C++ for sm_90a), built by ``build.py``.

* ``q_matmul(x, q, scale)`` replaces ``repro/kernels/q_matmul.py``
  ``q_matmul_pallas``: y = (x @ q) * scale for x (M, K) bf16 / f32, q (K, N)
  int8, scale (N,) fp32 per output channel; y in x's dtype. Every quantized
  projection without a fusible rotation, and the LM head.
* ``gs_q_matmul(x, L, R, q, scale)`` replaces ``gs_q_matmul_pallas`` and its
  per-row ``vmap`` (``ops.gs_q_matmul_banked``): y[i] = round(x[i] Q_i) @ q *
  scale for x (B, T, d) with per-row GSOFT factors L, R (B, r, b, b) in x's
  dtype, the rotated slab kept in shared memory (one launch).

A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain version
(``ref.py``). The kernels serve inference only: a tensor that needs a
gradient raises. The wrapper picks the launch geometry (see
``qmm_geometry`` / ``gsq_geometry``); the sources say what bounds the
kernels and what their design does about it.

Numerics: the codes are widened exactly and all sums are fp32, as in the
plain version; only the summation order differs. ``gs_q_matmul`` keeps the
rotation's intermediate in fp32 where the plain version (like the JAX
oracle) rounds it to x's dtype; both round the rotated slab to x's dtype
before the product, as the TPU kernel does.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# x, q, scale, y, ws, M, K, N, tt, c, splits, k_per_split, vec, stream
_QMM_ARGTYPES = [_PTR] * 5 + [_INT] * 8 + [_PTR]
# x, L, R, q, scale, y, n_tokens, M, r, b, N, tt, threads along N, vec, stream
_GSQ_ARGTYPES = [_PTR] * 6 + [_INT] * 8 + [_PTR]
K_SPLIT_MIN_ROWS = 256      # fewest K rows one split of q_matmul takes
GSQ_THREADS = 512           # threads of a gs_q_matmul CTA (csrc)
GSQ_CODES = 4               # codes per thread along N in gs_q_matmul (csrc)
_LIB = []
_SMS = {}


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("q_matmul")
        for dt in _DTYPES.values():
            getattr(lib, f"qmm_q_matmul_{dt}").argtypes = _QMM_ARGTYPES
            getattr(lib, f"qmm_q_matmul_{dt}").restype = ctypes.c_int
            getattr(lib, f"qmm_gs_q_matmul_{dt}").argtypes = _GSQ_ARGTYPES
            getattr(lib, f"qmm_gs_q_matmul_{dt}").restype = ctypes.c_int
        lib.qmm_error_string.argtypes = [ctypes.c_int]
        lib.qmm_error_string.restype = ctypes.c_char_p
        lib.qmm_cluster_size.restype = ctypes.c_int
        lib.qmm_rot_tile_elems.restype = ctypes.c_int
        lib.qmm_gs_q_matmul_active_clusters.argtypes = [_INT] * 3
        lib.qmm_gs_q_matmul_active_clusters.restype = ctypes.c_int
        lib.cluster = int(lib.qmm_cluster_size())
        lib.rot_tile = int(lib.qmm_rot_tile_elems())
        _LIB.append(lib)
    return _LIB[0]


def _num_sms() -> int:
    dev = torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def scale_vector(scale, n: int, device) -> torch.Tensor:
    """A per-output-channel (1, N) / (N,) or scalar scale as a contiguous
    fp32 (N,) vector (the kernels' epilogue operand)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    return (s.reshape(-1) if s.dim() else s.reshape(1)).expand(n).contiguous()


def qmm_geometry(m: int, k: int, n: int) -> tuple:
    """(tokens per tile, codes per thread, K splits, K rows per split) of
    ``q_matmul`` for x (m, k), q (k, n): token tiles of up to 16 tokens with
    up to 64 fp32 sums a thread; K split over CTAs only when the column
    tiles alone would not give two CTAs per SM."""
    tt, c = next((tt, c) for lim, tt, c in ((1, 1, 16), (2, 2, 16),
                                            (4, 4, 16), (8, 8, 8),
                                            (1 << 30, 16, 4)) if m <= lim)
    tiles = -(-n // (32 * c)) * -(-m // tt)
    splits = max(1, min(-(-2 * _num_sms() // tiles),
                        k // K_SPLIT_MIN_ROWS, 65535))
    per = -(-k // splits)
    return tt, c, -(-k // per), per


def gsq_geometry(bsz: int, t: int, r: int, b: int, n: int) -> tuple:
    """(tokens per tile, threads along N) of ``gs_q_matmul``: the largest
    power-of-two token tile (<= 8) with tt * d / 8 within the kernel's
    rotation tile and no more than the B * T tokens need; then the widest
    column tile (each cluster recomputes the rotation) that still leaves
    half as many clusters as the card holds at once (one per 16 SMs), never
    narrower than one warp. On the H100 that is 8 clusters, the fastest
    count at N = 8192 for d = 8192 and d = 29568 (``PERF.md``)."""
    lib = _lib()
    m = bsz * t
    share = -(-r // lib.cluster) * b
    tt = 1
    while tt < 8 and 2 * tt * share <= lib.rot_tile and tt < m:
        tt *= 2
    token_tiles = -(-m // tt)
    want = max(1, _num_sms() // (2 * lib.cluster))
    nthr = GSQ_THREADS
    while (nthr > 32 and token_tiles
           * -(-n // (nthr * GSQ_CODES)) < want):
        nthr //= 2
    return tt, nthr


def gsq_resident_clusters(tt: int, r: int, b: int) -> int:
    """How many ``gs_q_matmul`` clusters of this geometry the card holds at
    once (``cudaOccupancyMaxActiveClusters``, bf16)."""
    n = _lib().qmm_gs_q_matmul_active_clusters(tt, r, b)
    if n < 0:
        raise RuntimeError(f"occupancy query failed (code {-n})")
    return n


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
    with torch.cuda.device(x.device):
        s = scale_vector(scale, n, x.device)
        tt, c, splits, per = qmm_geometry(m, k, n)
        ws = (torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        err = getattr(lib, f"qmm_q_matmul_{_DTYPES[x.dtype]}")(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None, m, k, n, tt, c,
            splits, per, _vec(q, n, c),
            torch.cuda.current_stream(x.device).cuda_stream)
    _err(lib, "q_matmul", err)
    q_matmul.launches += 1
    return y


def gs_q_matmul_plain(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                      q: torch.Tensor, scale) -> torch.Tensor:
    """Plain version of ``gs_q_matmul`` (``ref.gs_q_matmul_banked_ref``)."""
    return ref.gs_q_matmul_banked_ref(L, R, x, q, scale)


def gs_q_matmul(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                q: torch.Tensor, scale) -> torch.Tensor:
    """y[i] = round(x[i] Q_i) @ q * scale, Q_i = P^T L_i P R_i. x (B, T, d);
    L, R (B, r, b, b) in x's dtype; q (d, N) int8. CUDA: the kernel (counted
    in ``gs_q_matmul.launches``); CPU: the plain version."""
    if x.dim() != 3 or L.dim() != 4 or R.shape != L.shape:
        raise ValueError(f"expected x (B, T, d) and L, R (B, r, b, b); got "
                         f"x {tuple(x.shape)}, L {tuple(L.shape)}, "
                         f"R {tuple(R.shape)}")
    bsz, r, b, b2 = L.shape
    if b != b2 or x.shape[0] != bsz or x.shape[2] != r * b:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} against "
                         f"factors {tuple(L.shape)} (need d = r * b)")
    _check(x, q, x.shape[2])
    if not (L.dtype == R.dtype == x.dtype):
        raise TypeError(f"x, L, R must share one dtype; got {x.dtype}, "
                        f"{L.dtype}, {R.dtype}")
    if L.requires_grad or R.requires_grad:
        raise RuntimeError("gs_q_matmul serves inference only: the factors "
                           "must not require a gradient")
    if x.device.type == "cpu":
        return gs_q_matmul_plain(x, L, R, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"gs_q_matmul runs on cuda or cpu, not {x.device}")
    if not all(a.is_contiguous() for a in (x, L, R, q)):
        raise ValueError("gs_q_matmul needs contiguous x, L, R and q")
    lib = _lib()
    t = x.shape[1]
    n = q.shape[1]
    if -(-r // lib.cluster) * b > lib.rot_tile:
        raise ValueError(f"d={r * b} exceeds the kernel's rotation tile "
                         f"({lib.rot_tile} elements a CTA)")
    y = torch.empty((bsz, t, n), dtype=x.dtype, device=x.device)
    if bsz * t == 0:
        return y
    with torch.cuda.device(x.device):
        s = scale_vector(scale, n, x.device)
        tt, nthr = gsq_geometry(bsz, t, r, b, n)
        err = getattr(lib, f"qmm_gs_q_matmul_{_DTYPES[x.dtype]}")(
            x.data_ptr(), L.data_ptr(), R.data_ptr(), q.data_ptr(),
            s.data_ptr(), y.data_ptr(), t, bsz * t, r, b, n, tt, nthr,
            _vec(q, n, GSQ_CODES),
            torch.cuda.current_stream(x.device).cuda_stream)
    _err(lib, "gs_q_matmul", err)
    gs_q_matmul.launches += 1
    return y


q_matmul.launches = 0
gs_q_matmul.launches = 0
