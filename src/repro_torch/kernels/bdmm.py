"""Block-diagonal matmul kernels: wrappers, plain versions, launch counters.

Source: ``csrc/bdmm.cu`` (CUDA C++ for sm_90a), built by ``build.py``.

* ``bdmm(x, blocks, transpose_blocks=False)`` replaces
  ``repro/kernels/bdmm.py`` ``bdmm_pallas`` (and its per-row ``vmap``,
  ``ops.bdmm_banked``): y[z, t, g*bo + i] = sum_j W[z, g, i, j]
  x[z, t, g*bi + j] with W = blocks (B, r, bo, bi), or W = blocks^T read in
  place from blocks (B, r, bi, bo) when ``transpose_blocks`` is set (JAX's
  ``bdmm_pallas(blocks^T, x)``, without the copy); x (B, T, r*bi) -> y
  (B, T, r*bo), one dtype (bf16 or f32), fp32 sums. OFT and BOFT run
  through it: the weight-side materialization (training, merge) with
  B = 1, the banked serving rotation with one row per request.
* ``bdmm_dblocks(dy, x, bo, bi)`` replaces ``bdmm_dblocks_pallas``: the
  gradient of the blocks, dblocks[z, g] = sum_t dy[z, t, g] x[z, t, g]^T,
  (B, r, bo, bi) in fp32. Deterministic: no atomics, a fixed summation
  order (repeated runs are bit-identical).

Any block size. A CUDA tensor runs a kernel or raises; a CPU tensor runs
the plain version beside it (``ref.py``). Nothing falls back. One call
counts one launch on the wrapper (``bdmm_dblocks``'s split sum is part of
that call). The route and its launch geometry are chosen here
(``bdmm_plan``, ``dblocks_plan``) and checked again by the C side:

* ``tc`` — the tensor cores (``mma.sync``, bf16, x / dy tiles through a
  ``cp.async`` ring): ``bdmm`` at T >= 16 with bo and bi multiples of 8 and
  bi <= 512; ``bdmm_dblocks`` with bo and bi multiples of 8;
* ``decode`` — ``bdmm`` at T < 16 when a block row is 16-byte aligned
  (either dtype): one read of the blocks, warp-shuffle sums;
* ``cc`` — the CUDA cores in full fp32: every f32 input (TF32 would not hold
  the f32 tolerances) and the bf16 shapes the routes above refuse.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, ref
from .gs_fused import _DTYPES, _num_sms

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# every bdmm entry: blocks, x, y, B, T, r, bo, bi, trans, <geometry>, stream
# every dblocks entry: dy, x, partial sums, dblocks, B, T, r, bo, bi,
# <geometry>, stream
_ENTRIES = {  # entry -> (dtypes, number of geometry ints)
    "bdmm_tc": (("bf16",), 6), "bdmm_decode": (("f32", "bf16"), 1),
    "bdmm_cc": (("f32", "bf16"), 5),
    "bdmm_dblocks_tc": (("bf16",), 6), "bdmm_dblocks_cc": (("f32", "bf16"), 5),
}
_LIB = []

# shapes the C side shares (csrc/bdmm.cu)
SMEM_LIMIT = 232448        # bytes of shared memory one CTA may use
SMEM_PER_SM = 233472       # an SM's shared memory; 1 KB of it reserved per CTA
MAX_THREADS = 256          # every kernel is __launch_bounds__(256)
DECODE_THREADS = 128       # the decode kernel's CTAs
TC_STAGES = 3              # cp.async ring depth of the tensor-core kernels
CC_STAGES = 2              # double buffering on the CUDA cores
DB_CC_TOKENS = 32          # tokens per tile of bdmm_dblocks_cc
# the routes (this module's choice)
DECODE_TOKENS = 16         # T below this: the decode kernel
TC_MAX_BI = 512            # B fragments of one k-sweep stay in 64 registers


class Plan(NamedTuple):
    """A kernel route and its launch: ``args`` are the geometry ints the C
    entry takes after the shapes; grid, threads and dynamic shared memory
    (bytes) follow from them as the C side computes them."""
    route: str
    args: tuple
    grid: tuple
    threads: int
    smem: int


def _lib() -> ctypes.CDLL:
    """The built ``csrc/bdmm.cu`` with its C signatures bound."""
    if not _LIB:
        lib = build.load("bdmm")
        for entry, (dts, n_geo) in _ENTRIES.items():
            n_ptr = 4 if "dblocks" in entry else 3
            n_shape = 5 if "dblocks" in entry else 6
            for dt in dts:
                fn = getattr(lib, f"{entry}_{dt}")
                fn.argtypes = [_PTR] * n_ptr + [_INT] * (n_shape + n_geo) + [_PTR]
                fn.restype = ctypes.c_int
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(n: int) -> int:
    """The least power of two >= n (n >= 1)."""
    return 1 << (max(n, 1) - 1).bit_length()


def _pitch(cols: int) -> int:
    """A bf16 row pitch >= cols, a multiple of 8 that is an odd number of
    16-byte units (``pad_pitch``: ldmatrix rows in distinct bank groups)."""
    p = _cdiv(cols, 8) * 8
    return p + 8 if (p // 8) % 2 == 0 else p


def _per_sm(smem: int, threads: int) -> int:
    """CTAs an SM can hold by shared memory and threads."""
    return max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // threads, 32))


def _tc_smem(kt, nt, gt, wpg, tm, bi, trans) -> int:
    ncg, kw = wpg * nt * 8, kt * 16
    xp = _pitch(gt * bi + max(0, kw - bi))
    bs = kw * _pitch(gt * ncg) if trans else gt * ncg * _pitch(kw)
    return (TC_STAGES * tm * xp + bs + tm * _pitch(gt * ncg)) * 2


def _cc_smem(gt, nc, kc, tt, es) -> int:
    return (_cdiv(gt * nc * (kc + 1), 4) * 4 * 4
            + CC_STAGES * tt * _cdiv(gt * kc, 8) * 8 * es)


def _db_tc_smem(gt, bo, bi, wm, wn, tk) -> int:
    return TC_STAGES * tk * (_pitch((gt - 1) * bo + 32 * wm)
                             + _pitch((gt - 1) * bi + 32 * wn)) * 2


def _db_cc_smem(gt, bo, bi, mi, nj, es) -> int:
    def pitch(b, m):
        return _cdiv((gt - 1) * b + _cdiv(m, 4) * 4, 8) * 8
    return CC_STAGES * DB_CC_TOKENS * (pitch(bo, mi) + pitch(bi, nj)) * es


def _tiles_per_cta(cols: int, tiles: int, slots: int, cap: int = 16) -> int:
    """Token tiles per CTA: the most (up to ``cap``, so the grid runs
    several waves) whose last wave fills at least 90 % of the ``slots``
    resident CTAs, else the best-filled; ``cols`` CTAs share each token
    chunk."""
    fill = {}
    for per in range(1, min(tiles, cap) + 1):
        ctas = cols * _cdiv(tiles, per)
        fill[per] = ctas / (_cdiv(ctas, slots) * slots)
    good = [per for per, f in fill.items() if f >= 0.9]
    return max(good) if good else max(fill, key=fill.get)


@functools.lru_cache(maxsize=4096)
def bdmm_plan(dtype: torch.dtype, bsz: int, t: int, r: int, bo: int, bi: int,
              sms: int, transpose_blocks: bool = False) -> Plan:
    """The route and launch of ``bdmm`` for x (bsz, t, r*bi) and the
    product's (bo, bi) blocks (``transpose_blocks``: stored (bi, bo)) on a
    card of ``sms`` SMs."""
    es = torch.finfo(dtype).bits // 8
    vec = 16 // es
    if t < DECODE_TOKENS and (bo if transpose_blocks else bi) % vec == 0:
        if transpose_blocks:     # lanes split the stored rows, 16 B of columns each
            lanes, items = min(8, _pow2(bi)), bsz * r * (bo // vec)
        else:                    # lanes split a block row, 16 B each
            lanes, items = min(32, _pow2(_cdiv(bi, vec))), bsz * r * bo
        return Plan("decode", (lanes.bit_length() - 1,),
                    (_cdiv(items * lanes, DECODE_THREADS), 1, 1),
                    DECODE_THREADS, 0)
    tc = (dtype == torch.bfloat16 and bo % 8 == 0 and bi % 8 == 0
          and bi <= TC_MAX_BI)
    if tc:
        kt = _pow2(_cdiv(bi, 16))                 # k-steps of 16
        # n-tiles of 8 per warp: B fragments nt * kt <= 32
        nt = (4 if kt <= 8 and bo % 32 == 0 else
              2 if kt <= 16 and bo % 16 == 0 else 1)
        wpg = min(8, _cdiv(bo, 8 * nt))           # warps per group
        nch = _cdiv(bo, wpg * nt * 8)             # CTAs along bo
        gt = 1 if nch > 1 else max(1, min(r, 4 // wpg))
        tm = 16 if t <= 16 else 32

        def smem_of(gt, tm):
            return _tc_smem(kt, nt, gt, wpg, tm, bi, transpose_blocks)
        while gt > 1 and smem_of(gt, tm) > SMEM_LIMIT:
            gt //= 2
        if smem_of(gt, tm) > SMEM_LIMIT:
            tm = 16
        tc = smem_of(gt, tm) <= SMEM_LIMIT
    if tc:
        tiles = _cdiv(t, tm)
        while gt > 1 and _cdiv(r, gt) * nch * bsz * tiles < 2 * sms:
            gt //= 2
        threads = gt * wpg * 32
        smem = smem_of(gt, tm)
        cols = _cdiv(r, gt) * nch * bsz
        per = _tiles_per_cta(cols, tiles, sms * _per_sm(smem, threads))
        return Plan("tc", (kt, nt, gt, wpg, tm, per * tm),
                    (_cdiv(r, gt) * nch, _cdiv(tiles, per), bsz), threads,
                    smem)
    # output columns per group: fewer (more CTAs along bo) while the whole
    # bi of the blocks and the x ring do not fit; past 32 columns, bi is
    # looped in chunks of kc instead (the blocks' chunk restaged per step)
    nc = min(bo, MAX_THREADS)
    while nc > 32 and _cc_smem(1, nc, bi, 32, es) > SMEM_LIMIT:
        nc = _cdiv(nc, 2)
    nch = _cdiv(bo, nc)
    kc = bi
    if _cc_smem(1, nc, bi, 32, es) > SMEM_LIMIT:
        kc = 8
        while _cc_smem(1, nc, 2 * kc, 32, es) <= SMEM_LIMIT // 2:
            kc *= 2
    gt = 1 if nch > 1 or kc < bi else max(
        1, min(r, MAX_THREADS // max(nc, bi), 65536 // (nc * (bi + 1) * 4)))
    tt = 8 if t <= 8 else 32
    tiles = _cdiv(t, tt)
    while gt > 1 and _cdiv(r, gt) * nch * bsz * tiles < 2 * sms:
        gt //= 2
    cols = _cdiv(r, gt) * nch * bsz
    per = max(1, min(16, cols * tiles // (8 * sms)))
    return Plan("cc", (gt, nc, kc, tt, per * tt),
                (_cdiv(r, gt) * nch, _cdiv(tiles, per), bsz),
                _cdiv(gt * nc, 32) * 32, _cc_smem(gt, nc, kc, tt, es))


@functools.lru_cache(maxsize=4096)
def dblocks_plan(dtype: torch.dtype, bsz: int, t: int, r: int, bo: int,
                 bi: int, sms: int) -> Plan:
    """The route and launch of ``bdmm_dblocks`` for dy (bsz, t, r*bo), x
    (bsz, t, r*bi): output tiles per CTA, and token splits (each a multiple
    of the tile's tokens) enough to fill the card about twice (tensor
    cores) or four CTAs per SM (CUDA cores)."""
    es = torch.finfo(dtype).bits // 8
    if dtype == torch.bfloat16 and bo % 8 == 0 and bi % 8 == 0:
        wm, wn = (1 if bo <= 32 else 2), (1 if bi <= 32 else 2)  # 32x32 warp tiles
        nti, ntj = _cdiv(bo, 32 * wm), _cdiv(bi, 32 * wn)
        gt = max(1, min(r, 8 // (wm * wn))) if nti == ntj == 1 else 1
        tk = 32
        threads = gt * wm * wn * 32
        smem = _db_tc_smem(gt, bo, bi, wm, wn, tk)
        cols = _cdiv(r, gt) * nti * ntj * bsz
        slots = sms * _per_sm(smem, threads)
        splits = max(1, min(_cdiv(t, tk), 2 * slots // cols))
        tps = _cdiv(_cdiv(t, splits), tk) * tk
        splits = _cdiv(t, tps)
        return Plan("tc", (gt, wm, wn, tk, splits, tps),
                    (_cdiv(r, gt) * nti * ntj, splits, bsz), threads, smem)
    mi, nj = min(bo, 64), min(bi, 64)             # output tile of a group
    nti, ntj = _cdiv(bo, mi), _cdiv(bi, nj)
    m4, n4 = _cdiv(mi, 4) * 4, _cdiv(nj, 4) * 4
    tiles_g = (m4 // 4) * (n4 // 4)               # 4 x 4 sub-tiles, one a thread
    gt = (max(1, min(r, MAX_THREADS // max(m4, n4), MAX_THREADS // tiles_g))
          if nti == ntj == 1 else 1)
    cols = _cdiv(r, gt) * nti * ntj * bsz
    splits = max(1, min(_cdiv(t, DB_CC_TOKENS), _cdiv(4 * sms, cols)))
    tps = _cdiv(_cdiv(t, splits), DB_CC_TOKENS) * DB_CC_TOKENS
    splits = _cdiv(t, tps)
    return Plan("cc", (gt, mi, nj, splits, tps),
                (_cdiv(r, gt) * nti * ntj, splits, bsz),
                _cdiv(gt * tiles_g, 32) * 32,
                _db_cc_smem(gt, bo, bi, mi, nj, es))


def _product_dims(blocks: torch.Tensor, transpose_blocks: bool) -> tuple:
    """(bo, bi) of the product W, W = blocks or blocks^T."""
    p, q = blocks.shape[-2:]
    return (q, p) if transpose_blocks else (p, q)


def _check(x: torch.Tensor, blocks: torch.Tensor,
           transpose_blocks: bool) -> None:
    if x.dim() != 3 or blocks.dim() != 4:
        raise ValueError(f"expected x (B, T, r * bi) and blocks (B, r, bo, bi);"
                         f" got x {tuple(x.shape)}, blocks "
                         f"{tuple(blocks.shape)}")
    bsz, r = blocks.shape[:2]
    bi = _product_dims(blocks, transpose_blocks)[1]
    if x.shape[0] != bsz or x.shape[2] != r * bi:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} against blocks "
                         f"{tuple(blocks.shape)} (need d = r * bi, "
                         f"transpose_blocks={transpose_blocks})")
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


def bdmm_plain(x: torch.Tensor, blocks: torch.Tensor,
               transpose_blocks: bool = False) -> torch.Tensor:
    """Plain version of ``bdmm`` (``ref.bdmm_banked_ref``)."""
    return ref.bdmm_banked_ref(blocks, x, transpose_blocks=transpose_blocks)


def bdmm(x: torch.Tensor, blocks: torch.Tensor,
         transpose_blocks: bool = False) -> torch.Tensor:
    """y[z] = diag(W[z]) x[z] over the last dim, per row, W = blocks or, with
    ``transpose_blocks``, blocks^T (read in place).

    x (B, T, r * bi); blocks (B, r, bo, bi), or (B, r, bi, bo) transposed
    -> (B, T, r * bo) in x.dtype. CUDA: a kernel (counted in
    ``bdmm.launches`` and, by route, ``bdmm.launches_by_route``); CPU: the
    plain version."""
    _check(x, blocks, transpose_blocks)
    if x.device.type == "cpu":
        return bdmm_plain(x, blocks, transpose_blocks)
    _kernel_args(x, blocks)
    bsz, t, _ = x.shape
    r = blocks.shape[1]
    bo, bi = _product_dims(blocks, transpose_blocks)
    y = torch.empty((bsz, t, r * bo), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or x.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        plan = bdmm_plan(x.dtype, bsz, t, r, bo, bi, _num_sms(x.device),
                         transpose_blocks)
        entry = f"bdmm_{plan.route}_{_DTYPES[x.dtype]}"
        err = getattr(lib, entry)(
            blocks.data_ptr(), x.data_ptr(), y.data_ptr(), bsz, t, r, bo, bi,
            int(transpose_blocks), *plan.args,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, entry)
    bdmm.launches += 1
    bdmm.launches_by_route[plan.route] = (
        bdmm.launches_by_route.get(plan.route, 0) + 1)
    return y


def bdmm_dblocks_plain(dy: torch.Tensor, x: torch.Tensor, bo: int,
                       bi: int) -> torch.Tensor:
    """Plain version of ``bdmm_dblocks`` (``ref.bdmm_dblocks_ref``)."""
    return ref.bdmm_dblocks_ref(dy, x, bo, bi)


def bdmm_dblocks(dy: torch.Tensor, x: torch.Tensor, bo: int,
                 bi: int) -> torch.Tensor:
    """dblocks[z, g, i, j] = sum_t dy[z, t, g*bo + i] x[z, t, g*bi + j].

    dy (B, T, r * bo), x (B, T, r * bi), one dtype -> (B, r, bo, bi) fp32.
    CUDA: a kernel (counted in ``bdmm_dblocks.launches``); CPU: the plain
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
    bsz, t = x.shape[:2]
    r = x.shape[2] // bi
    f32 = torch.float32
    if t == 0 or bsz == 0 or r == 0:     # no token: zero sums, no launch
        return torch.zeros((bsz, r, bo, bi), dtype=f32, device=x.device)
    dblocks = torch.empty((bsz, r, bo, bi), dtype=f32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        plan = dblocks_plan(x.dtype, bsz, t, r, bo, bi, _num_sms(x.device))
        splits = plan.args[-2]
        part = (torch.empty((splits, bsz, r, bo, bi), dtype=f32,
                            device=x.device) if splits > 1 else dblocks)
        entry = f"bdmm_dblocks_{plan.route}_{_DTYPES[x.dtype]}"
        err = getattr(lib, entry)(
            dy.data_ptr(), x.data_ptr(), part.data_ptr(), dblocks.data_ptr(),
            bsz, t, r, bo, bi, *plan.args,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, entry)
    bdmm_dblocks.launches += 1
    return dblocks


bdmm.launches = 0
bdmm.launches_by_route = {}     # the same launches split by route
bdmm_dblocks.launches = 0
