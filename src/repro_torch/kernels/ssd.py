"""Mamba2 SSD chunked-scan kernels: wrappers, plain versions, launch
counters.

Sources: ``csrc/ssd.cu`` (the scan) and ``csrc/ssd_bwd.cu`` (its
gradient), CUDA C++ for sm_90a, built by ``build.py``.

``ssd(x, loga, B, C)`` replaces ``repro/kernels/ssd.py`` ``ssd_pallas``:
the SSD recurrence S_t = exp(loga_t) S_{t-1} + B_t x_t^T, y_t = C_t^T S_t
from a zero state, chunk-parallel, for x (Nb, T, H, P), loga (Nb, T, H),
B, C (Nb, T, H, N) in one dtype (bf16 or f32) -> y (Nb, T, H, P) in that
dtype; all state math fp32. Every Mamba layer of every prefill (and
forward) of the ``ssm`` and ``hybrid`` families runs it once, the whole
batch in one launch. A CUDA tensor runs the kernel or raises; a CPU tensor
runs the plain version (``ssd_plain``, differentiable by torch autograd as
JAX differentiates its plain scan). A CUDA input that needs a gradient goes
through ``dispatch.ssd_diff``: the forward kernel, which then also writes
every chunk's start state (``ssd_fwd``), and ``ssd_bwd`` for the backward.

``ssd_bwd(x, loga, B, C, dy)`` -> (dx, dloga, dB, dC) is the port's own
kernel (the JAX package has no backward kernel: it takes ``jax.grad`` of
its plain scan): the same chunked form in reverse, every chunk of a head
at once, the state gradient handed from chunk c + 1 to chunk c through
device memory (see ``csrc/ssd_bwd.cu``). It takes P up to ``BWD_MAX_P``
and N up to ``MAX_N``; its plain version is autograd through ``ssd_plain``.

The chunk is the kernels' own (``CHUNK`` = 64 steps, any T, the last chunk
padded); the plain version takes ``ref.ssd_chunked_ref`` at
``pick_chunk(T, chunk)``, as the JAX package's default path. The two agree
up to rounding. The forward runs every chunk of a (row, head) at once and
hands the N x P state from chunk to chunk through device memory (see
``csrc/ssd.cu``); ``ssd_geometry`` picks the P tile: the fewest tiles of at
most ``MAX_P_TILE`` columns that fit shared memory. The hand-offs' ticket
counter and chain flags (both kernels') live in one int64 buffer per
(device, stream), never reset: the wrapper passes the counter's running
total and a fresh epoch with each launch. So a launch must not be captured
in a CUDA graph (a replay would reuse the epoch).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, gs_fused, ref
from .dispatch import pick_chunk

# constants of csrc/ssd.cu the wrapper mirrors (checked when it loads)
CHUNK = 64                   # steps per chunk (kQ)
MAX_P_TILE = 64              # P columns a unit (kMaxPT)
MAX_N = 256                  # largest state width N (kMaxN)
BWD_MAX_P = 64               # widest head the backward takes (ssd_bwd.cu kMaxP)
SMEM_LIMIT = 232448 - 16     # a unit's dynamic shared memory, bytes
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# x, loga, B, C, y, hand-off slots, chunk states, sync buffer, counter base,
# epoch, Nb, T, H, P, N, pt, warps a unit, stream
_ARGTYPES = ([_PTR] * 8 + [ctypes.c_ulonglong, ctypes.c_uint] + [_INT] * 7
             + [_PTR])
# x, loga, B, C, dy, states, state-gradient slots, dx, dloga, dB, dC, sync
# buffer, counter base, epoch, Nb, T, H, P, N, P tile, its padded width,
# stream
_BWD_ARGTYPES = ([_PTR] * 12 + [ctypes.c_ulonglong, ctypes.c_uint]
                 + [_INT] * 7 + [_PTR])
_LIB = []
_BWD_LIB = []
_SYNC = {}                   # (device, stream) -> [buffer, base, epoch]


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("ssd")
        for dt in _DTYPES.values():
            fn = getattr(lib, f"ssd_chunked_scan_{dt}")
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_error_string.restype = ctypes.c_char_p
        lib.ssd_constants.argtypes = [_PTR]
        lib.ssd_constants.restype = None
        lib.ssd_smem.argtypes = [_INT, _INT]
        lib.ssd_smem.restype = _INT
        got = (ctypes.c_int * 3)()
        lib.ssd_constants(got)
        smem = [(lib.ssd_smem(n, pt), ssd_smem(n, pt))
                for n, pt in ((64, 64), (128, 40), (256, 10))]
        if (tuple(got) != (CHUNK, MAX_P_TILE, MAX_N)
                or any(a != b for a, b in smem)):
            raise RuntimeError(f"ssd.cu constants {tuple(got)} / shared "
                               f"memory {smem} differ from the wrapper's")
        _LIB.append(lib)
    return _LIB[0]


def _bwd_lib() -> ctypes.CDLL:
    if not _BWD_LIB:
        lib = build.load("ssd_bwd")
        for dt in _DTYPES.values():
            fn = getattr(lib, f"ssd_bwd_{dt}")
            fn.argtypes = _BWD_ARGTYPES
            fn.restype = ctypes.c_int
        lib.ssd_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_bwd_error_string.restype = ctypes.c_char_p
        lib.ssd_bwd_constants.argtypes = [_PTR]
        lib.ssd_bwd_constants.restype = None
        lib.ssd_bwd_smem.argtypes = [_INT, _INT]
        lib.ssd_bwd_smem.restype = _INT
        got = (ctypes.c_int * 3)()
        lib.ssd_bwd_constants(got)
        smem = [(lib.ssd_bwd_smem(n, p), ssd_bwd_smem(n, p))
                for n, p in ((64, 64), (128, 64), (256, 64), (100, 20))]
        if (tuple(got) != (CHUNK, BWD_MAX_P, MAX_N)
                or any(a != b for a, b in smem)):
            raise RuntimeError(f"ssd_bwd.cu constants {tuple(got)} / shared "
                               f"memory {smem} differ from the wrapper's")
        _BWD_LIB.append(lib)
    return _BWD_LIB[0]


def ssd_bwd_smem(n: int, p: int) -> int:
    """Bytes of dynamic shared memory of a backward unit (csrc/ssd_bwd.cu
    ``Layout``): C, B; x, dy, Z; G, M; six step vectors and a reduction row
    of 256."""
    cp = -(-n // 16) * 16 + 4
    pp = -(-p // 8) * 8 + 4
    gp = CHUNK + 4
    return 4 * (2 * CHUNK * cp + 3 * CHUNK * pp + 2 * CHUNK * gp
                + 6 * CHUNK + 256)


def ssd_smem(n: int, pt: int) -> int:
    """Bytes of dynamic shared memory of a unit (csrc/ssd.cu ``Layout``)."""
    np_ = -(-n // 16) * 16
    xp = -(-pt // 16) * 16 + 8
    return 4 * (2 * CHUNK * (np_ + 4) + CHUNK * xp
                + max(CHUNK * (CHUNK + 4), np_ * xp) + 3 * CHUNK)


def ssd_geometry(p: int, n: int = 0) -> int:
    """The P tile: P cut into the fewest tiles of at most ``MAX_P_TILE``
    columns, halved while a unit of state width ``n`` would not fit in
    shared memory. Every chunk is a unit of its own, so the units fill the
    card without a narrower tile (which recomputes C B^T: slower at every
    shape measured on the H100, ``tools/ssd_qmm_sweep.py``)."""
    pt = -(-p // -(-p // MAX_P_TILE))
    while pt > 8 and ssd_smem(n, pt) > SMEM_LIMIT:
        pt = -(-pt // 2)
    return pt


def ssd_warps(units: int, sms: int) -> int:
    """Warps a unit: 16 while the units fit two an SM (each then runs its
    phases on more warps: a zamba2 prefill), else 8 (more units resident
    an SM, less repeated fragment work: long T, large batches)."""
    return 16 if units <= 2 * sms else 8


def _sync_buffer(device: torch.device, stream: int, chains: int) -> list:
    """The (device, stream)'s ticket counter and chain flags, [buffer,
    counter base, epoch] with the epoch advanced for this launch."""
    key = (device.index, stream)
    rec = _SYNC.get(key)
    if rec is None or rec[0].numel() < 1 + chains or rec[2] >= 0xFFFFFFFF:
        rec = _SYNC[key] = [torch.zeros(1 + max(chains, 1024),
                                        dtype=torch.int64, device=device),
                            0, 0]
    rec[2] += 1
    return rec


def ssd_plain(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Plain version of ``ssd``: ``ref.ssd_chunked_ref`` at the largest
    chunk <= ``chunk`` that divides T."""
    return ref.ssd_chunked_ref(x, loga, B, C,
                               chunk=pick_chunk(x.shape[-3], chunk))


def _check(x, loga, B, C):
    if x.dim() != 4 or loga.dim() != 3 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"expected x (Nb, T, H, P), loga (Nb, T, H), B, C "
                         f"(Nb, T, H, N); got {tuple(x.shape)}, "
                         f"{tuple(loga.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    nb, t, h, _ = x.shape
    if tuple(loga.shape) != (nb, t, h) or tuple(B.shape[:3]) != (nb, t, h):
        raise ValueError(f"loga {tuple(loga.shape)} / B {tuple(B.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if x.dtype not in _DTYPES or not (x.dtype == loga.dtype == B.dtype
                                      == C.dtype):
        raise TypeError(f"x, loga, B and C must share one dtype (bf16 or "
                        f"f32); got {x.dtype}, {loga.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    if x.device.type == "cuda" and B.shape[-1] > MAX_N:
        raise ValueError(f"state width N={B.shape[-1]} exceeds the kernel's "
                         f"{MAX_N}")


def ssd(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """SSD scan over (Nb, T, H, P) -> (Nb, T, H, P) in x's dtype. CUDA: the
    kernel (counted in ``ssd.launches``; its chunk is ``CHUNK``, ``chunk``
    is unread), through ``dispatch.ssd_diff`` when an input needs a
    gradient; CPU: the plain version at ``chunk``."""
    _check(x, loga, B, C)
    if x.device.type == "cpu":
        return ssd_plain(x, loga, B, C, chunk)
    if torch.is_grad_enabled() and any(a.requires_grad
                                       for a in (x, loga, B, C)):
        from .dispatch import ssd_diff
        return ssd_diff(x, loga, B, C)
    return ssd_fwd(x, loga, B, C)[0]


def ssd_fwd(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, states: bool = False):
    """The forward kernel on CUDA inputs -> (y, saved): ``saved`` is None,
    or with ``states`` the chunk-start states the backward reads, (fp32
    buffer, P tile). Counted in ``ssd.launches``."""
    _check(x, loga, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_fwd runs the kernel: a CUDA tensor, not "
                         f"{x.device}")
    nb, t, h, p = x.shape
    n = B.shape[-1]
    x, loga, B, C = (a.detach().contiguous() for a in (x, loga, B, C))
    if x.numel() == 0:
        return torch.empty_like(x), None
    pt = ssd_geometry(p, n)
    units = nb * h * -(-p // pt) * -(-t // CHUNK)
    y, st = _launch(x, loga, B, C, pt,
                    ssd_warps(units, gs_fused._num_sms(x.device)), states)
    ssd.launches += 1
    return y, ((st, pt) if states else None)


def _launch(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, pt: int, warps: int, states: bool = False):
    """The kernel on contiguous CUDA inputs at P tile ``pt`` and ``warps``
    a unit (``ssd``'s rules pick them) -> (y, chunk-start states or
    None)."""
    nb, t, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    chunks = -(-t // CHUNK)
    chains = nb * h * -(-p // pt)
    slot = (-(-n // 16) * 16) * (-(-pt // 8) * 8)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        hand = torch.empty(chains * 2 * slot, dtype=torch.float32,
                           device=x.device)
        st = (torch.empty(chains * chunks * slot, dtype=torch.float32,
                          device=x.device) if states else None)
        rec = _sync_buffer(x.device, stream, chains)
        err = getattr(lib, f"ssd_chunked_scan_{_DTYPES[x.dtype]}")(
            x.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), hand.data_ptr(),
            st.data_ptr() if st is not None else None, rec[0].data_ptr(),
            rec[1], rec[2], nb, t, h, p, n, pt, warps, stream)
    if err != 0:
        msg = lib.ssd_error_string(err).decode()
        raise RuntimeError(f"ssd launch failed: {msg} (code {err}; "
                           f"Nb={nb} T={t} H={h} P={p} N={n} tile={pt})")
    rec[1] += chains * chunks
    return y, st


ssd.launches = 0


def ssd_bwd_plain(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, dy: torch.Tensor, chunk: int = 256):
    """Plain version of ``ssd_bwd``: torch autograd through ``ssd_plain``
    (fp32 math, gradients in the inputs' dtypes)."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(True) for a in (x, loga, B, C)]
        y = ssd_plain(*leaves, chunk)
        grads = torch.autograd.grad(y, leaves, dy.to(y.dtype))
    return tuple(g.detach() for g in grads)


def ssd_bwd(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, dy: torch.Tensor, saved=None, chunk: int = 256):
    """Gradients (dx, dloga, dB, dC) of ``ssd`` at (x, loga, B, C) for the
    output gradient dy, in the inputs' dtype. CUDA: the backward kernel
    (counted in ``ssd_bwd.launches``), from the forward's chunk-start
    states ``saved`` (``ssd_fwd(..., states=True)[1]``; without them the
    forward kernel runs first to write them); CPU: the plain version."""
    _check(x, loga, B, C)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ssd_bwd_plain(x, loga, B, C, dy, chunk)
    nb, t, h, p = x.shape
    n = B.shape[-1]
    if p > BWD_MAX_P:
        raise ValueError(f"head width P={p} exceeds the backward kernel's "
                         f"{BWD_MAX_P}")
    x, loga, B, C = (a.detach().contiguous() for a in (x, loga, B, C))
    dy = dy.detach().to(x.dtype).contiguous()
    if x.numel() == 0:
        return (torch.zeros_like(x), torch.zeros_like(loga),
                torch.zeros_like(B), torch.zeros_like(C))
    if saved is None:
        saved = ssd_fwd(x, loga, B, C, states=True)[1]
    states, pt = saved
    chunks = -(-t // CHUNK)
    chains = nb * h
    npad = -(-n // 16) * 16
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    dla = torch.empty_like(loga)
    lib = _bwd_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        dstate = torch.empty(chains * chunks * npad * p, dtype=torch.float32,
                             device=x.device)
        rec = _sync_buffer(x.device, stream, chains)
        err = getattr(lib, f"ssd_bwd_{_DTYPES[x.dtype]}")(
            x.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
            dy.data_ptr(), states.data_ptr(), dstate.data_ptr(),
            dx.data_ptr(), dla.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            rec[0].data_ptr(), rec[1], rec[2], nb, t, h, p, n, pt,
            -(-pt // 8) * 8, stream)
    if err != 0:
        msg = lib.ssd_bwd_error_string(err).decode()
        raise RuntimeError(f"ssd_bwd launch failed: {msg} (code {err}; "
                           f"Nb={nb} T={t} H={h} P={p} N={n})")
    rec[1] += chains * chunks
    ssd_bwd.launches += 1
    return dx, dla, dB, dC


ssd_bwd.launches = 0
