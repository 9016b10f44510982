"""Plain PyTorch versions of the port's kernels (port of the GS, bdmm,
Householder, Givens, quantized-matmul, attention and SSD parts of
``repro/kernels/ref.py``).

Each function is the semantic definition the CUDA kernels are held against,
and what a wrapper runs for a tensor that lies on the CPU. Like the JAX
oracles, they accumulate each block matmul in fp32 and cast the result to
``x.dtype`` between the two stages. The Householder and Givens banks have no
kernel (as in the JAX package): their plain versions run on every device.
"""
from __future__ import annotations

import torch


def bdmm_ref(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal matmul.

    blocks: (r, b_out, b_in);  x: (T, r * b_in)  ->  (T, r * b_out)
    y[t, g*b_out : (g+1)*b_out] = blocks[g] @ x[t, g*b_in : (g+1)*b_in]
    """
    r, b_out, b_in = blocks.shape
    t = x.shape[0]
    xg = x.reshape(t, r, b_in)
    yg = torch.einsum("gij,tgj->tgi", blocks.to(torch.float32),
                      xg.to(torch.float32))
    return yg.reshape(t, r * b_out).to(x.dtype)


def bdmm_banked_ref(blocks: torch.Tensor, x: torch.Tensor,
                    transpose_blocks: bool = False) -> torch.Tensor:
    """Per-row block-diagonal matmul.

    blocks: (B, r, b_out, b_in);  x: (B, T, r * b_in)  ->  (B, T, r * b_out)
    ``transpose_blocks``: multiply by blocks^T, blocks given (B, r, b_in,
    b_out)."""
    if transpose_blocks:
        blocks = blocks.transpose(-1, -2)
    bsz, r, b_out, b_in = blocks.shape
    t = x.shape[1]
    xg = x.reshape(bsz, t, r, b_in)
    yg = torch.einsum("zgij,ztgj->ztgi", blocks.to(torch.float32),
                      xg.to(torch.float32))
    return yg.reshape(bsz, t, r * b_out).to(x.dtype)


def bdmm_dblocks_ref(dy: torch.Tensor, x: torch.Tensor, bo: int,
                     bi: int) -> torch.Tensor:
    """Gradient of the blocks of ``bdmm_ref``, per row, in fp32.

    dy: (B, T, r * bo);  x: (B, T, r * bi)  ->  (B, r, bo, bi) with
    dblocks[z, g, i, j] = sum_t dy[z, t, g*bo + i] * x[z, t, g*bi + j].
    (The JAX package has no such function: its oracle is autodiff of
    ``bdmm_ref``, which computes the same sum.)"""
    bsz, t = dy.shape[0], dy.shape[1]
    r = dy.shape[-1] // bo
    dyg = dy.reshape(bsz, t, r, bo).to(torch.float32)
    xg = x.reshape(bsz, t, r, bi).to(torch.float32)
    return torch.einsum("ztgi,ztgj->zgij", dyg, xg)


def householder_banked_ref(V: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-row Householder product rotation y[i] = x[i] Q_i with
    Q_i = H(v_{i,1}) .. H(v_{i,k}),  H(v) = I - 2 v v^T.

    V: (B, k, d) pre-normalized unit reflection vectors; x: (B, T, d).
    Applied reflection by reflection in fp32 (x H = x - 2 (x.v) v), so no
    dense Q is ever formed."""
    y = x.to(torch.float32)
    v32 = V.to(torch.float32)
    for i in range(V.shape[1]):
        v = v32[:, i]                                     # (B, d)
        coef = torch.einsum("btd,bd->bt", y, v)
        y = y - 2.0 * coef[..., None] * v[:, None, :]
    return y.to(x.dtype)


def givens_rotate(y: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
                  off: int) -> torch.Tensor:
    """One brick-wall round on the last axis of y: the disjoint pairs
    (off + 2k, off + 2k + 1), k < p = c.shape[-1], get
    (a, b) -> (c a - s b, s a + c b); the boundary elements stay.
    c, s broadcast against y[..., :p]. Out of place (differentiable)."""
    p = c.shape[-1]
    pairs = y[..., off:off + 2 * p].unflatten(-1, (p, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    mid = torch.stack((c * a - s * b, s * a + c * b), dim=-1).flatten(-2)
    return torch.cat((y[..., :off], mid, y[..., off + 2 * p:]), dim=-1)


def givens_banked_ref(C: torch.Tensor, S: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Per-row Givens-round rotation y[i] = x[i] Q_i, Q_i = G_m .. G_1
    brick-wall rounds of disjoint 2 x 2 rotations (GOFT).

    C, S: (B, m, d//2) pre-evaluated cos/sin (the identity slot is c = 1,
    s = 0); x: (B, T, d). Round l pairs neighbours at offset l % 2. Row
    vector application: rounds reversed, angles negated. fp32 throughout."""
    d = x.shape[-1]
    y = x.to(torch.float32)
    c32, s32 = C.to(torch.float32), S.to(torch.float32)
    for lvl in reversed(range(C.shape[1])):
        off = lvl % 2
        p = (d - off) // 2
        if p == 0:
            continue
        y = givens_rotate(y, c32[:, lvl, None, :p], -s32[:, lvl, None, :p],
                          off)
    return y.to(x.dtype)


def _shuffle(y: torch.Tensor, k: int) -> torch.Tensor:
    """P_(k, d) over the last axis: reshape(k, d/k) -> transpose -> flatten."""
    lead, d = y.shape[:-1], y.shape[-1]
    return y.reshape(lead + (k, d // k)).transpose(-1, -2).reshape(lead + (d,))


def gs_banked_T_ref(L: torch.Tensor, R: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Per-row transpose GSOFT rotation  y[i] = R_i^T P^T L_i^T P x[i].

    L, R: (B, r, b, b); x: (B, T, d) with d = r*b. Row i computes x[i] Q_i
    with Q_i = P^T L_i P R_i (activation-side adapter, one per request).
    """
    r, b = L.shape[1], L.shape[2]
    y = _shuffle(x, r)                                    # P
    y = bdmm_banked_ref(L.transpose(-1, -2), y)           # L^T .
    y = _shuffle(y, b)                                    # P^T
    return bdmm_banked_ref(R.transpose(-1, -2), y)        # R^T .


def gs_fused_ref(L: torch.Tensor, R: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Fused GSOFT transform  y = P^T L P R x  with P = P_(r, d).

    L, R: (r, b, b); x: (T, d) with d = r*b.
    """
    r, b = L.shape[0], L.shape[1]
    y = bdmm_ref(R, x)                  # R x
    y = _shuffle(y, r)                  # P
    y = bdmm_ref(L, y)                  # L .
    return _shuffle(y, b)               # P^T


def gs_fused_T_ref(L: torch.Tensor, R: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Transpose GSOFT rotation  y = Q^T x = R^T P^T L^T P x."""
    r, b = L.shape[0], L.shape[1]
    y = _shuffle(x, r)                                # P
    y = bdmm_ref(L.transpose(-1, -2), y)              # L^T .
    y = _shuffle(y, b)                                # P^T
    return bdmm_ref(R.transpose(-1, -2), y)           # R^T .


def _p_gather(y: torch.Tensor, r: int) -> torch.Tensor:
    """P = P_(r, d) over the last axis: (P y)[i*r + g] = y[g*b + i]."""
    return _shuffle(y, r)


def _gs_bwd_fp32(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                 dy: torch.Tensor, with_dx: bool):
    """Backward of y = P^T L P R x with every intermediate in fp32 (the
    formulas of ``repro/kernels/gs_fused.py`` ``_gs_fused_bwd_kernel``)."""
    r, b = L.shape[0], L.shape[1]
    t, d = x.shape
    f32 = torch.float32
    L32, R32 = L.to(f32), R.to(f32)
    xg = x.to(f32).reshape(t, r, b)
    u = torch.einsum("gij,tgj->tgi", R32, xg).reshape(t, d)    # u = R x
    v = _p_gather(u, r).reshape(t, r, b)                      # v = P u
    dw = _p_gather(dy.to(f32), r).reshape(t, r, b)            # dw = P dy
    dL = torch.einsum("tgi,tgj->gij", dw, v)
    dv = torch.einsum("gij,tgi->tgj", L32, dw).reshape(t, d)  # dv = L^T dw
    du = _shuffle(dv, b).reshape(t, r, b)                     # du = P^T dv
    dR = torch.einsum("tgi,tgj->gij", du, xg)
    if not with_dx:
        return dL, dR
    dx = torch.einsum("gij,tgi->tgj", R32, du).reshape(t, d)  # dx = R^T du
    return dx.to(x.dtype), dL, dR


def gs_fused_bwd_ref(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                     dy: torch.Tensor):
    """Fused backward of y = P^T L P R x for one row.

    L, R: (r, b, b); x, dy: (T, d). Returns (dx, dL, dR): dx = Q^T dy in
    x.dtype, dL[g] = sum_t (P dy)_g (P R x)_g^T and
    dR[g] = sum_t (P^T L^T P dy)_g x_g^T in fp32. Every intermediate stays
    in fp32, as in the Pallas kernel."""
    return _gs_bwd_fp32(L, R, x, dy, with_dx=True)


def gs_fused_grads_ref(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                       dy: torch.Tensor):
    """(dL, dR) of <dy, P^T L P R x> for one row, fp32 (no dx)."""
    return _gs_bwd_fp32(L, R, x, dy, with_dx=False)


def _scale_row(scale, n: int) -> torch.Tensor:
    """A per-output-channel (1, N) / (N,) or scalar scale as fp32 (1, N)."""
    s = torch.as_tensor(scale, dtype=torch.float32)
    return s.reshape(1, -1).expand(1, n) if s.dim() else s.reshape(1, 1).expand(1, n)


def q_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale) -> torch.Tensor:
    """Quantized-weight matmul: x (T, K) float; q (K, N) int8 codes; scale
    fp32 (1, N) per output channel or a scalar. y = (x @ q) * scale with
    fp32 products and sums, cast to x.dtype: the dequant runs in the
    epilogue, never as a float (K, N) weight of x's dtype."""
    y = x.to(torch.float32) @ q.to(torch.float32)
    return (y * _scale_row(scale, q.shape[1]).to(y.device)).to(x.dtype)


def gs_q_matmul_ref(L: torch.Tensor, R: torch.Tensor, x: torch.Tensor,
                    q: torch.Tensor, scale) -> torch.Tensor:
    """Activation-side GS rotation, rounded to x.dtype, then the quantized
    matmul: y = round(x Q_gs) @ dequant(q, scale). L, R: (r, b, b);
    x: (T, d = r*b)."""
    return q_matmul_ref(gs_fused_T_ref(L, R, x), q, scale)


def gs_q_matmul_banked_ref(L: torch.Tensor, R: torch.Tensor,
                           x: torch.Tensor, q: torch.Tensor,
                           scale) -> torch.Tensor:
    """Per-row fused rotate + quantized matmul: L, R (B, r, b, b), x
    (B, T, d), one shared q (d, N): y[i] = round(x[i] Q_i) @ dequant(q)."""
    bsz, t, d = x.shape
    xr = gs_banked_T_ref(L, R, x)
    y = q_matmul_ref(xr.reshape(bsz * t, d), q, scale)
    return y.reshape(bsz, t, y.shape[-1])


def paged_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, table: torch.Tensor, kv_len,
                   scale: float = 0.0) -> torch.Tensor:
    """Paged decode attention: one query token per row over the KV pages
    its table maps to.

    q: (B, H, D); k_pages, v_pages: (P, page, K, D) shared page pools;
    table: (B, W) int page table (stream page j of row b lives in physical
    page table[b, j]); kv_len: (B,) valid key counts. GQA: H = K * G.
    fp32 softmax over the gathered keys; returns (B, H, D) in q.dtype."""
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    g = h // kh
    scale = scale or 1.0 / (d ** 0.5)
    tbl = table.long()
    k = k_pages[tbl].reshape(b, -1, kh, d)
    v = v_pages[tbl].reshape(b, -1, kh, d)
    qg = (q.to(torch.float32) * scale).reshape(b, kh, g, d)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k.to(torch.float32))
    kpos = torch.arange(k.shape[1], device=q.device)
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1)
    s = torch.where(kpos[None, None, None, :] < kv_len[:, None, None, None],
                    s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float = 0.0) -> torch.Tensor:
    """Plain softmax attention. q: (H, Sq, D); k, v: (H, Sk, D). The causal
    mask is ``i >= j`` on absolute indices from 0 (as the JAX oracle).
    One fp32 softmax; returns (H, Sq, D) in q.dtype."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    scale = scale or 1.0 / (d ** 0.5)
    s = torch.einsum("...qd,...kd->...qk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p,
                        v.to(torch.float32)).to(q.dtype)


def ssd_ref(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, initial_state: torch.Tensor | None = None,
            return_state: bool = False):
    """Mamba2 SSD (state-space dual): the sequential scan.

    x: (T, H, P) inputs (already times dt); loga: (T, H) log decay per step
    (dt * A, A < 0); B, C: (T, H, N) per-head input / output projections;
    state (H, N, P):

        S_t = exp(loga_t) S_{t-1} + B_t x_t^T,   y_t = C_t^T S_t

    All in fp32; y in x.dtype. With ``return_state``: (y, S_T)."""
    T, H, P = x.shape
    N = B.shape[-1]
    f32 = torch.float32
    S = (torch.zeros((H, N, P), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    xf, laf, Bf, Cf = (a.to(f32) for a in (x, loga, B, C))
    ys = []
    for t in range(T):
        S = (torch.exp(laf[t])[:, None, None] * S
             + Bf[t][:, :, None] * xf[t][:, None, :])
        ys.append(torch.einsum("hn,hnp->hp", Cf[t], S))
    y = (torch.stack(ys) if ys else torch.zeros_like(xf)).to(x.dtype)
    if return_state:
        return y, S
    return y


def ssd_chunked_ref(x: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """The chunk-parallel SSD (the algorithm the kernels implement): within
    a chunk of Q steps the causal decay-masked scores (C B^T) o
    exp(cum_t - cum_s) times x, plus (C o exp(cum)) S; across chunks the
    state S <- exp(total) S + sum_q exp(total - cum_q) B_q x_q^T. All fp32.

    x: (..., T, H, P); loga: (..., T, H); B, C: (..., T, H, N), any leading
    batch dims (the JAX oracle takes one row; ``ops.ssd`` vmaps it). T must
    be a multiple of ``chunk``. Returns y in x.dtype."""
    T, H, P = x.shape[-3:]
    N = B.shape[-1]
    assert T % chunk == 0, (T, chunk)
    f32 = torch.float32
    xf = x.to(f32).reshape(-1, T, H, P)
    nb = xf.shape[0]
    laf = loga.to(f32).reshape(nb, T, H)
    Bf = B.to(f32).reshape(nb, T, H, N)
    Cf = C.to(f32).reshape(nb, T, H, N)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    S = torch.zeros((nb, H, N, P), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, T, chunk):
        xq, laq = xf[:, c0:c0 + chunk], laf[:, c0:c0 + chunk]
        Bq, Cq = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]
        cum = torch.cumsum(laq, dim=1)                       # (nb, Q, H)
        total = cum[:, -1]                                   # (nb, H)
        rel = cum[:, :, None, :] - cum[:, None, :, :]        # (nb, Q, Q, H)
        # exp only on causal entries: above the diagonal rel > 0 overflows
        gamma = torch.exp(rel.masked_fill(~mask[None, :, :, None],
                                          float("-inf")))
        scores = torch.einsum("zthn,zshn->ztsh", Cq, Bq) * gamma
        y = torch.einsum("ztsh,zshp->zthp", scores, xq)
        y = y + torch.einsum("zthn,zhnp->zthp",
                             Cq * torch.exp(cum)[..., None], S)
        w = torch.exp(total[:, None, :] - cum)               # (nb, Q, H)
        S = (torch.exp(total)[:, :, None, None] * S
             + torch.einsum("zqhn,zqhp->zhnp", Bq * w[..., None], xq))
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else xf
    return y.reshape(x.shape).to(x.dtype)
