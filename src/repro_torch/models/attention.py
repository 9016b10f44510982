"""Attention with GQA, RoPE, a contiguous KV cache and a paged one (port of
``repro/models/attention.py``: ``init_attention``, ``online_attention``,
``prefix_loop_attention`` (``cfg.attn_impl == "prefix_loop"``: causal
prefill and training), ``init_cache``, ``attention_block`` (self-attention,
and cross-attention over ``kv_x`` for the encoder-decoder),
``init_paged_kv``, ``paged_attention_block``,
``paged_prefill_chunk_block``). The contiguous path, cross-attention and
chunked prefill are plain torch; paged decode runs
``ops.paged_attention`` (the paged decode kernel on the card), as the JAX
package's ``use_pallas`` branch does.

The KV sequence is processed in ``attn_chunk`` slices with running
(max, denom, acc) statistics, as in the JAX package; GQA never repeats KV
heads. The decode path writes this step's K/V into the cache IN PLACE (the
JAX package returns a new cache; the port saves the copy); the paged path
writes its pages in place too (``index_put_`` on the pools).

Under tensor parallelism (``tp``, a ``distrib.tp.TPShard``) every tensor
has the rank's local head count: wq / wk / wv are column-parallel, ``wo``
row-parallel (its partial outputs all-reduce), and where the kv heads do
not split the rank computes all K and keeps the ones its q heads read
(``TPShard.select_kv``), so caches and pools hold local kv heads and every
kernel sees a uniform local grouping. The contiguous block is also the
training path: its input passes ``tp.enter`` and its output ``tp.leave``
(the autograd-aware collectives; under sequence parallelism the sequence
is gathered at the input and reduce-scattered at the output). With ``tp``
None nothing changes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from .layers import (Rot, apply_rope, keep_all, qlinear, row_linear,
                     stacked_dense_init)

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, stacked: int,
                   device, dtype=None, keep=keep_all,
                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """Layer-stacked weights (stacked, d_in, d_out), or one layer's
    (d_in, d_out) when ``stacked`` is 0 (the hybrid's shared block).
    ``keep(path, leaf)`` takes each weight as it is drawn."""
    d = cfg.d_model
    dtype = dtype or cfg.weight_dtype
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    n = max(stacked, 1)

    def mk(name, di, do):
        w = stacked_dense_init(gen, n, di, do, dtype, device)
        return keep(prefix + name, w if stacked else w[0])

    p = {"wq": mk("wq", d, H * hd), "wk": mk("wk", d, K * hd),
         "wv": mk("wv", d, K * hd), "wo": mk("wo", H * hd, d)}
    if cfg.qkv_bias:
        lead = (stacked,) if stacked else ()
        for name, do in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = keep(prefix + name, torch.zeros(
                lead + (do,), dtype=dtype, device=device))
    return p


def online_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, kv_len, *, causal: bool, chunk: int,
                     scale: float) -> torch.Tensor:
    """Chunked-softmax attention.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D); q_pos: (B, Sq) absolute positions;
    key positions are arange(Sk); kv_len (int or (B,) tensor) bounds the
    valid KV region. Returns (B, Sq, H, D) in q.dtype.
    """
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = (q * scale).reshape(b, sq, kh, g, dh)
    nchunks = max(1, math.ceil(sk / chunk))
    c = math.ceil(sk / nchunks)
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1)
    kv_len = kv_len.expand(b) if kv_len.numel() == 1 else kv_len

    m = torch.full((b, sq, kh, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, kh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kh, g, dh), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        kj = k[:, ci * c:(ci + 1) * c]
        vj = v[:, ci * c:(ci + 1) * c]
        kpos = ci * c + torch.arange(kj.shape[1], device=q.device)
        # model-dtype operands, fp32 products and sums (the JAX einsums'
        # preferred_element_type=f32)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg.to(torch.float32),
                         kj.to(torch.float32))
        valid = kpos[None, None, :] < kv_len[:, None, None]          # (B,1,c)
        if causal:
            valid = valid & (kpos[None, None, :] <= q_pos[:, :, None])
        s = torch.where(valid[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(vj.dtype).to(torch.float32),
            vj.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def prefix_loop_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, chunk: int, scale: float) -> torch.Tensor:
    """Exact-triangular causal attention: query chunk i attends only to
    keys [0, (i + 1) chunk), one ``online_attention`` a chunk. Falls back to
    ``online_attention`` over the whole sequence when chunk does not divide
    S, as JAX's does."""
    b, s = q.shape[:2]
    if s % chunk:
        return online_attention(q, k, v, _positions(b, s, q.device), s,
                                causal=True, chunk=chunk, scale=scale)
    outs = []
    for i in range(s // chunk):
        hi = (i + 1) * chunk
        pos = _positions(b, chunk, q.device) + i * chunk
        outs.append(online_attention(q[:, i * chunk:hi], k[:, :hi],
                                     v[:, :hi], pos, hi, causal=True,
                                     chunk=chunk, scale=scale))
    return torch.cat(outs, dim=1)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int64, device=device)[None, :].expand(b, s)


def _proj(x, w, bias=None, rot: Rot = None, name=""):
    y = qlinear(x, w, rot, name)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _qkv(p, x, hd: int, rot: Rot, tp, kv_x=None):
    """q, k, v as (B, S, heads, hd) at the rank's local head counts; K and
    V projected from ``kv_x`` (cross-attention: its own length) when
    given."""
    b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _proj(x, p["wq"], p.get("bq"), rot, "wq").reshape(b, s, -1, hd)
    k = _proj(src, p["wk"], p.get("bk"), rot, "wk").reshape(
        b, src.shape[1], -1, hd)
    v = _proj(src, p["wv"], p.get("bv"), rot, "wv").reshape(
        b, src.shape[1], -1, hd)
    if tp is not None:
        k, v = tp.select_kv(k), tp.select_kv(v)
    return q, k, v


def _out(p, out: torch.Tensor, rot: Rot, tp) -> torch.Tensor:
    """The ``wo`` projection: row-parallel when the q heads split."""
    out = out.reshape(out.shape[0], out.shape[1], -1)
    if tp is not None and tp.heads_split:
        return row_linear(out, p["wo"], rot, "wo", tp)
    y = qlinear(out, p["wo"], rot, "wo")
    return y if tp is None else tp.leave(y, False)


def attention_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cfg: ModelConfig, *,
                    kv_x: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_pos: Optional[torch.Tensor] = None,
                    causal: bool = True, rot: Rot = None, tp=None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self- or cross-attention with an optional contiguous KV cache.

    ``rot(name, x)`` rotates the inputs of wq/wk/wv/wo (per-request GSOFT).
    * prefill: ``cache`` given, ``cache_pos`` None — K/V written at [0, S)
    * decode: x (B, 1, D), ``cache_pos`` a (B,) tensor of per-row write
      positions (or a scalar); this step's K/V are written there in place
      and the step attends over [0, cache_pos].
    * cross-attention: ``kv_x`` (B, F, D) gives K and V (no cache, no
      RoPE); with ``causal=False`` every query reads all F of them, as the
      encoder's self-attention reads its whole input.
    Returns (output, cache).
    """
    if tp is not None:
        if kv_x is not None:
            raise NotImplementedError(
                "cross-attention does not split over ranks (the encdec "
                "family has no tensor-parallel path)")
        x = tp.enter(x, tp.heads_split)
    b, sq, _ = x.shape
    hd = cfg.d_head
    q, k, v = _qkv(p, x, hd, rot, tp, kv_x)

    positions = _positions(b, sq, x.device)
    if cache_pos is not None:
        cache_pos = torch.as_tensor(cache_pos, dtype=torch.int64,
                                    device=x.device).reshape(-1).expand(b)
        positions = positions + cache_pos[:, None]
    if kv_x is None:
        # self-attention: the new keys share the queries' positions
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    scale = 1.0 / math.sqrt(hd)
    if cache is not None and cache_pos is not None and sq == 1:
        # clamp like the JAX dynamic_update_slice does for an out-of-range row
        idx = cache_pos.clamp(max=cache["k"].shape[1] - 1)
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
        out = online_attention(q, cache["k"], cache["v"], positions,
                               cache_pos + 1, causal=False,
                               chunk=cfg.attn_chunk, scale=scale)
    else:
        if cache is not None:
            cache["k"][:, :sq] = k.to(cache["k"].dtype)
            cache["v"][:, :sq] = v.to(cache["v"].dtype)
        if causal and cfg.attn_impl == "prefix_loop" and kv_x is None:
            out = prefix_loop_attention(q, k, v, chunk=cfg.attn_chunk,
                                        scale=scale)
        else:
            out = online_attention(q, k, v, positions, k.shape[1],
                                   causal=causal, chunk=cfg.attn_chunk,
                                   scale=scale)
    return _out(p, out, rot, tp), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=None, kv_heads: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """``kv_heads``: the rank's local kv heads (default all)."""
    dtype = dtype or cfg.act_dtype
    K, hd = kv_heads or cfg.num_kv_heads, cfg.d_head
    return {"k": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# paged KV cache: fixed-size pages + per-slot page tables
# ---------------------------------------------------------------------------

def init_paged_kv(cfg: ModelConfig, num_pages: int, page_size: int, device,
                  dtype=None, kv_heads: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """One layer's shared page pools (``kv_heads``: the rank's local kv
    heads, default all). Page 0 is the GARBAGE page: parked /
    out-of-range table entries resolve there, so full-batch decode can write
    through every row's table unconditionally."""
    dtype = dtype or cfg.act_dtype
    K, hd = kv_heads or cfg.num_kv_heads, cfg.d_head
    return {"k": torch.zeros((num_pages, page_size, K, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((num_pages, page_size, K, hd), dtype=dtype,
                             device=device)}


def paged_attention_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                          cfg: ModelConfig, *, pages: Dict[str, torch.Tensor],
                          table: torch.Tensor, pos: torch.Tensor,
                          rot: Rot = None, tp=None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step through the paged KV cache.

    x: (B, 1, D); pages: this layer's {"k", "v"} (P, page, K, D) pools;
    table: (B, max_pages + 1) int32 — the LAST column is a sentinel that is
    always the garbage page, so a parked row (pos == max_pages * page) routes
    its write there; pos: (B,) write positions. The pages are written in
    place. Returns (out, pages)."""
    if tp is not None:
        x = tp.enter(x, tp.heads_split)
    b, sq, _ = x.shape
    hd = cfg.d_head
    q, k, v = _qkv(p, x, hd, rot, tp)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64).reshape(-1)
    positions = pos[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    page = pages["k"].shape[1]
    pid = table.long().gather(1, (pos // page)[:, None])[:, 0]
    off = pos % page
    pages["k"].index_put_((pid, off), k[:, 0].to(pages["k"].dtype))
    pages["v"].index_put_((pid, off), v[:, 0].to(pages["v"].dtype))

    # under tp the kernel behind ``head_shard_map``: the rank's own heads
    attend = kernel_ops.paged_attention if tp is None else tp.paged_attention
    out = attend(q[:, 0], pages["k"], pages["v"], table[:, :-1], pos + 1,
                 scale=1.0 / math.sqrt(hd))[:, None]  # sentinel column dropped
    return _out(p, out, rot, tp), pages


def paged_prefill_chunk_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                              cfg: ModelConfig, *,
                              pages: Dict[str, torch.Tensor],
                              table_row: torch.Tensor, start: int,
                              rot: Rot = None, tp=None
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One prompt CHUNK for one slot (batch of 1) through the paged cache.

    x: (1, C, D); table_row: (max_pages + 1,) this slot's page table;
    start: absolute position of the chunk's first token (earlier chunks and
    any shared-prefix pages already occupy [0, start)). Writes the chunk's
    K/V through the table in place and attends causally over [0, start + C)
    with the chunked online softmax over the gathered row (plain torch, as
    in the JAX package)."""
    b, c, _ = x.shape
    hd = cfg.d_head
    q, k, v = _qkv(p, x, hd, rot, tp)
    K = k.shape[2]
    start = int(start)
    positions = start + _positions(b, c, x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    page = pages["k"].shape[1]
    row = table_row.long()
    idx = start + torch.arange(c, device=x.device)
    # a chunk's padding past the table clamps onto the sentinel (garbage)
    # column, as the JAX gather clamps an out-of-range index
    pid = row[(idx // page).clamp(max=row.shape[0] - 1)]
    off = idx % page
    pages["k"].index_put_((pid, off), k[0].to(pages["k"].dtype))
    pages["v"].index_put_((pid, off), v[0].to(pages["v"].dtype))

    kt = pages["k"][row[:-1]].reshape(1, -1, K, hd)
    vt = pages["v"][row[:-1]].reshape(1, -1, K, hd)
    out = online_attention(q, kt, vt, positions, start + c, causal=True,
                           chunk=cfg.attn_chunk, scale=1.0 / math.sqrt(hd))
    return _out(p, out, rot, tp), pages
