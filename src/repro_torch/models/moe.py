"""Token-choice top-k Mixture-of-Experts with capacity (port of
``repro/models/moe.py``: ``init_moe``, ``_capacity``, ``moe_layer``).

The JAX layer is plain ``jnp`` (one-hot dispatch / combine einsums), so the
port is plain torch and has no kernel. It keeps the JAX semantics exactly:

* the sequence is cut into segments of ``seg`` tokens, the largest divisor
  of S that is <= ``segment``; each segment routes on its own;
* capacity ``cap = ceil(seg * k * capacity_factor / E)`` per expert, per
  segment and per batch row (rows never compete, so a request's tokens do
  not depend on its batchmates);
* router logits are the product in the activation dtype, then fp32;
  softmax, top-k (ties go to the lower expert index, as ``lax.top_k``),
  gates renormalised by their sum with a 1e-9 floor;
* priority is k-major (GShard): every token's choice 0 is placed before
  any choice 1; a choice's slot is the running count of its expert over
  the segment plus the count carried from earlier choices, and a choice
  at or past ``cap`` is dropped (its contribution is 0: the token passes
  through the residual);
* the Switch load-balance loss ``E * mean_b sum_e f_e P_e`` per segment,
  averaged over segments.

Where JAX builds (B, seg, E, cap) one-hot tensors and contracts them, the
port moves the kept tokens by index: one copy into the (E, B, cap, d)
expert buffer, the expert products as batched matmuls over E, and one
index-add back, with the gates cast to the activation dtype as JAX's
combine tensor holds them. The kept set, the slots and the dtypes are
JAX's (``routing`` returns them for the tests).

Expert parallelism (``moe_layer(..., tp=)``): JAX shards the expert input
(``moe_expert_in``: E on 'model') and GSPMD turns the combine, which
contracts E, into an all-reduce over 'model'; the tokens are replicated
over 'model', so no token crosses a rank. The port does the same by hand:
the global routing on every rank, the rank's experts (or d_ff columns),
and one sum of the partial combines.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from .layers import gelu_tanh, keep_all, stacked_dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig, stacked: int, dtype,
             device, keep=keep_all, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"router": (stacked, d, E) fp32, "wi": (stacked, E, d, f_e), "wo":
    (stacked, E, f_e, d)} plus "wg" like "wi" for the gated MLP types, each
    expert matrix drawn N(0, 1 / d_in) (the router stays fp32, as in
    JAX)."""
    d, fe, E = cfg.d_model, cfg.expert_d_ff, cfg.moe_experts

    def experts(di, do):
        w = stacked_dense_init(gen, stacked * E, di, do, dtype, device)
        return w.reshape(stacked, E, di, do)

    shapes = [("wi", d, fe), ("wo", fe, d)]
    if cfg.mlp_type in ("swiglu", "geglu"):
        shapes.append(("wg", d, fe))
    p = {"router": keep(prefix + "router", stacked_dense_init(
        gen, stacked, d, E, torch.float32, device))}
    for name, di, do in shapes:
        p[name] = keep(prefix + name, experts(di, do))
    return p


def _capacity(cfg: ModelConfig, seg: int) -> int:
    return max(1, int(math.ceil(seg * cfg.moe_top_k * cfg.capacity_factor
                                / cfg.moe_experts)))


def segment_len(s: int, segment: int) -> int:
    """The largest divisor of s that is <= segment."""
    seg = min(segment, s)
    while s % seg:
        seg -= 1
    return seg


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, ties broken
    by the lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none on CUDA): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One segment's routing. idx, gate, slot, keep: (B, seg, k) — the
    chosen experts, their renormalised gates (fp32), each choice's slot in
    its expert's buffer, and whether it fits the capacity; probs: (B, seg,
    E) fp32."""
    idx: torch.Tensor
    gate: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    probs: torch.Tensor


def route(router: torch.Tensor, xseg: torch.Tensor, cfg: ModelConfig,
          cap: int) -> Routing:
    """Router, top-k and GShard k-major slots for one segment xseg (B, seg,
    d)."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    logits = (xseg @ router.to(xseg.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    count = torch.zeros((xseg.shape[0], 1, E), dtype=torch.int32,
                        device=xseg.device)
    slots = []
    for ki in range(k):
        oh = F.one_hot(idx[..., ki], E).to(torch.int32)        # (B, seg, E)
        pos = torch.cumsum(oh, dim=1) - 1 + count
        slots.append(torch.gather(pos, -1, idx[..., ki:ki + 1])[..., 0])
        count = count + oh.sum(dim=1, keepdim=True)
    slot = torch.stack(slots, dim=-1)
    return Routing(idx, gate, slot, slot < cap, probs)


def routing(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
            segment: int = 2048) -> Routing:
    """The routing of every segment of x (B, S, d), joined along S."""
    b, s, _ = x.shape
    seg = segment_len(s, segment)
    cap = _capacity(cfg, seg)
    parts = [route(p["router"], x[:, i:i + seg], cfg, cap)
             for i in range(0, s, seg)]
    return Routing(*(torch.cat(t, dim=1) for t in zip(*parts)))


def _experts(p: Dict[str, torch.Tensor], xin: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The expert MLPs on xin (E, N, d), as batched matmuls over E."""
    dt = torch.promote_types(xin.dtype, p["wi"].dtype)
    xin = xin.to(dt)
    h = torch.bmm(xin, p["wi"].to(dt))
    if "wg" in p:
        act = F.silu if cfg.mlp_type == "swiglu" else gelu_tanh
        h = act(torch.bmm(xin, p["wg"].to(dt))) * h
    else:
        h = gelu_tanh(h)
    return torch.bmm(h, p["wo"].to(torch.promote_types(h.dtype,
                                                       p["wo"].dtype)))


def _segment(p: Dict[str, torch.Tensor], xseg: torch.Tensor,
             cfg: ModelConfig, cap: int,
             experts: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One segment: (y fp32 (B, seg, d), aux). ``experts`` = (first, n):
    the experts whose stacks ``p`` holds (all E, or a rank's window under
    expert parallelism); choices routed elsewhere are left to their
    ranks, so y is then this rank's part of the combine."""
    b, seg, d = xseg.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    e0, n = experts
    r = route(p["router"], xseg, cfg, cap)
    bi, si, ki = torch.nonzero(r.keep, as_tuple=True)
    e = r.idx[bi, si, ki]
    g = r.gate[bi, si, ki]
    # Switch load-balance loss: E * mean_b sum_e f_e * P_e, f_e the kept
    # share of the segment's seg * k choices (of the global routing)
    f = torch.zeros((b, E), dtype=torch.float32, device=xseg.device)
    f = f.index_put((bi, e), torch.ones_like(g, dtype=torch.float32),
                    accumulate=True) / float(seg * k)
    aux = E * torch.mean(torch.sum(f * r.probs.mean(dim=1), dim=-1))
    if n != E:
        mine = (e >= e0) & (e < e0 + n)
        bi, si, ki, e, g = bi[mine], si[mine], ki[mine], e[mine], g[mine]
    dest = ((e - e0) * b + bi) * cap + r.slot[bi, si, ki]   # (n, B, cap) row
    tok = bi * seg + si
    xin = torch.zeros((n * b * cap, d), dtype=xseg.dtype, device=xseg.device)
    xin = xin.index_copy(0, dest, xseg.reshape(b * seg, d)[tok])
    out = _experts(p, xin.reshape(n, b * cap, d), cfg).reshape(n * b * cap, d)
    # JAX's combine tensor holds the gates in the activation dtype; the
    # products are summed in fp32 and rounded once
    g = g.to(xseg.dtype).to(torch.float32)
    y = torch.zeros((b * seg, d), dtype=torch.float32, device=xseg.device)
    y = y.index_add(0, tok, out[dest].to(torch.float32) * g[:, None])
    return y.reshape(b, seg, d), aux


def moe_layer(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              segment: int = 2048, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss fp32 scalar). p holds one
    layer's slices: router (d, E), wi / wg (E, d, f_e), wo (E, f_e, d).

    ``tp`` (a ``distrib.tp.TPShard``): p holds the rank's expert shards and
    x its residual stream. Every rank routes the same whole sequence (under
    ``seq_parallel`` ``tp.enter`` gathers it: segments and capacity are
    the whole sequence's), so the kept set, the slots and ``lax.top_k``'s
    ties are JAX's on every rank; the rank then runs only its own experts'
    slots (``experts_split``) or every slot on its d_ff columns
    (``expert_ff_split``), and its partial combine (fp32) is summed over
    'model' by ``tp.leave`` (a reduce-scatter under ``seq_parallel``)
    before the one rounding to the activation dtype. The load-balance loss
    comes from the global routing, equal on every rank; its gradient is
    each rank's 1 / tp share, as the router's is (the ranks' gradients of
    the router are summed). Unsplit stacks run whole on every rank."""
    split = tp is not None and tp.moe_split
    if tp is not None:
        x = tp.enter(x, split)
    b, s, d = x.shape
    seg = segment_len(s, segment)
    cap = _capacity(cfg, seg)
    experts = (tp.experts if tp is not None
               else (0, cfg.moe_experts))
    ys, auxs = zip(*(_segment(p, x[:, i:i + seg], cfg, cap, experts)
                     for i in range(0, s, seg)))
    y = torch.cat(ys, dim=1)
    aux = torch.stack(auxs).mean()
    dt = torch.promote_types(torch.promote_types(x.dtype, p["wi"].dtype),
                             p["wo"].dtype)         # the expert products'
    if tp is None:
        return y.to(dt), aux
    if split:
        aux = tp.grad_share(aux)
        return tp.leave(y, True).to(dt), aux
    return tp.leave(y.to(dt), False), aux
