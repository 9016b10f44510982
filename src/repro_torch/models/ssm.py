"""Mamba2 (SSD, state-space duality) blocks: the prefill scan and the O(1)
decode step (port of ``repro/models/ssm.py``).

The Mamba2 block (Dao & Gu 2024, arXiv:2405.21060): separate z / x / B / C
/ dt projections, a short causal depthwise conv over (x, B, C), softplus dt
with bias, A = -exp(A_log), the SSD scan (``ops.ssd``: the SSD kernel on
the card, the chunked plain version on the CPU), the per-head skip D, a
gated RMSNorm and the output projection. Decode advances the (H, N, P)
state by one token in plain torch (no kernel, as in the JAX package).

Weights are drawn from a seeded ``torch.Generator`` with the JAX tree's
keys, shapes, dtypes and scales; the values differ from JAX's, so the tests
carry JAX's params across. ``mamba_decode_step`` returns the new state, as
JAX's does; the model's decode writes it into the stacked state in place.

Under tensor parallelism (``tp``, a ``distrib.tp.TPShard`` whose
``mamba_split`` is set) a rank holds its share of the SSD heads: wz / wx /
wdt columns, A_log / D / dt_bias / gate_norm entries and out_proj rows
(row-parallel: its partial output all-reduces); wb / wc and the conv stay
whole, and the rank convolves only its own x channels with B and C. The
gated RMSNorm's mean over d_inner sums the ranks' squares (all-reduce,
both ways under autograd). ``mamba_block`` is the training path too: its
input passes ``tp.enter`` and its output ``tp.leave`` (under sequence
parallelism the sequence is gathered for the scan and reduce-scattered
after ``out_proj``), and the scan runs ``ops.ssd``'s autograd rule.
The decode state holds the rank's heads and conv channels.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from .layers import keep_all, stacked_dense_init


def _conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=torch.float32)


def init_mamba(gen: torch.Generator, cfg: ModelConfig, stacked, dtype,
               device, keep=keep_all,
               prefix: str = "") -> Dict[str, torch.Tensor]:
    """stacked: tuple of leading dims, (L,) or (nsuper, per_super).
    ``keep(path, leaf)`` takes each weight as it is drawn."""
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    lead = tuple(stacked)
    n = math.prod(lead)

    def w(di_, do_):
        return stacked_dense_init(gen, n, di_, do_, dtype,
                                  device).reshape(lead + (di_, do_))

    p = {k: keep(prefix + k, w(d, do))
         for k, do in (("wz", di), ("wx", di), ("wb", G * N),
                       ("wc", G * N), ("wdt", H))}
    p["conv_w"] = stacked_dense_init(
        gen, n, cfg.ssm_conv, _conv_dim(cfg), dtype, device,
        scale=1.0 / math.sqrt(cfg.ssm_conv)).reshape(
            lead + (cfg.ssm_conv, _conv_dim(cfg)))
    p["conv_b"] = torch.zeros(lead + (_conv_dim(cfg),), dtype=dtype,
                              device=device)
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba2)
    u = _uniform(gen, lead + (H,), 0.0, 1.0, device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    p["dt_bias"] = keep(prefix + "dt_bias",
                        dt0 + torch.log(-torch.expm1(-dt0)))
    p["A_log"] = keep(prefix + "A_log", torch.log(
        _uniform(gen, lead + (H,), 1.0, 16.0, device)))
    p["D"] = keep(prefix + "D", torch.ones(lead + (H,), dtype=torch.float32,
                                           device=device))
    p["gate_norm"] = keep(prefix + "gate_norm", torch.zeros(
        lead + (di,), dtype=dtype, device=device))
    p["out_proj"] = {"wo": keep(prefix + "out_proj/wo", w(di, d))}
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width W (shift and sum). x: (B, S, C);
    w: (W, C); b: (C,)."""
    W = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :].to(x.dtype)
    return y + b[None, None, :].to(x.dtype)


def _split(tp) -> bool:
    return tp is not None and tp.mamba_split


def _gated_rms_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                    eps: float, tp=None) -> torch.Tensor:
    dt = y.dtype
    g = y.to(torch.float32) * F.silu(z.to(torch.float32))
    if _split(tp):      # the mean over every rank's channels
        var = tp.all_reduce_split(torch.sum(g * g, dim=-1, keepdim=True)) / (
            g.shape[-1] * tp.size)
    else:
        var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + eps)
    return (g * (1.0 + scale.to(torch.float32))).to(dt)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as ``jax.nn.softplus`` (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(p, u: torch.Tensor, cfg: ModelConfig):
    """The pre-SSD projections: z, x, B, C (u's dtype) and dt (fp32)."""
    z = u @ p["wz"]
    xin = u @ p["wx"]
    Bc = u @ p["wb"]
    Cc = u @ p["wc"]
    dt = _softplus((u @ p["wdt"]).to(torch.float32)
                   + p["dt_bias"][None, None, :])
    return z, xin, Bc, Cc, dt


def _heads(cfg: ModelConfig, xin, Bc, Cc, tp=None):
    b, s = xin.shape[:2]
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    rep = H // G
    xh = xin.reshape(b, s, -1, P)
    Bg, Cg = Bc.reshape(b, s, G, N), Cc.reshape(b, s, G, N)
    if _split(tp):      # the group of each of the rank's heads
        hl = xh.shape[2]
        grp = (tp.rank * hl + torch.arange(hl, device=xin.device)) // rep
        return xh, Bg.index_select(2, grp), Cg.index_select(2, grp)
    return (xh, Bg.repeat_interleave(rep, dim=2),
            Cg.repeat_interleave(rep, dim=2))


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    gn = cfg.ssm_groups * cfg.ssm_state
    di = xbc.shape[-1] - 2 * gn
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def _conv_params(p, cfg: ModelConfig, tp):
    """The conv's weights and bias over the rank's channels: its window of
    x, then all of B and C (depthwise: channels are independent)."""
    if not _split(tp):
        return p["conv_w"], p["conv_b"]
    dl = cfg.d_inner // tp.size
    dev = p["conv_w"].device
    idx = torch.cat([tp.rank * dl + torch.arange(dl, device=dev),
                     torch.arange(cfg.d_inner, _conv_dim(cfg), device=dev)])
    return p["conv_w"].index_select(-1, idx), p["conv_b"].index_select(-1, idx)


def _out_proj(p, y: torch.Tensor, tp) -> torch.Tensor:
    out = y @ p["out_proj"]["wo"]
    return out if tp is None else tp.leave(out, _split(tp))


def mamba_block(p, u: torch.Tensor, cfg: ModelConfig,
                tp=None) -> torch.Tensor:
    """Prefill / training path. u: (B, S, d), already normed -> (B, S, d).
    The scan is one ``ops.ssd`` call over the whole batch (the rank's
    heads under ``tp``)."""
    if tp is not None:
        u = tp.enter(u, _split(tp))
    b, s, _ = u.shape
    z, xin, Bc, Cc, dt = _project(p, u, cfg)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)
    xbc = F.silu(_causal_conv(xbc, *_conv_params(p, cfg, tp)))
    xh, Bh, Ch = _heads(cfg, *_split_xbc(cfg, xbc), tp)

    loga = (-torch.exp(p["A_log"].to(torch.float32)))[None, None, :] * dt
    xs = xh.to(torch.float32) * dt[..., None]
    y = ops.ssd(xs, loga, Bh.to(torch.float32), Ch.to(torch.float32),
                chunk=cfg.ssd_chunk, use_pallas=cfg.use_pallas)
    y = y + p["D"].to(torch.float32)[None, None, :, None] * \
        xh.to(torch.float32)
    y = y.reshape(b, s, -1).to(u.dtype)
    y = _gated_rms_norm(y, z, p["gate_norm"], cfg.norm_eps, tp)
    return _out_proj(p, y, tp)


# ---------------------------------------------------------------------------
# decode (recurrent, O(1) per token)
# ---------------------------------------------------------------------------

def init_mamba_state(cfg: ModelConfig, batch: int, lead=(),
                     device="cuda", tp=None) -> Dict[str, torch.Tensor]:
    """The rank's heads and conv channels under a split ``tp``."""
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    C = _conv_dim(cfg)
    if _split(tp):
        H, C = H // tp.size, C - cfg.d_inner + cfg.d_inner // tp.size
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, C),
                            dtype=cfg.act_dtype, device=device),
        "ssm": torch.zeros(lead + (batch, H, N, P), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(p, u: torch.Tensor, state: Dict[str, torch.Tensor],
                      cfg: ModelConfig, tp=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u: (B, 1, d) -> (y (B, 1, d), new state {"conv", "ssm"})."""
    b = u.shape[0]
    f32 = torch.float32
    z, xin, Bc, Cc, dt = _project(p, u, cfg)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)                      # (B, 1, C)
    hist = torch.cat([state["conv"], xbc], dim=1)              # (B, W, C)
    conv_w, conv_b = _conv_params(p, cfg, tp)
    conv_out = (torch.einsum("bwc,wc->bc", hist.to(f32), conv_w.to(f32))
                + conv_b.to(f32))
    xbc_t = F.silu(conv_out)[:, None, :].to(u.dtype)
    xh, Bh, Ch = _heads(cfg, *_split_xbc(cfg, xbc_t), tp)      # (B, 1, H, .)

    la = (-torch.exp(p["A_log"].to(f32)))[None, :] * dt[:, 0]   # (B, H)
    xt = xh[:, 0].to(f32) * dt[:, 0][..., None]                 # (B, H, P)
    S = (torch.exp(la)[..., None, None] * state["ssm"]
         + Bh[:, 0].to(f32)[..., None] * xt[:, :, None, :])
    yt = torch.einsum("bhn,bhnp->bhp", Ch[:, 0].to(f32), S)
    yt = yt + p["D"].to(f32)[None, :, None] * xh[:, 0].to(f32)
    y = yt.reshape(b, 1, -1).to(u.dtype)
    y = _gated_rms_norm(y, z, p["gate_norm"], cfg.norm_eps, tp)
    return _out_proj(p, y, tp), {"conv": hist[:, 1:, :], "ssm": S}
