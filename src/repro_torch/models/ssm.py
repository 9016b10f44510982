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
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from .layers import stacked_dense_init


def _conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=torch.float32)


def init_mamba(gen: torch.Generator, cfg: ModelConfig, stacked, dtype,
               device) -> Dict[str, torch.Tensor]:
    """stacked: tuple of leading dims, (L,) or (nsuper, per_super)."""
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    lead = tuple(stacked)
    n = math.prod(lead)

    def w(di_, do_):
        return stacked_dense_init(gen, n, di_, do_, dtype,
                                  device).reshape(lead + (di_, do_))

    p = {"wz": w(d, di), "wx": w(d, di), "wb": w(d, G * N),
         "wc": w(d, G * N), "wdt": w(d, H)}
    p["conv_w"] = stacked_dense_init(
        gen, n, cfg.ssm_conv, _conv_dim(cfg), dtype, device,
        scale=1.0 / math.sqrt(cfg.ssm_conv)).reshape(
            lead + (cfg.ssm_conv, _conv_dim(cfg)))
    p["conv_b"] = torch.zeros(lead + (_conv_dim(cfg),), dtype=dtype,
                              device=device)
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba2)
    u = _uniform(gen, lead + (H,), 0.0, 1.0, device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    p["dt_bias"] = dt0 + torch.log(-torch.expm1(-dt0))
    p["A_log"] = torch.log(_uniform(gen, lead + (H,), 1.0, 16.0, device))
    p["D"] = torch.ones(lead + (H,), dtype=torch.float32, device=device)
    p["gate_norm"] = torch.zeros(lead + (di,), dtype=dtype, device=device)
    p["out_proj"] = {"wo": w(di, d)}
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


def _gated_rms_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                    eps: float) -> torch.Tensor:
    dt = y.dtype
    g = y.to(torch.float32) * F.silu(z.to(torch.float32))
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


def _heads(cfg: ModelConfig, xin, Bc, Cc):
    b, s = xin.shape[:2]
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    rep = H // G
    xh = xin.reshape(b, s, H, P)
    Bh = Bc.reshape(b, s, G, N).repeat_interleave(rep, dim=2)
    Ch = Cc.reshape(b, s, G, N).repeat_interleave(rep, dim=2)
    return xh, Bh, Ch


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def mamba_block(p, u: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Prefill / training path. u: (B, S, d), already normed -> (B, S, d).
    The scan is one ``ops.ssd`` call over the whole batch."""
    b, s, _ = u.shape
    z, xin, Bc, Cc, dt = _project(p, u, cfg)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xh, Bh, Ch = _heads(cfg, *_split_xbc(cfg, xbc))

    loga = (-torch.exp(p["A_log"].to(torch.float32)))[None, None, :] * dt
    xs = xh.to(torch.float32) * dt[..., None]
    y = ops.ssd(xs, loga, Bh.to(torch.float32), Ch.to(torch.float32),
                chunk=cfg.ssd_chunk, use_pallas=cfg.use_pallas)
    y = y + p["D"].to(torch.float32)[None, None, :, None] * \
        xh.to(torch.float32)
    y = y.reshape(b, s, cfg.d_inner).to(u.dtype)
    y = _gated_rms_norm(y, z, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"]["wo"]


# ---------------------------------------------------------------------------
# decode (recurrent, O(1) per token)
# ---------------------------------------------------------------------------

def init_mamba_state(cfg: ModelConfig, batch: int, lead=(),
                     device="cuda") -> Dict[str, torch.Tensor]:
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, _conv_dim(cfg)),
                            dtype=cfg.act_dtype, device=device),
        "ssm": torch.zeros(lead + (batch, H, N, P), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(p, u: torch.Tensor, state: Dict[str, torch.Tensor],
                      cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u: (B, 1, d) -> (y (B, 1, d), new state {"conv", "ssm"})."""
    b = u.shape[0]
    f32 = torch.float32
    z, xin, Bc, Cc, dt = _project(p, u, cfg)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)                      # (B, 1, C)
    hist = torch.cat([state["conv"], xbc], dim=1)              # (B, W, C)
    conv_out = (torch.einsum("bwc,wc->bc", hist.to(f32),
                             p["conv_w"].to(f32))
                + p["conv_b"].to(f32))
    xbc_t = F.silu(conv_out)[:, None, :].to(u.dtype)
    xh, Bh, Ch = _heads(cfg, *_split_xbc(cfg, xbc_t))          # (B, 1, H, .)

    la = (-torch.exp(p["A_log"].to(f32)))[None, :] * dt[:, 0]   # (B, H)
    xt = xh[:, 0].to(f32) * dt[:, 0][..., None]                 # (B, H, P)
    S = (torch.exp(la)[..., None, None] * state["ssm"]
         + Bh[:, 0].to(f32)[..., None] * xt[:, :, None, :])
    yt = torch.einsum("bhn,bhnp->bhp", Ch[:, 0].to(f32), S)
    yt = yt + p["D"].to(f32)[None, :, None] * xh[:, 0].to(f32)
    y = yt.reshape(b, 1, cfg.d_inner).to(u.dtype)
    y = _gated_rms_norm(y, z, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"]["wo"], {"conv": hist[:, 1:, :], "ssm": S}
