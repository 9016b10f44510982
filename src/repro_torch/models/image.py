"""``image`` family — the 1-Lipschitz GS-SOC LipConvnet as a registered,
servable ``FamilyOps`` entry (port of ``repro/models/image.py``).

The family is STATELESS: a request is one image and the whole decode surface
is ``None``; inference goes through ``FamilyOps.infer`` (one batched
forward), which ``ImageServeEngine`` drives.

Adapter attachment points: every orthogonal conv layer carries an explicit
identity-initialized ``(c, c)`` channel-mix weight ``wc`` applied as a 1x1
matmul over flattened ``(N, H*W, C)`` activations, routed through the same
``qlinear`` hook as every transformer projection:

* merged serving — ``materialize`` folds an orthogonal adapter ``Q`` into
  ``wc`` (the forward GS kernel on the card for GSOFT);
* banked serving — activation-side ``x·Q`` per request through the bank
  read by slot id (GSOFT: ``gs_fused_T_bank``; OFT / BOFT: ``bdmm``;
  Householder / Givens in plain torch, as in JAX);
* int8 — ``wc`` quantizes per output channel (the identity exactly) and
  runs ``q_matmul``; a GSOFT tenant's rotation fuses with it in
  ``gs_q_matmul_bank``;
* certification — orthogonal ``Q`` keeps every layer an isometry.

Activations stay NHWC-contiguous, so the flatten before ``wc`` is a view
and the GS and int8 wrappers get contiguous ``(B, T, d)`` rows. The params
are fp32 whatever ``param_dtype`` says (as JAX's ``init_image`` leaves
them); the forward casts each conv kernel and ``wc`` to the activations'
dtype.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.conv import (ACTIVATIONS, certified_radius, gs_soc_layer,
                                   power_iteration_sn, space_to_depth)
from repro_torch.core.peft import AdapterContext
from repro_torch.device import DeviceLike
from . import registry
from .layers import qlinear
from .lipconvnet import LipConvnetConfig, init_lipconvnet

# margin used by SOC-style certified training; 36/255 is the CIFAR
# certification radius the paper's Table 3 reports at
CERT_EPS = 36.0 / 255.0


def lip_cfg(cfg: ModelConfig) -> LipConvnetConfig:
    """ModelConfig -> the LipConvnet hyperparameter record."""
    return LipConvnetConfig(
        depth=cfg.num_layers,
        base_width=cfg.base_width or cfg.d_model,
        num_classes=cfg.num_classes,
        image_size=cfg.image_size,
        in_channels=cfg.in_channels,
        groups=tuple(cfg.conv_groups),
        activation=cfg.conv_activation,
        terms=cfg.conv_terms,
        conv_layer="soc" if cfg.conv_layer == "soc" else "gs",
        paired_shuffle=cfg.paired_shuffle,
    )


def init_image(cfg: ModelConfig, seed: int = 0,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """LipConvnet params + identity ``wc`` channel-mix at every conv layer
    (the adapter / quantization attachment points)."""
    lc = lip_cfg(cfg)
    params = init_lipconvnet(lc, seed, device)
    dev = params["head"]["w"].device
    per_block = lc.depth // 5
    for bi, width in enumerate(lc.block_widths()):
        block = params[f"block{bi}"]
        for li in range(per_block - 1):
            block[f"conv{li}"]["wc"] = torch.eye(width, device=dev)
        block["down"]["wc"] = torch.eye(2 * width, device=dev)
    return params


def _channel_mix(x: torch.Tensor, w, rot, name: str) -> torch.Tensor:
    """The 1x1 channel-mix hook: flatten NHWC -> (N, H*W, C) so the banked
    rotation (``(B, T, d)`` contract) and the quantized matmul ride the
    same machinery as every transformer projection, then restore NHWC."""
    n, h, wd, c = x.shape
    y = qlinear(x.reshape(n, h * wd, c), w, rot, name, cast=True)
    return y.reshape(n, h, wd, c)


def _cast_conv(lp: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    return {k: lp[k].to(dtype) for k in ("m1", "m2") if k in lp}


def apply_image(cfg: ModelConfig, params: Dict[str, Any], images: torch.Tensor,
                ctx: Optional[AdapterContext] = None) -> torch.Tensor:
    """images (N, H, W, C_in) -> logits (N, num_classes); 1-Lipschitz end
    to end (orthogonal convs, isometric activations, orthogonal ``wc``
    rotations, spectral-normalized head).

    ``ctx`` is the same per-request ``AdapterContext`` the decode path
    takes: row i of the batch rotates its channel stream with adapter
    ``ctx.slots[i]`` before each ``wc`` matmul (slot 0 = identity)."""
    lc = lip_cfg(cfg)
    act = ACTIVATIONS[lc.activation]
    per_block = lc.depth // 5
    x = images.to(cfg.act_dtype)
    pad = lc.base_width - x.shape[-1]
    if pad > 0:                       # norm-preserving channel injection
        x = F.pad(x, (0, pad))
    for bi, width in enumerate(lc.block_widths()):
        block = params[f"block{bi}"]
        if ctx is not None:
            def grp(n, bi=bi):
                return ctx.rotator(ctx.group(f"block{bi}", n))
        else:
            def grp(n):
                return None
        spec = lc.layer_spec(width)
        for li in range(per_block - 1):
            name = f"conv{li}"
            x = gs_soc_layer(spec, _cast_conv(block[name], x.dtype), x)
            x = _channel_mix(x, block[name]["wc"], grp(name), "wc")
            x = act(x)
        # downsample: orthogonal space-to-depth, orthogonal conv on 4w,
        # select 2w channels (semi-orthogonal), then the 2w channel mix
        x = space_to_depth(x, 2)
        spec_dn = lc.layer_spec(4 * width)
        x = gs_soc_layer(spec_dn, _cast_conv(block["down"], x.dtype), x)
        x = act(x[..., : 2 * width])
        x = _channel_mix(x, block["down"]["wc"], grp("down"), "wc")
    x = x.reshape(x.shape[0], -1)
    w = params["head"]["w"].to(torch.float32)
    sn = power_iteration_sn(w.detach()) + 1e-6
    return x @ (w / sn).to(x.dtype)


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FamilyOps.forward: batch["images"] -> (logits, aux=0)."""
    logits = apply_image(cfg, params, batch["images"])
    return logits, torch.zeros((), device=logits.device)


def infer(cfg: ModelConfig, params, images: torch.Tensor,
          ctx: Optional[AdapterContext] = None) -> torch.Tensor:
    """FamilyOps.infer — the stateless serving entry point."""
    return apply_image(cfg, params, images, ctx=ctx)


def image_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
               margin: float = 0.7071):
    """Margin cross-entropy of SOC-style certified training, plus the
    certified-accuracy metric at radius ``CERT_EPS``."""
    logits = apply_image(cfg, params, batch["images"])
    labels = batch["labels"].long()
    onehot = F.one_hot(labels, cfg.num_classes).to(logits.dtype)
    adjusted = logits - margin * math.sqrt(2.0) * onehot
    logp = torch.log_softmax(adjusted.to(torch.float32), dim=-1)
    loss = -torch.mean(torch.sum(onehot.to(torch.float32) * logp, dim=-1))
    correct = torch.argmax(logits, -1) == labels
    acc = correct.to(torch.float32).mean()
    cert = ((certified_radius(logits) > CERT_EPS)
            & correct).to(torch.float32).mean()
    return loss, {"loss": loss, "accuracy": acc, "certified": cert}


registry.register(registry.FamilyOps(
    family="image",
    init_params=init_image,
    forward=forward,
    loss=image_loss,
    infer=infer,
    mixer="none",
))
