"""LipConvnet-n — 1-Lipschitz CNN with GS-SOC / SOC orthogonal convolutions
(port of ``repro/models/lipconvnet.py``).

Architecture (paper §7.3, following Singla & Feizi 2021): 5 blocks of n/5
orthogonal conv layers; the last layer of each block downsamples (invertible
space-to-depth + orthogonal conv + channel selection — semi-orthogonal,
1-Lipschitz) and doubles the channel count. Gradient-preserving MaxMin /
MaxMinPermuted activations; spectral-normalized dense head. The margin
certificate (top1-top2)/sqrt(2) gives provable L2 robustness.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv import (ACTIVATIONS, GSSOCSpec, certified_radius,
                                   gs_soc_layer, init_gs_soc,
                                   power_iteration_sn, soc_layer_spec,
                                   space_to_depth)
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class LipConvnetConfig:
    depth: int = 15                     # n; 5 blocks x n/5 layers
    base_width: int = 32
    num_classes: int = 100
    image_size: int = 32
    in_channels: int = 3
    groups: Tuple[int, int] = (4, 0)    # (a, b) of Table 3; b=0 -> single conv
    activation: str = "maxmin_permuted"
    terms: int = 6
    conv_layer: str = "gs"              # "gs" | "soc"
    paired_shuffle: bool = True

    def __post_init__(self):
        if self.depth % 5:
            raise ValueError("LipConvnet depth must be divisible by 5")

    def layer_spec(self, channels: int) -> GSSOCSpec:
        if self.conv_layer == "soc":
            return soc_layer_spec(channels, self.terms)
        a, b = self.groups
        a = a if channels % a == 0 else 1
        b = b if (b and channels % b == 0) else (0 if not b else 1)
        return GSSOCSpec(channels=channels, groups1=a, groups2=b,
                         terms=self.terms, paired=self.paired_shuffle)

    def block_widths(self):
        w = self.base_width
        return [w * (2 ** i) for i in range(5)]


def init_lipconvnet(cfg: LipConvnetConfig, seed: int = 0,
                    device: DeviceLike = "cuda") -> Dict:
    """fp32 kernels and head from one generator seeded with ``seed``, drawn
    block by block (JAX folds one key per layer: another stream, so tests
    carry JAX's params across)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Dict = {}
    per_block = cfg.depth // 5
    for bi, width in enumerate(cfg.block_widths()):
        block: Dict = {}
        for li in range(per_block - 1):
            block[f"conv{li}"] = init_gs_soc(cfg.layer_spec(width), gen,
                                             device=dev)
        # downsampling layer operates on 4*width channels post space-to-depth
        block["down"] = init_gs_soc(cfg.layer_spec(4 * width), gen,
                                    device=dev)
        params[f"block{bi}"] = block
    flat = head_features(cfg)
    params["head"] = {"w": torch.randn((flat, cfg.num_classes), generator=gen,
                                       device=dev) / math.sqrt(flat)}
    return params


def head_features(cfg: LipConvnetConfig) -> int:
    """Features the head reads: 2x the last block's width per remaining
    pixel (five halvings of the image)."""
    spatial = max(cfg.image_size // (2 ** 5), 1)
    return cfg.block_widths()[-1] * 2 * spatial * spatial


def apply_lipconvnet(cfg: LipConvnetConfig, params: Dict,
                     x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, C_in) -> logits (N, num_classes). 1-Lipschitz end to end."""
    act = ACTIVATIONS[cfg.activation]
    per_block = cfg.depth // 5
    pad = cfg.base_width - x.shape[-1]
    if pad > 0:                  # channel zero-pad (norm-preserving injection)
        x = F.pad(x, (0, pad))
    for bi, width in enumerate(cfg.block_widths()):
        block = params[f"block{bi}"]
        for li in range(per_block - 1):
            x = act(gs_soc_layer(cfg.layer_spec(width), block[f"conv{li}"], x))
        # downsample: orthogonal space-to-depth, orthogonal conv on 4w,
        # then select 2w channels (semi-orthogonal, 1-Lipschitz)
        x = space_to_depth(x, 2)
        x = gs_soc_layer(cfg.layer_spec(4 * width), block["down"], x)
        x = act(x[..., : 2 * width])
    x = x.reshape(x.shape[0], -1)
    w = params["head"]["w"]
    sn = power_iteration_sn(w.detach()) + 1e-6
    return x @ (w / sn)


def count_conv_params(cfg: LipConvnetConfig) -> int:
    per_block = cfg.depth // 5
    total = 0
    for width in cfg.block_widths():
        total += (per_block - 1) * cfg.layer_spec(width).num_params
        total += cfg.layer_spec(4 * width).num_params
    return total


def lipconvnet_loss(cfg: LipConvnetConfig, params: Dict, images: torch.Tensor,
                    labels: torch.Tensor, margin: float = 0.7071):
    """Margin cross-entropy used by SOC-style certified training."""
    logits = apply_lipconvnet(cfg, params, images)
    onehot = F.one_hot(labels.long(), cfg.num_classes).to(logits.dtype)
    adjusted = logits - margin * math.sqrt(2.0) * onehot
    logp = torch.log_softmax(adjusted, dim=-1)
    loss = -torch.mean(torch.sum(onehot * logp, dim=-1))
    correct = torch.argmax(logits, -1) == labels
    acc = correct.to(torch.float32).mean()
    cert = ((certified_radius(logits) > 36.0 / 255.0)
            & correct).to(torch.float32).mean()
    return loss, {"accuracy": acc, "certified": cert}
