"""Bidirectional encoder classifier, RoBERTa-style (port of
``repro/models/encoder.py``): the paper's GLUE fine-tuning setting (Table
1). A frozen backbone and a classification head, adapted with GSOFT / OFT /
BOFT / LoRA through the same PEFT engine as the language models
(``core.peft.materialize_tree``: on the card the GS and bdmm kernels).

As in JAX, the layers are the decoder's (RMSNorm, RoPE, the tanh GELU
MLP) run without the causal mask, and the logits are read at position 0
(CLS pooling), so ``encoder_config`` at RoBERTa-base's widths is a
RoBERTa-shaped proxy, not RoBERTa.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from .attention import attention_block, init_attention
from .layers import (apply_mlp, embed_init, init_stacked_mlp, rms_norm,
                     seeded_generator, stacked_dense_init)
from .transformer import _unbind


def encoder_config(name="roberta-proxy", num_layers=2, d_model=64,
                   num_heads=4, d_ff=128, vocab_size=128,
                   num_classes=2) -> ModelConfig:
    """The classifier's backbone config, f32 (JAX's arguments and
    defaults; ``num_classes`` is ``init_encoder_classifier``'s, as there)."""
    del num_classes
    return ModelConfig(
        name=name, family="decoder",          # reuses decoder layer params
        num_layers=num_layers, d_model=d_model, num_heads=num_heads,
        num_kv_heads=num_heads, head_dim=d_model // num_heads, d_ff=d_ff,
        vocab_size=vocab_size, mlp_type="gelu", rope_theta=1e4,
        dtype="f32", param_dtype="f32", remat="none", attn_chunk=64,
    )


def init_encoder_classifier(cfg: ModelConfig, num_classes: int,
                            seed: int = 0,
                            device: DeviceLike = "cuda") -> Dict:
    """fp32 weights from a seeded torch.Generator on ``device`` (JAX's
    tree: "embed", "layers" {attn_norm, attn, mlp_norm, mlp}, "final_norm",
    "head" {"w" (d, C), "b" (C,)}); the embedding is not vocab-padded."""
    dev = resolve_device(device)
    gen = seeded_generator(seed, dev)
    L, d, f32 = cfg.num_layers, cfg.d_model, torch.float32
    zeros = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)
    return {
        "embed": {"table": embed_init(gen, cfg.vocab_size, d, f32, dev)},
        "layers": {
            "attn_norm": zeros(L, d),
            "attn": init_attention(gen, cfg, L, dev, dtype=f32),
            "mlp_norm": zeros(L, d),
            "mlp": init_stacked_mlp(gen, L, d, cfg.d_ff, cfg.mlp_type, f32,
                                    dev),
        },
        "final_norm": zeros(d),
        "head": {"w": stacked_dense_init(gen, 1, d, num_classes, f32, dev)[0],
                 "b": zeros(num_classes)},
    }


def encoder_forward(cfg: ModelConfig, params,
                    tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> class logits (B, C): every layer's attention reads
    the whole sequence; the head reads position 0."""
    h = params["embed"]["table"][tokens]
    for lp in _unbind(params["layers"], cfg.num_layers):
        a, _ = attention_block(lp["attn"],
                               rms_norm(h, lp["attn_norm"], cfg.norm_eps),
                               cfg, causal=False)
        h = h + a
        h = h + apply_mlp(lp["mlp"], rms_norm(h, lp["mlp_norm"],
                                              cfg.norm_eps), cfg.mlp_type)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h[:, 0] @ params["head"]["w"] + params["head"]["b"]


def classifier_loss(cfg: ModelConfig, params, batch):
    """Mean cross entropy of batch["labels"] (B,) and the accuracy:
    (loss, {"loss", "accuracy"})."""
    logits = encoder_forward(cfg, params, batch["tokens"])
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"].long()
    loss = -logp.gather(-1, labels[:, None])[:, 0].mean()
    acc = (torch.argmax(logits, -1) == labels).to(torch.float32).mean()
    return loss, {"loss": loss, "accuracy": acc}
