"""Deterministic synthetic batches (port of ``repro/data/synthetic.py``):
shape-correct inputs for the ported families when no corpus is mounted.

Token streams have a learnable structure (Zipf marginals + a deterministic
bigram with noise resets), images are class templates plus noise. Every
draw comes from an explicit ``torch.Generator`` seeded with ``seed`` on the
target device, so these streams differ from the JAX package's PRNG by
design (as LoRA's initial draws do); tests carry JAX's inputs across as
numpy instead.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api

# the seed of the class templates: every image_batch draw of one config
# samples the SAME class manifold, whatever its own seed
TEMPLATE_SEED = 17


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _token_stream(gen: torch.Generator, batch: int, seq: int, vocab: int,
                  device: torch.device) -> torch.Tensor:
    """Learnable synthetic tokens: Zipf marginals + deterministic bigram."""
    probs = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float32,
                               device=device)
    probs = probs / probs.sum()
    first = torch.multinomial(probs.expand(batch, vocab), 1, replacement=True,
                              generator=gen)[:, 0]                   # (B,)
    noise = torch.multinomial(probs, batch * seq, replacement=True,
                              generator=gen).reshape(batch, seq)
    toks = torch.empty((batch, seq), dtype=torch.int64, device=device)
    prev = first
    for t in range(seq):
        # deterministic bigram with occasional noise resets
        n = noise[:, t]
        prev = torch.where(n % 7 == 0, n, (prev * 31 + 7) % vocab)
        toks[:, t] = prev
    return toks


def lm_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
             device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """{"tokens", "labels", "mask"} of a token family: labels[:, t] is the
    next token of tokens[:, t]."""
    t = api.family_ops(cfg)
    if t.has_patches or t.has_encoder:
        raise NotImplementedError(
            f"family {cfg.family!r} needs patches / frames, which no ported "
            "family has yet")
    dev = resolve_device(device)
    toks = _token_stream(_generator(seed, dev), batch, seq + 1,
                         cfg.vocab_size, dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((batch, seq), dtype=torch.float32, device=dev)}


def image_batch(cfg: ModelConfig, batch: int, seed: int = 0,
                device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Learnable synthetic images for the stateless image family: each
    class c gets a fixed random template; a sample is its class template
    plus noise, so a 1-Lipschitz classifier can separate the classes while
    inputs stay O(1)-normalized (certified radii are meaningful)."""
    dev = resolve_device(device)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    templates = torch.randn((cfg.num_classes,) + shape,
                            generator=_generator(TEMPLATE_SEED, dev),
                            device=dev)
    gen = _generator(seed, dev)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device=dev)
    noise = torch.randn((batch,) + shape, generator=gen, device=dev)
    return {"images": templates[labels] + 0.5 * noise, "labels": labels}
