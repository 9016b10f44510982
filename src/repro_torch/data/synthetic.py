"""Deterministic synthetic batches (port of ``repro/data/synthetic.py``):
shape-correct inputs for every ported family when no corpus is mounted.

Token streams have a learnable structure (Zipf marginals + a deterministic
bigram with noise resets), images are class templates plus noise; the vlm
adds standard-normal patch embeddings and the encoder-decoder frame
embeddings, the stubbed frontends' outputs (``frontend_shape``). Every
draw comes from an explicit ``torch.Generator`` seeded with ``seed`` on the
target device, so these streams differ from the JAX package's PRNG by
design (as LoRA's initial draws do); tests carry JAX's inputs across as
numpy instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def text_len(cfg: ModelConfig, seq: int) -> int:
    """Text tokens of a ``seq``-position row: the vlm's patches take
    ``frontend_tokens`` of them (at least 8 stay text), as in JAX."""
    if api.family_ops(cfg).has_patches:
        return max(seq - cfg.frontend_tokens, 8)
    return seq


def frontend_shape(cfg: ModelConfig, seq: int
                   ) -> Optional[Tuple[str, Tuple[int, int]]]:
    """The stubbed frontend's input to one row of ``seq`` text tokens, as
    (key, row shape): the vlm's "patches" (frontend_tokens, frontend_dim),
    the encoder-decoder's "frames" (max(seq // 4, 8), d_model), as in JAX;
    None for the other families. ``lm_batch`` and ``LMDataSource`` both
    read it."""
    t = api.family_ops(cfg)
    if t.has_patches:
        return "patches", (cfg.frontend_tokens, cfg.frontend_dim)
    if t.has_encoder:
        return "frames", (max(seq // 4, 8), cfg.d_model)
    return None


def lm_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
             device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """{"tokens", "labels", "mask"} of a token family (labels[:, t] is the
    next token of tokens[:, t]), with the standard-normal "patches" (vlm:
    ``text_len`` text tokens after them) or "frames" (encdec) of
    ``frontend_shape``, in the activation dtype."""
    dev = resolve_device(device)
    s = text_len(cfg, seq)
    gen = _generator(seed, dev)
    toks = _token_stream(gen, batch, s + 1, cfg.vocab_size, dev)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
           "mask": torch.ones((batch, s), dtype=torch.float32, device=dev)}
    front = frontend_shape(cfg, s)
    if front is not None:
        key, shape = front
        x = torch.randn((batch,) + shape, generator=gen, device=dev,
                        dtype=torch.float32)
        out[key] = x.to(cfg.act_dtype)
    return out


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
