"""Serve step builders (the serving half of ``repro/train/steps.py``; the
name is kept so the counterpart is easy to find). PyTorch runs eagerly, so
each builder returns a plain closure; the JAX package jits the same bodies.
Greedy sampling is ``argmax`` (first index on ties, as ``jnp.argmax``).
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import peft as peft_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api


def build_decode_step(cfg: ModelConfig):
    """step(params, ctx, tokens (B, 1), state, pos) -> (next_tok (B, 1),
    logits, state). ``pos`` is a scalar or (B,) per-slot positions; ``ctx``
    an optional AdapterContext (None serves the bare/merged model)."""
    fam = api.family_ops(cfg)

    @torch.inference_mode()
    def serve_step(params, ctx, tokens, state, pos):
        logits, state = fam.decode_step(cfg, params, tokens, state, pos,
                                        ctx=ctx)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok[:, None], logits, state

    return serve_step


def build_prefill_step(cfg: ModelConfig):
    """step(params, req: PrefillRequest, state) -> (logits, state)."""
    fam = api.family_ops(cfg)

    @torch.inference_mode()
    def prefill_step(params, req: peft_lib.PrefillRequest, state):
        return fam.prefill(cfg, params, req, state)

    return prefill_step


def build_slot_prefill_step(cfg: ModelConfig, *, max_len: int,
                            device: DeviceLike = "cuda"):
    """Continuous-batching admission: prefill ONE request (batch 1) into a
    fresh state and copy it into row ``slot`` of the engine's slot-array
    state. step(params, req, state, slot) -> (first_token int, state).

    The decoder state's leaves are {"kv": {"k", "v": (L, B, S, K, D)}}, so
    the slot (batch) axis is axis 1 of every leaf."""
    fam = api.family_ops(cfg)
    dev = resolve_device(device)

    @torch.inference_mode()
    def slot_prefill(params, req: peft_lib.PrefillRequest, state, slot: int):
        sub = fam.init_decode_state(cfg, 1, max_len, dev)
        logits, sub = fam.prefill(cfg, params, req, sub)
        first = int(torch.argmax(logits[0, -1]))
        for key, leaf in sub["kv"].items():
            state["kv"][key][:, slot] = leaf[:, 0].to(state["kv"][key].dtype)
        return first, state

    return slot_prefill
