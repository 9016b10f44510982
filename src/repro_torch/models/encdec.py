"""Encoder-decoder transformer, the seamless-m4t backbone (port of
``repro/models/encdec.py``).

The speech frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings ``frames`` (B, F, d_model). The bidirectional
encoder (``enc_layers`` layers) turns them into ``enc_out``; each decoder
layer runs causal self-attention with a KV cache, cross-attention over
``enc_out`` and the MLP. Weights stay stacked per layer as in the JAX tree:
{"encoder": {attn_norm, attn, mlp_norm, mlp}, "decoder": {attn_norm, attn,
cross_norm, cross, mlp_norm, mlp}} with a leading layer dim, plus "embed",
"lm_head", "enc_norm" and "final_norm". Attention stays plain torch, as
JAX's ``online_attention`` is plain ``jnp``; the adapted projections take
the GS kernels through ``core.peft.materialize_tree`` in training and in the
offline merge.

The decode state is {"kv": {"k", "v": (L, B, S, K, D)}, "enc_out": (B, F,
d_model)}. ``prefill`` encodes the frames, writes the KV cache in place and
returns the state with the new ``enc_out``; ``decode_step`` attends over
that ``enc_out`` again at every step. The cross-attention K / V are
recomputed from it each step, as the JAX code does (its docstring says they
are cached; its code does not cache them). The family serves no adapter
bank: a ``ctx`` raises ValueError, as in JAX; merged adapters serve.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.peft import AdapterContext, PrefillRequest
from repro_torch.device import DeviceLike, resolve_device
from . import registry
from .attention import attention_block, init_attention, init_cache
from .layers import (apply_mlp, cross_entropy, embed_init, init_stacked_mlp,
                     keep_all, qlinear, rms_norm, seeded_generator, softcap,
                     stacked_dense_init)
from .transformer import _gather_last, _remat, _slice, _unbind


def _no_bank(ctx: Optional[AdapterContext]) -> None:
    if ctx is not None:
        raise ValueError("adapter bank serving not supported for encdec")


def init_encdec(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = "cuda", keep=keep_all) -> Dict[str, Any]:
    """Random weights drawn on ``device`` from a seeded torch.Generator
    (the JAX tree's keys, shapes and scales)."""
    dev = resolve_device(device)
    gen = seeded_generator(seed, dev)
    wd = cfg.weight_dtype
    vp = cfg.padded_vocab()
    d = cfg.d_model
    zeros = lambda *shape: torch.zeros(shape, dtype=wd, device=dev)

    def stack(n: int, prefix: str, cross: bool) -> Dict[str, Any]:
        out = {"attn_norm": zeros(n, d),
               "attn": init_attention(gen, cfg, n, dev, keep=keep,
                                      prefix=f"{prefix}/attn/")}
        if cross:
            out["cross_norm"] = zeros(n, d)
            out["cross"] = init_attention(gen, cfg, n, dev, keep=keep,
                                          prefix=f"{prefix}/cross/")
        out["mlp_norm"] = zeros(n, d)
        out["mlp"] = init_stacked_mlp(gen, n, d, cfg.d_ff, cfg.mlp_type, wd,
                                      dev, keep=keep, prefix=f"{prefix}/mlp/")
        return out

    return {
        "encoder": stack(cfg.enc_layers, "encoder", cross=False),
        "decoder": stack(cfg.num_layers, "decoder", cross=True),
        "embed": {"table": keep("embed/table", embed_init(gen, vp, d, wd,
                                                          dev))},
        "lm_head": {"w": keep("lm_head/w", stacked_dense_init(
            gen, 1, d, vp, wd, dev)[0])},
        "enc_norm": zeros(d),
        "final_norm": zeros(d),
    }


def _encoder_layer(cfg: ModelConfig, lp, h: torch.Tensor) -> torch.Tensor:
    a, _ = attention_block(lp["attn"], rms_norm(h, lp["attn_norm"],
                                                cfg.norm_eps),
                           cfg, causal=False)
    h = h + a
    return h + apply_mlp(lp["mlp"], rms_norm(h, lp["mlp_norm"], cfg.norm_eps),
                         cfg.mlp_type)


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d_model), the stub's embeddings -> the encoder output
    (B, F, d_model), after ``enc_norm``."""
    h = frames.to(cfg.act_dtype)
    layer = _remat(cfg, lambda lp, hc: _encoder_layer(cfg, lp, hc))
    for lp in _unbind(params["encoder"], cfg.enc_layers):
        h = layer(lp, h)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _decoder_layer(cfg: ModelConfig, lp, h: torch.Tensor,
                   enc_out: torch.Tensor, cache=None,
                   cache_pos=None) -> torch.Tensor:
    """Causal self-attention (its KV cache, when given, written in place),
    cross-attention over ``enc_out``, then the MLP."""
    a, _ = attention_block(lp["attn"], rms_norm(h, lp["attn_norm"],
                                                cfg.norm_eps),
                           cfg, cache=cache, cache_pos=cache_pos, causal=True)
    h = h + a
    c, _ = attention_block(lp["cross"], rms_norm(h, lp["cross_norm"],
                                                 cfg.norm_eps),
                           cfg, kv_x=enc_out, causal=False)
    h = h + c
    return h + apply_mlp(lp["mlp"], rms_norm(h, lp["mlp_norm"], cfg.norm_eps),
                         cfg.mlp_type)


def _decoder_pass(cfg: ModelConfig, params, h: torch.Tensor,
                  enc_out: torch.Tensor, kv=None,
                  cache_pos=None) -> torch.Tensor:
    """Every decoder layer; without a cache (training, scoring) each layer
    runs under ``cfg.remat``."""
    if kv is None:
        layer = _remat(cfg, lambda lp, hc, e: _decoder_layer(cfg, lp, hc, e))
        for lp in _unbind(params["decoder"], cfg.num_layers):
            h = layer(lp, h, enc_out)
        return h
    for i in range(cfg.num_layers):
        h = _decoder_layer(cfg, _slice(params["decoder"], i), h, enc_out,
                           _slice(kv, i), cache_pos)
    return h


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"][tokens].to(cfg.act_dtype)


def _unembed(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return softcap(qlinear(h, params["lm_head"]["w"], cast=True),
                   cfg.logit_softcap)


def forward(cfg: ModelConfig, params,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """-> (logits (B, S, Vp), 0). batch: "frames" (B, F, d_model) and
    "tokens" (B, S)."""
    enc_out = encode(cfg, params, batch["frames"])
    h = _decoder_pass(cfg, params, _embed(cfg, params, batch["tokens"]),
                      enc_out)
    return (_unembed(cfg, params, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def lm_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """batch["labels"][:, t] is the target of logits position t, with
    batch["mask"] zeroing padded slots. Returns (loss, {"loss",
    "accuracy", "moe_aux"})."""
    logits, aux = forward(cfg, params, batch)
    loss, acc = cross_entropy(logits, batch["labels"], batch.get("mask"),
                              cfg.vocab_size)
    return loss, {"loss": loss, "accuracy": acc, "moe_aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = "cuda", enc_len: int = 0):
    """{"kv": {"k", "v": (L, B, max_len, K, D)}, "enc_out": (B, enc_len,
    d_model)}, zeros."""
    dev = resolve_device(device)
    c = init_cache(cfg, batch, max_len, dev)
    return {"kv": {k: v[None].repeat((cfg.num_layers,) + (1,) * v.dim())
                   for k, v in c.items()},
            "enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                                   dtype=cfg.act_dtype, device=dev)}


def prefill(cfg: ModelConfig, params, req: PrefillRequest, state):
    """Encode ``req.batch["frames"]``, run the decoder over the prompt
    writing the KV cache in place, and gather each row's logits at
    ``req.last_idx``. Returns (logits, {"kv": the state's cache, "enc_out":
    the new encoder output})."""
    _no_bank(req.ctx)
    enc_out = encode(cfg, params, req.batch["frames"])
    h = _decoder_pass(cfg, params, _embed(cfg, params, req.batch["tokens"]),
                      enc_out, kv=state["kv"])
    logits = _unembed(cfg, params, _gather_last(h, req.last_idx))
    return logits, {"kv": state["kv"], "enc_out": enc_out}


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, state, pos,
                ctx: Optional[AdapterContext] = None):
    """One token for the whole batch (tokens (B, 1), pos a scalar or (B,)
    write positions) over the state's ``enc_out``; the KV cache is written
    in place. Returns (logits (B, 1, Vp), state)."""
    _no_bank(ctx)
    h = _decoder_pass(cfg, params, _embed(cfg, params, tokens),
                      state["enc_out"], kv=state["kv"], cache_pos=pos)
    return _unembed(cfg, params, h), state


registry.register(registry.FamilyOps(
    family="encdec",
    init_params=init_encdec,
    forward=forward,
    loss=lm_loss,
    init_decode_state=init_decode_state,
    prefill=prefill,
    decode_step=decode_step,
    has_encoder=True,
))
