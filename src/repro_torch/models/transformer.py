"""Language models (port of the decoder (dense and MoE), ``ssm``,
``hybrid`` and ``vlm`` families of ``repro/models/transformer.py``):
``init_lm``, ``forward``, ``lm_loss``, ``init_decode_state``,
``decode_step``, ``prefill``, and the decoder's paged serve path
``init_paged_state``, ``paged_decode_step``, ``paged_chunk_prefill``.
Structural branches read the registry record's ``mixer`` and
``has_patches`` traits, never the family string.

``vlm`` (pixtral) is the decoder with a patch frontend stub: the batch
carries precomputed patch embeddings "patches" (B, P, frontend_dim), which
``patch_proj/wi`` projects to d_model and prepends to the text stream.
``forward`` returns the text positions' logits only; ``prefill`` rotates
the patches per request through the bank's "patch_proj" group, and
callers count the P patch positions in ``last_idx`` and in the decode
positions; decode is the decoder's. No paged surface, as in JAX.

``ssm`` (mamba2) stacks Mamba2 layers {"norm", "mamba"} (L, ...);
``hybrid`` (zamba2) stacks them (nsuper, per, ...) with one shared-weight
attention + MLP block applied after each super-block (weights shared, one
KV cache per application). Their decode state is {"mamba": {"conv", "ssm"}}
(+ the hybrid's {"kv": (nsuper, B, S, K, D)}), updated in place. As in the
JAX package, their ``prefill`` runs ``forward`` for the logits and returns
the decode state unchanged (``repro/models/transformer.py`` prefill), and
they serve no adapter bank (a ``ctx`` raises ValueError).

An MoE decoder holds {"moe": router (L, d, E), wi / wg (L, E, d, f_e), wo
(L, E, f_e, d)} where a dense one holds {"mlp"}; its layers run
``models.moe.moe_layer`` (plain torch, as in JAX) and ``forward`` returns
the mean over layers of its load-balance loss as ``moe_aux``. Experts are
never rotated per request (a bank's ``rot_mlp`` does not reach them).
Under ``tp`` the experts split over the ranks (``moe_layer``'s expert
parallelism; each rank routes the whole, gathered sequence).

Layer weights stay stacked (L, d_in, d_out) as in the JAX tree; the JAX
``lax.scan`` over layers is a Python loop over slices of the stacked
tensors (a quantized weight is a ``QuantTensor`` whose codes and per-layer
scales slice together). The KV cache is {"kv": {"k", "v": (L, B, S, K, D)}},
the paged state {"pages": {"k", "v": (L, P, page, K, D)}, "table": (B,
max_pages + 1) int32}; both are updated in place. ``cfg.remat`` applies to ``forward`` under autograd: "full"
recomputes each layer in the backward (``torch.utils.checkpoint``, as JAX's
``jax.checkpoint`` per scanned layer), "none" keeps every activation.

Tensor parallelism (``tp``, a ``distrib.tp.TPShard``): each rank holds its
shards of the params and runs the serving functions, and ``forward`` /
``lm_loss`` for training, at local shapes (the collectives are
autograd-aware; ``cfg.seq_parallel`` splits the residual stream on the
sequence between blocks). The embedding is vocab-parallel (ids outside the rank's
rows are masked, then all-reduced), attention and MLP split per
``models.attention`` / ``layers.apply_mlp``, and the LM head (or tied
table) is column-parallel and all-gathers its logits, so every rank picks
the same greedy token. ``init_lm(keep=)`` hands each weight to the caller
as it is drawn, so a rank keeps its slice and never holds the whole tree.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core.peft import AdapterContext, PrefillRequest
from repro_torch.device import DeviceLike, resolve_device
from . import registry
from .attention import (attention_block, init_attention, init_cache,
                        init_paged_kv, paged_attention_block,
                        paged_prefill_chunk_block)
from .layers import (apply_mlp, cross_entropy, embed_init, init_mlp,
                     init_stacked_mlp, keep_all, qlinear, rms_norm,
                     seeded_generator, softcap, stacked_dense_init,
                     unbind_layers)
from .moe import init_moe, moe_layer
from .ssm import init_mamba, init_mamba_state, mamba_block, mamba_decode_step


def _traits(cfg: ModelConfig) -> registry.FamilyOps:
    """The registry record of this config's family: every structural branch
    here reads its ``mixer``, never the family string."""
    return registry.get(cfg.family)


def _no_bank(cfg: ModelConfig, ctx: Optional[AdapterContext]) -> None:
    if ctx is not None:
        raise ValueError(f"adapter bank serving not supported for "
                         f"family {cfg.family}")


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: DeviceLike = "cuda", keep=keep_all) -> Dict[str, Any]:
    """Random weights drawn on ``device`` from a seeded torch.Generator
    (same tree, shapes and scales as the JAX ``init_lm``). ``keep(path,
    leaf)`` takes each decoder weight as it is drawn and returns what the
    tree holds (a split model's slice); the draws are the same either
    way."""
    dev = resolve_device(device)
    gen = seeded_generator(seed, dev)
    wd = cfg.weight_dtype
    vp = cfg.padded_vocab()
    L = cfg.num_layers
    params: Dict[str, Any] = {
        "embed": {"table": keep("embed/table",
                                embed_init(gen, vp, cfg.d_model, wd, dev))},
        "final_norm": torch.zeros((cfg.d_model,), dtype=wd, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": keep("lm_head/w", stacked_dense_init(
            gen, 1, cfg.d_model, vp, wd, dev)[0])}
    zeros = lambda *shape: torch.zeros(shape, dtype=wd, device=dev)
    mixer = _traits(cfg).mixer
    if mixer == "attention":
        params["layers"] = {
            "attn_norm": zeros(L, cfg.d_model),
            "attn": init_attention(gen, cfg, L, dev, keep=keep,
                                   prefix="layers/attn/"),
            "mlp_norm": zeros(L, cfg.d_model),
        }
        if cfg.is_moe:
            params["layers"]["moe"] = init_moe(gen, cfg, L, wd, dev,
                                               keep=keep,
                                               prefix="layers/moe/")
        else:
            params["layers"]["mlp"] = init_stacked_mlp(
                gen, L, cfg.d_model, cfg.d_ff, cfg.mlp_type, wd, dev,
                keep=keep, prefix="layers/mlp/")
        if _traits(cfg).has_patches:
            params["patch_proj"] = {"wi": keep(
                "patch_proj/wi", stacked_dense_init(
                    gen, 1, cfg.frontend_dim, cfg.d_model, wd, dev)[0])}
    elif mixer == "ssm":
        params["layers"] = {"norm": zeros(L, cfg.d_model),
                            "mamba": init_mamba(gen, cfg, (L,), wd, dev,
                                                keep=keep,
                                                prefix="layers/mamba/")}
    else:
        per = cfg.attn_every
        if L % per:
            raise ValueError("attn_every must divide num_layers")
        nsuper = L // per
        params["blocks"] = {
            "norm": zeros(nsuper, per, cfg.d_model),
            "mamba": init_mamba(gen, cfg, (nsuper, per), wd, dev, keep=keep,
                                prefix="blocks/mamba/")}
        params["shared_attn"] = {
            "norm": zeros(cfg.d_model),
            "attn": init_attention(gen, cfg, 0, dev, keep=keep,
                                   prefix="shared_attn/attn/"),
            "mlp_norm": zeros(cfg.d_model),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, wd,
                            dev, keep=keep, prefix="shared_attn/mlp/")}
    return params


def _slice(tree: Any, i: int) -> Any:
    """Layer i of a layer-stacked tree (views, no copies; a QuantTensor
    slices its codes and scales)."""
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree: Any, n: int) -> list:
    """The n layers of a layer-stacked tree as views. Under autograd one
    unbind per leaf backs into one stack of the layer gradients, where n
    separate slices would each scatter into a zero tensor of the whole
    stack."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(unbind_layers(tree))


def _ffn(cfg: ModelConfig, lp, h: torch.Tensor, rot=None, tp=None):
    """The layer's MLP or MoE on the residual h (its norm first): (output,
    moe aux loss, or None for a dense MLP)."""
    hin = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if "moe" in lp:      # split by experts or by d_ff under tp
        return moe_layer(lp["moe"], hin, cfg, segment=cfg.moe_segment, tp=tp)
    return apply_mlp(lp["mlp"], hin, cfg.mlp_type, rot=rot, tp=tp), None


def _decoder_layer(cfg: ModelConfig, lp, h: torch.Tensor, cache=None,
                   cache_pos=None, rot_attn=None, rot_mlp=None, tp=None):
    """-> (h, moe aux loss or None)."""
    a, cache = attention_block(
        lp["attn"], rms_norm(h, lp["attn_norm"], cfg.norm_eps), cfg,
        cache=cache, cache_pos=cache_pos, causal=True, rot=rot_attn, tp=tp)
    h = h + a
    m, aux = _ffn(cfg, lp, h, rot_mlp, tp)
    return h + m, aux


def _shared_attn_layer(cfg: ModelConfig, sp, h: torch.Tensor, cache=None,
                       cache_pos=None, tp=None) -> torch.Tensor:
    """The hybrid's shared attention + MLP block (its KV cache, when given,
    is written in place)."""
    a, _ = attention_block(sp["attn"], rms_norm(h, sp["norm"], cfg.norm_eps),
                           cfg, cache=cache, cache_pos=cache_pos, causal=True,
                           tp=tp)
    h = h + a
    return h + apply_mlp(sp["mlp"], rms_norm(h, sp["mlp_norm"], cfg.norm_eps),
                         cfg.mlp_type, tp=tp)


def _mamba_layer(cfg: ModelConfig, lp, h: torch.Tensor,
                 tp=None) -> torch.Tensor:
    return h + mamba_block(lp["mamba"], rms_norm(h, lp["norm"], cfg.norm_eps),
                           cfg, tp)


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor,
           tp=None) -> torch.Tensor:
    table = params["embed"]["table"]
    if tp is not None and tp.vocab_split:
        # vocab-parallel: this rank's rows answer the ids they hold, the
        # others give zeros, and the sum is the whole lookup (exact)
        n = table.shape[0]
        local = tokens - tp.rank * n
        mine = (local >= 0) & (local < n)
        h = table[local.clamp(0, n - 1)]
        h = tp.leave(torch.where(mine[..., None], h,
                                 torch.zeros((), dtype=h.dtype,
                                             device=h.device)))
    else:
        h = table[tokens]
        if tp is not None:
            h = tp.leave(h, False)      # under sequence parallelism: a slice
    h = h.to(cfg.act_dtype)
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    return h


def _unembed(cfg: ModelConfig, params, h: torch.Tensor,
             tp=None) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if tp is not None:
        h = tp.enter(h, tp.vocab_split)
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["table"].T.to(h.dtype)
    else:
        logits = qlinear(h, params["lm_head"]["w"], cast=True)
    if tp is not None and tp.vocab_split:
        logits = tp.all_gather(logits, -1)      # every rank: every column
    return softcap(logits, cfg.logit_softcap)


def _remat(cfg: ModelConfig, fn):
    """The layer body under ``cfg.remat``; recomputation only matters (and
    only happens) when autograd records the forward."""
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs, recompute the rest) is "
            "not ported yet; use 'full' or 'none'")
    if cfg.remat not in ("full", "none"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _run_layers(cfg: ModelConfig, params, h: torch.Tensor, kv=None,
                cache_pos=None, ctx: Optional[AdapterContext] = None,
                tp=None):
    for i in range(cfg.num_layers):
        lp = _slice(params["layers"], i)
        cache = _slice(kv, i) if kv is not None else None
        rot_attn, rot_mlp = _layer_rotators(ctx, i, tp)
        h, _ = _decoder_layer(cfg, lp, h, cache, cache_pos, rot_attn,
                              rot_mlp, tp)
    return h


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, Vp), moe_aux). batch["tokens"]: (B, S). moe_aux is
    the mean over layers of each MoE layer's Switch load-balance loss (fp32
    scalar; 0 for a dense model and the Mamba2 families).
    ``tp``: a split model's forward (the ``ssm`` / ``hybrid`` prefill, and
    training on a mesh: under ``cfg.seq_parallel`` the residual stream
    holds the rank's share of the sequence between blocks)."""
    if tp is not None:
        tp = tp.with_seq(batch["tokens"].shape[1])
    h = _embed(cfg, params, batch["tokens"], tp)
    n_prefix = 0
    if _traits(cfg).has_patches and "patches" in batch:
        h = torch.cat([_patch_embed(cfg, params, batch["patches"]), h], 1)
        n_prefix = batch["patches"].shape[1]
    mixer = _traits(cfg).mixer
    auxs = []
    if mixer == "attention":
        layer = _remat(cfg, lambda lp, hc: _decoder_layer(cfg, lp, hc,
                                                          tp=tp))
        for lp in _unbind(params["layers"], cfg.num_layers):
            h, aux = layer(lp, h)
            if aux is not None:
                auxs.append(aux)
    elif mixer == "ssm":
        layer = _remat(cfg, lambda lp, hc: _mamba_layer(cfg, lp, hc, tp))
        for lp in _unbind(params["layers"], cfg.num_layers):
            h = layer(lp, h)
    else:
        sp = params["shared_attn"]
        per = cfg.attn_every

        def super_block(bp, hc):
            for mp in _unbind(bp, per):
                hc = _mamba_layer(cfg, mp, hc, tp)
            return _shared_attn_layer(cfg, sp, hc, tp=tp)

        block = _remat(cfg, super_block)
        for bp in _unbind(params["blocks"], cfg.num_layers // per):
            h = block(bp, h)
    aux = (torch.stack(auxs).mean() if auxs
           else torch.zeros((), device=h.device))
    # the text positions only, so the logits align with batch["labels"]
    # (JAX slices the logits; the unembedding is per position)
    return _unembed(cfg, params, h[:, n_prefix:], tp), aux


def _patch_embed(cfg: ModelConfig, params, patches: torch.Tensor,
                 rot=None) -> torch.Tensor:
    """The vlm's patch stream (B, P, frontend_dim) projected to d_model by
    ``patch_proj/wi`` (``rot``: a bank's per-request rotation of it)."""
    return qlinear(patches.to(cfg.act_dtype), params["patch_proj"]["wi"],
                   rot, "wi", cast=True)


MOE_AUX_COEF = 0.01


def lm_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            tp=None):
    """Contract: batch["labels"][:, t] is the target for logits position t
    (the next token), with batch["mask"] zeroing padded/final slots.
    ``tp``: the rank's shard of a split model (every rank computes the same
    loss from the gathered logits). The loss is the cross entropy plus
    ``MOE_AUX_COEF`` times ``forward``'s moe_aux (the MoE load-balance
    loss; 0 without MoE), as in JAX. Returns (loss, {"loss", "accuracy",
    "moe_aux"})."""
    logits, aux = forward(cfg, params, batch, tp)
    loss, acc = cross_entropy(logits, batch["labels"], batch.get("mask"),
                              cfg.vocab_size)
    loss = loss + MOE_AUX_COEF * aux
    return loss, {"loss": loss, "accuracy": acc, "moe_aux": aux}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = "cuda", enc_len: int = 0,
                      tp=None):
    """Decoder and vlm {"kv"}: (L, B, S, K, D) (K the rank's local kv heads
    under ``tp``); ssm {"mamba"}: conv (L, B, W-1, C), ssm (L, B, H, N, P)
    fp32; hybrid both, stacked (nsuper, per, B, ...) and (nsuper, B, S, K,
    D). ``enc_len`` is the registry's uniform signature (no encoder
    stream here)."""
    del enc_len
    dev = resolve_device(device)
    mixer = _traits(cfg).mixer
    if mixer == "ssm":
        return {"mamba": init_mamba_state(cfg, batch, (cfg.num_layers,), dev,
                                          tp)}
    n = cfg.num_layers
    state = {}
    if mixer == "hybrid":
        n = cfg.num_layers // cfg.attn_every
        state["mamba"] = init_mamba_state(cfg, batch, (n, cfg.attn_every),
                                          dev, tp)
    c = init_cache(cfg, batch, max_len, dev,
                   kv_heads=tp.kv_heads if tp is not None else None)
    state["kv"] = {k: v[None].repeat((n,) + (1,) * v.dim())
                   for k, v in c.items()}
    return state


def _mamba_decode_layer(cfg: ModelConfig, lp, h: torch.Tensor, st, tp=None):
    """One Mamba layer's decode step; its state slices ``st`` are
    overwritten with the new state."""
    y, new = mamba_decode_step(lp["mamba"], rms_norm(h, lp["norm"],
                                                     cfg.norm_eps), st, cfg,
                               tp)
    st["conv"].copy_(new["conv"])
    st["ssm"].copy_(new["ssm"])
    return h + y


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, state, pos,
                ctx: Optional[AdapterContext] = None, tp=None):
    """One token for the whole batch. tokens: (B, 1); pos: scalar or (B,)
    per-slot write positions. ``ctx`` rotates row i with adapter
    ``ctx.slots[i]`` before every adapted projection (decoder only: the
    other families raise ValueError). The state is updated in place.
    Returns (logits (B, 1, Vp), state)."""
    mixer = _traits(cfg).mixer
    if mixer == "attention":
        h = _embed(cfg, params, tokens, tp)
        h = _run_layers(cfg, params, h, state["kv"], cache_pos=pos, ctx=ctx,
                        tp=tp)
        return _unembed(cfg, params, h, tp), state
    _no_bank(cfg, ctx)
    h = _embed(cfg, params, tokens, tp)
    if mixer == "ssm":
        for i in range(cfg.num_layers):
            h = _mamba_decode_layer(cfg, _slice(params["layers"], i), h,
                                    _slice(state["mamba"], i), tp)
    else:
        sp = params["shared_attn"]
        for s in range(cfg.num_layers // cfg.attn_every):
            bp, mst = _slice(params["blocks"], s), _slice(state["mamba"], s)
            for j in range(cfg.attn_every):
                h = _mamba_decode_layer(cfg, _slice(bp, j), h, _slice(mst, j),
                                        tp)
            h = _shared_attn_layer(cfg, sp, h, cache=_slice(state["kv"], s),
                                   cache_pos=pos, tp=tp)
    return _unembed(cfg, params, h, tp), state


def _gather_last(h: torch.Tensor, last_idx) -> torch.Tensor:
    """h[:, last_idx[i]] per row, keepdims: each row's logits come from its
    own last valid prompt position."""
    if last_idx is None:
        return h[:, -1:]
    idx = torch.as_tensor(last_idx, dtype=torch.int64, device=h.device)
    idx = idx.reshape(-1).expand(h.shape[0])
    return h[torch.arange(h.shape[0], device=h.device), idx][:, None]


def prefill(cfg: ModelConfig, params, req: PrefillRequest, state, tp=None):
    """Full-prompt forward that fills the KV cache; returns (last_logits,
    state) with logits gathered at ``req.last_idx``.

    ssm / hybrid: the JAX package's prefill, mirrored as it is — ``forward``
    for the logits, and the decode state returned UNCHANGED (neither the
    Mamba states nor the hybrid's KV cache take the prompt; decode goes on
    from them as they were)."""
    if _traits(cfg).mixer != "attention":
        _no_bank(cfg, req.ctx)
        logits, _ = forward(cfg, params, req.batch, tp)
        return _gather_last(logits, req.last_idx), state
    h = _embed(cfg, params, req.batch["tokens"], tp)
    if _traits(cfg).has_patches and "patches" in req.batch:
        # the patches lead the stream; last_idx counts them
        ctx = req.ctx
        rot = ctx.rotator(ctx.group("patch_proj")) if ctx is not None else None
        h = torch.cat([_patch_embed(cfg, params, req.batch["patches"], rot),
                       h], 1)
    h = _run_layers(cfg, params, h, state["kv"], ctx=req.ctx, tp=tp)
    return _unembed(cfg, params, _gather_last(h, req.last_idx), tp), state


# ---------------------------------------------------------------------------
# serving: paged KV cache + chunked prefill
# ---------------------------------------------------------------------------

def _paged_decoder_layer(cfg: ModelConfig, lp, h: torch.Tensor, pages, table,
                         pos, rot_attn=None, rot_mlp=None,
                         tp=None) -> torch.Tensor:
    """Decoder layer body with the KV write / read routed through a page
    table (decode step: full batch, one token per row)."""
    a, _ = paged_attention_block(
        lp["attn"], rms_norm(h, lp["attn_norm"], cfg.norm_eps), cfg,
        pages=pages, table=table, pos=pos, rot=rot_attn, tp=tp)
    h = h + a
    return h + _ffn(cfg, lp, h, rot_mlp, tp)[0]


def init_paged_state(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_pages: int,
                     device: DeviceLike = "cuda", tp=None):
    """Paged decode state: per-layer page pools plus one int32 page table
    per slot. The table has ``max_pages + 1`` columns — the extra SENTINEL
    column always holds the garbage page 0, so a parked row
    (pos == max_pages * page_size) writes into garbage."""
    dev = resolve_device(device)
    pools = init_paged_kv(cfg, num_pages, page_size, dev,
                          kv_heads=tp.kv_heads if tp is not None else None)
    pages = {k: v[None].repeat((cfg.num_layers,) + (1,) * v.dim())
             for k, v in pools.items()}
    table = torch.zeros((batch, max_pages + 1), dtype=torch.int32, device=dev)
    return {"pages": pages, "table": table}


def _layer_rotators(ctx: Optional[AdapterContext], i: int, tp=None):
    bl_tree = ctx.group("layers") if ctx is not None else None
    if bl_tree is None:
        return None, None
    bl = _slice(bl_tree, i)
    return ctx.rotator(bl.get("attn"), tp), ctx.rotator(bl.get("mlp"), tp)


def paged_decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                      pos, ctx: Optional[AdapterContext] = None, tp=None):
    """One token for the whole batch through per-slot page tables.

    tokens: (B, 1); pos: (B,) per-slot write positions (parked rows carry
    max_pages * page_size); state: {"pages", "table"} from
    ``init_paged_state``, whose pages are written in place (host code owns
    table edits at admission / finish). Returns (logits, state)."""
    h = _embed(cfg, params, tokens, tp)
    table = state["table"]
    for i in range(cfg.num_layers):
        rot_attn, rot_mlp = _layer_rotators(ctx, i, tp)
        h = _paged_decoder_layer(cfg, _slice(params["layers"], i), h,
                                 _slice(state["pages"], i), table, pos,
                                 rot_attn, rot_mlp, tp)
    return _unembed(cfg, params, h, tp), state


def paged_chunk_prefill(cfg: ModelConfig, params, req: PrefillRequest, state,
                        slot: int, start: int, tp=None):
    """One prompt CHUNK for one slot through the paged cache.

    req.batch["tokens"]: (1, C) with C the fixed chunk width; req.last_idx:
    local index of the chunk's last valid token (only meaningful on the
    final chunk, whose logits seed the first generated token). Earlier
    chunks and shared-prefix pages already occupy positions [0, start).
    Returns (logits, state)."""
    h = _embed(cfg, params, req.batch["tokens"], tp)
    table_row = state["table"][int(slot)]
    for i in range(cfg.num_layers):
        rot_attn, rot_mlp = _layer_rotators(req.ctx, i, tp)
        lp = _slice(params["layers"], i)
        a, _ = paged_prefill_chunk_block(
            lp["attn"], rms_norm(h, lp["attn_norm"], cfg.norm_eps), cfg,
            pages=_slice(state["pages"], i), table_row=table_row,
            start=start, rot=rot_attn, tp=tp)
        h = h + a
        h = h + _ffn(cfg, lp, h, rot_mlp, tp)[0]
    return _unembed(cfg, params, _gather_last(h, req.last_idx), tp), state


registry.register(registry.FamilyOps(
    family="decoder",
    init_params=init_lm,
    forward=forward,
    loss=lm_loss,
    init_decode_state=init_decode_state,
    prefill=prefill,
    decode_step=decode_step,
    init_paged_state=init_paged_state,
    paged_decode_step=paged_decode_step,
    paged_chunk_prefill=paged_chunk_prefill,
))

# the Mamba2 families and the vlm: the contiguous serve surface only (no
# paged KV, as in JAX)
for _family, _traits_kw in (("ssm", dict(mixer="ssm")),
                            ("hybrid", dict(mixer="hybrid")),
                            ("vlm", dict(has_patches=True))):
    registry.register(registry.FamilyOps(
        family=_family, init_params=init_lm, forward=forward, loss=lm_loss,
        init_decode_state=init_decode_state, prefill=prefill,
        decode_step=decode_step, **_traits_kw))
