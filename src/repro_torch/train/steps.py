"""Train / eval / serve step builders (port of ``repro/train/steps.py``).
PyTorch runs eagerly, so each builder returns a plain closure; the JAX
package jits the same bodies.

train_step (PEFT mode, the paper's setting): frozen base params (no grads),
adapter params (fp32, trainable), optimizer state (adapters only), batch ->
microbatches -> mean adapter grads in fp32 -> AdamW update. The adapters are
materialized weight-side inside the step (``core.peft.materialize_tree``),
so on the card the GS kernels run forward and backward in every step.

The serving builders run under ``torch.inference_mode``. Greedy sampling is
``argmax`` (first index on ties, as ``jnp.argmax``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import optim
from repro_torch.config import ModelConfig
from repro_torch.core import peft as peft_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.optim.adamw import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    peft: peft_lib.PEFTConfig = peft_lib.PEFTConfig()
    opt: optim.OptimizerConfig = optim.OptimizerConfig()
    num_microbatches: int = 1
    schedule: Optional[Callable] = None


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """n microbatches along the batch dim (rows [i*B/n, (i+1)*B/n))."""
    return [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n)]


def _params_of(peft_cfg: peft_lib.PEFTConfig, trainable, frozen):
    if peft_cfg.is_peft:
        return peft_lib.materialize_tree(peft_cfg, frozen, trainable)
    return trainable


def build_grad_fn(cfg: ModelConfig, peft_cfg: peft_lib.PEFTConfig):
    """grad_fn(trainable, frozen, batch) -> (loss, metrics, grads): the
    loss and the gradients w.r.t. the trainable tree (same nesting), as one
    train step takes them."""

    def grad_fn(trainable, frozen, mb):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), trainable)
        with torch.enable_grad():
            loss, metrics = api.loss_fn(
                cfg, _params_of(peft_cfg, leaves, frozen), mb)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat) if flat else []
        gtree = _rebuild(leaves, iter(grads))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gtree

    return grad_fn


def build_train_step(cfg: ModelConfig, tcfg: TrainStepConfig):
    """Returns train_step(frozen, trainable, opt_state, batch) ->
    (trainable, opt_state, metrics). PEFT: trainable = adapters; full FT:
    trainable = params and frozen is an empty dict. ``use_pallas`` plays no
    part: the kernels follow the device of the tensors."""
    n_micro = tcfg.num_microbatches
    schedule = tcfg.schedule or optim.constant()
    grad_fn = build_grad_fn(cfg, tcfg.peft)

    def train_step(frozen: Tree, trainable: Tree, opt_state: Tree,
                   batch: Dict[str, torch.Tensor]):
        if n_micro > 1:
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), trainable)
            lacc = None
            for mb in _split_microbatches(batch, n_micro):
                loss, metrics, g = grad_fn(trainable, frozen, mb)
                gacc = tree_map(lambda a, b: a + b.to(torch.float32) / n_micro,
                                gacc, g)
                lacc = (loss / n_micro if lacc is None
                        else lacc + loss / n_micro)
            grads = gacc
            metrics["loss"] = lacc
        else:
            loss, metrics, grads = grad_fn(trainable, frozen, batch)
        lr_scale = schedule(opt_state["step"])
        with torch.no_grad():
            new_trainable, new_opt, om = optim.update(
                tcfg.opt, grads, opt_state, trainable, lr_scale)
        metrics = dict(metrics)
        metrics.update(om)
        return new_trainable, new_opt, metrics

    return train_step


def _rebuild(tree: Tree, it) -> Tree:
    """A tree of ``tree``'s structure filled from ``it`` in sorted-key
    order (the order of ``tree_leaves``)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def build_eval_step(cfg: ModelConfig, tcfg: TrainStepConfig):
    """eval_step(frozen, trainable, batch) -> metrics (no gradients)."""
    peft_cfg = tcfg.peft

    @torch.no_grad()
    def eval_step(frozen, trainable, batch):
        _, metrics = api.loss_fn(
            cfg, _params_of(peft_cfg, trainable, frozen), batch)
        return metrics

    return eval_step


def _tp_kw(tp) -> dict:
    """The family functions' ``tp=`` argument, passed only for a split
    model (the stateless families' functions take none)."""
    return {} if tp is None else {"tp": tp}


def build_decode_step(cfg: ModelConfig, tp=None):
    """step(params, ctx, tokens (B, 1), state, pos) -> (next_tok (B, 1),
    logits, state). ``pos`` is a scalar or (B,) per-slot positions; ``ctx``
    an optional AdapterContext (None serves the bare/merged model); ``tp``
    the rank's ``distrib.tp.TPShard`` of a split model."""
    fam = api.family_ops(cfg)
    kw = _tp_kw(tp)

    @torch.inference_mode()
    def serve_step(params, ctx, tokens, state, pos):
        logits, state = fam.decode_step(cfg, params, tokens, state, pos,
                                        ctx=ctx, **kw)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok[:, None], logits, state

    return serve_step


def build_prefill_step(cfg: ModelConfig, tp=None):
    """step(params, req: PrefillRequest, state) -> (logits, state)."""
    fam = api.family_ops(cfg)
    kw = _tp_kw(tp)

    @torch.inference_mode()
    def prefill_step(params, req: peft_lib.PrefillRequest, state):
        return fam.prefill(cfg, params, req, state, **kw)

    return prefill_step


def _decode_state_batch_axes(cfg: ModelConfig, max_len: int) -> Tree:
    """Per-leaf batch axis of the decode state, found by diffing the state's
    shapes at batch 1 and 2 (built on the meta device, no memory): the
    leaves put it at different axes (kv (L, B, S, K, D); ssm Mamba state
    (L, B, ...); hybrid Mamba state (nsuper, per, B, ...))."""
    fam = api.family_ops(cfg)
    s1 = fam.init_decode_state(cfg, 1, max_len, "meta")
    s2 = fam.init_decode_state(cfg, 2, max_len, "meta")

    def axis(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"no batch axis in decode-state leaf {a.shape}")

    return tree_map(axis, s1, s2)


def build_slot_prefill_step(cfg: ModelConfig, *, max_len: int,
                            device: DeviceLike = "cuda", tp=None):
    """Continuous-batching admission: prefill ONE request (batch 1) into a
    fresh state and copy every leaf of it into row ``slot`` of the engine's
    slot-array state, along that leaf's own batch axis (found as the JAX
    package finds it). step(params, req, state, slot) -> (first_token int,
    state)."""
    fam = api.family_ops(cfg)
    dev = resolve_device(device)
    axes = _decode_state_batch_axes(cfg, max_len)
    kw = _tp_kw(tp)

    def scatter(dst, src, ax, slot):
        dst.select(ax, slot).copy_(src.select(ax, 0))

    @torch.inference_mode()
    def slot_prefill(params, req: peft_lib.PrefillRequest, state, slot: int):
        sub = fam.init_decode_state(cfg, 1, max_len, dev, **kw)
        logits, sub = fam.prefill(cfg, params, req, sub, **kw)
        first = int(torch.argmax(logits[0, -1]))
        tree_map(lambda d, s_, a: scatter(d, s_, a, slot), state, sub, axes)
        return first, state

    return slot_prefill


def build_paged_decode_step(cfg: ModelConfig, tp=None):
    """One decode token for the whole batch through per-slot PAGE TABLES.
    Same call shape as ``build_decode_step`` — params, ctx, tokens (B, 1),
    state {"pages", "table"}, pos (B,) — so the paged engine drops in next
    to the contiguous one. Parked rows (pos at the sentinel position) write
    into the garbage page; their sampled token is ignored by the engine."""
    fam = api.family_ops(cfg)
    if fam.paged_decode_step is None:
        raise ValueError(f"family {cfg.family!r} has no paged decode path")
    kw = _tp_kw(tp)

    @torch.inference_mode()
    def serve_step(params, ctx, tokens, state, pos):
        logits, state = fam.paged_decode_step(cfg, params, tokens, state, pos,
                                              ctx=ctx, **kw)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok[:, None], logits, state

    return serve_step


def build_chunk_prefill_step(cfg: ModelConfig, tp=None):
    """Chunked-prefill admission unit: ONE fixed-width prompt chunk for ONE
    slot, written through that slot's page table.
    step(params, req, state, slot, start) -> (first_token, state), the
    token a 0-d device tensor (read it only on the final chunk, where
    req.last_idx marks the prompt's last valid token; the earlier chunks
    then cost no host sync)."""
    fam = api.family_ops(cfg)
    if fam.paged_chunk_prefill is None:
        raise ValueError(f"family {cfg.family!r} has no chunked-prefill path")
    kw = _tp_kw(tp)

    @torch.inference_mode()
    def chunk_step(params, req: peft_lib.PrefillRequest, state, slot: int,
                   start: int):
        logits, state = fam.paged_chunk_prefill(cfg, params, req, state,
                                                slot, start, **kw)
        return torch.argmax(logits[0, -1]), state

    return chunk_step
