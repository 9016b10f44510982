"""Train / eval / serve step builders (port of ``repro/train/steps.py``).
PyTorch runs eagerly, so each builder returns a plain closure; the JAX
package jits the same bodies.

train_step (PEFT mode, the paper's setting): frozen base params (no grads),
adapter params (fp32, trainable), optimizer state (adapters only), batch ->
microbatches -> mean adapter grads in fp32 -> AdamW update. The adapters are
materialized weight-side inside the step (``core.peft.materialize_tree``),
so on the card the GS kernels run forward and backward in every step.

On a mesh (``build_train_step(cfg, tcfg, mesh)``; one process per rank, as
``torchrun`` starts them) the step takes the GLOBAL batch, cuts it into
microbatches as JAX's scan does, and keeps the rank's rows of each
(``ShardingRules.batch_spec``: split over the data axes where they
divide). PEFT: ``frozen`` holds the rank's shards of the params and the
adapters are whole on every rank, but for an expert stack split by
experts, whose adapters are the rank's experts' (``adapter_spec``). Full
fine-tuning: the trainable tree is the rank's shards of the params. The
forward runs the split model (``distrib.tp.TPShard``, its collectives
autograd-aware; ``cfg.seq_parallel`` splits the residual stream on the
sequence; an MoE layer runs the rank's experts, ``models.moe``). A weight
split over 'model' on its input rows is gathered one layer slice at a
time, rotated and cut back (``core.peft.materialize_split``; under
``cfg.remat == "full"`` the backward gathers each slice again rather than
keeping it, under "none" a slice is gathered once a step); a stack split
by experts rotates in place, with no gather. A rank's gradient of a leaf
is either whole or its share, summed over 'model' (``_MeshStep.share``:
an adapter or a replicated param in a split block, the residual stream's
norms under ``seq_parallel``; ``ShardingRules.grad_share``). A
microbatch's loss is its masked mean over the GLOBAL microbatch's valid
tokens, as GSPMD partitions JAX's step: each rank weights its rows' loss,
metrics and gradients by its share of those tokens (the MoE load-balance
term, a mean over rows, by its share of the rows), and the sums over the
data axes (pod x data) are the whole microbatch's, in fp32. The update
then runs the same on every rank, the gradient clip and ``grad_norm``
from the global norm (``_MeshStep.sum_sq``: a split leaf's parts summed
over 'model').

The serving builders run under ``torch.inference_mode``. Greedy sampling is
``argmax`` (first index on ties, as ``jnp.argmax``). On a mesh with a data
axis the decode step serves the rank's rows of the batch (``local_rows``;
the decode state's batch rows split over the data axes) and
``gather_rows`` joins a per-row result back.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import optim
from repro_torch.config import ModelConfig
from repro_torch.core import peft as peft_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.models.transformer import MOE_AUX_COEF
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.sharding import specs as shard_specs

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


def _params_of(peft_cfg: peft_lib.PEFTConfig, trainable, frozen, split=None):
    if peft_cfg.is_peft:
        if split is not None:
            return split.materialize(peft_cfg, frozen, trainable)
        return peft_lib.materialize_tree(peft_cfg, frozen, trainable)
    return trainable


class _MeshStep:
    """What a rank's train / eval step needs of its mesh: its model shard,
    the weights' specs, the rotation of its split weights, its rows of a
    batch's microbatches, and the gradient reductions."""

    def __init__(self, cfg: ModelConfig, mesh, peft: bool = True):
        from repro_torch.distrib import tp as tp_lib
        t = api.family_ops(cfg)
        if t.has_encoder or t.has_patches:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}) does not train on a mesh yet: "
                "the encdec / vlm mesh item of ROADMAP Queue 1")
        self.tp_lib = tp_lib
        self.cfg = cfg
        self.mesh = mesh
        self.peft = peft
        self.rules = shard_specs.ShardingRules(cfg, mesh)
        self.shard = tp_lib.model_shard(cfg, mesh)
        self.seq_split = False      # the last microbatches' sequence split
        self._specs: Dict[str, tuple] = {}
        self._kept: Optional[Dict[tuple, torch.Tensor]] = None
        # bytes this rank received gathering frozen weights to rotate them,
        # by weight path (an expert stack split by experts gathers none)
        self.gather_bytes: Dict[str, int] = {}

    @contextlib.contextmanager
    def one_step(self):
        """One train step. Under remat "none" autograd holds each gathered
        row-split slice until its microbatch's backward, so keeping it for
        the next microbatch of the step adds nothing to the peak and saves
        a gather; it is dropped with the step."""
        self._kept = {} if self.cfg.remat != "full" else None
        try:
            yield
        finally:
            self._kept = None

    def spec(self, path: str, leaf) -> tuple:
        if path not in self._specs:
            self._specs[path] = self.rules.param_spec(path, tuple(leaf.shape))
        return self._specs[path]

    def materialize(self, peft_cfg, frozen, trainable):
        flat = peft_lib.flatten_paths(frozen)
        specs = {p: self.spec(p, flat[p]) for p in trainable if p in flat}

        def whole(key, w, spec):
            if self._kept is not None and key in self._kept:
                return self._kept[key]
            out = shard_specs.gather_leaf(self.mesh, w.detach(), spec)
            self.gather_bytes[key[0]] = self.gather_bytes.get(key[0], 0) + (
                out.numel() - w.numel()) * out.element_size()
            if self._kept is not None:
                self._kept[key] = out
            return out

        def local(w, spec):
            # a copy of the rank's block: the whole rotated slice is freed
            return shard_specs.local_slice(self.mesh, w, spec).contiguous()

        # remat "full" trades a second gather for the memory of the whole
        # slices, as it trades recomputation for the layers' activations
        return peft_lib.materialize_split(peft_cfg, frozen, trainable, specs,
                                          whole, local,
                                          regather=self.cfg.remat == "full")

    def microbatches(self, batch: Dict[str, torch.Tensor], n: int):
        """[(the rank's rows of microbatch i, its token weight, its row
        weight)]: the global batch cut into ``n`` microbatches first, then
        each split over the data axes (whole on every rank where it does
        not divide). The token weight is the rank's share of the
        microbatch's valid tokens (a masked mean's denominator), so the
        weighted sums over the data axes are the global microbatch's mean;
        the row weight its share of the rows (the MoE load-balance loss is
        a mean over rows, unmasked)."""
        mbs = _split_microbatches(batch, n)
        size = next(iter(batch.values())).shape[0] // n
        spec = self.rules.batch_spec(mbs[0], size)
        rows = [{k: shard_specs.local_slice(self.mesh, v, spec[k])
                 for k, v in mb.items()} for mb in mbs]
        if self.shard is not None:
            self.seq_split = self.shard.with_seq(
                rows[0]["tokens"].shape[1]).sp
        n_dp = shard_specs.dp_size(self.mesh)
        if n_dp == 1 or size % n_dp:
            return [(r, 1.0 / n_dp, 1.0 / n_dp) for r in rows]
        counts = torch.stack([_valid_tokens(r) for r in rows])
        (total,) = self.tp_lib.dp_sum(self.mesh, [counts])
        weights = counts.clamp(min=1.0) / total.clamp(min=1.0)
        return [(r, w, 1.0 / n_dp) for r, w in zip(rows, weights)]

    def _weight_path(self, path: str) -> str:
        """The weight a trainable leaf belongs to: the leaf itself under
        full fine-tuning, an adapter factor's weight under PEFT."""
        return path.rsplit("/", 1)[0] if self.peft else path

    def share(self, path: str, leaf) -> bool:
        """Is the rank's gradient of this trainable leaf a share, summed
        over 'model' (else it is whole)? PEFT: a replicated adapter in a
        split block (an expert stack's adapters split with their experts:
        whole); full fine-tuning: ``ShardingRules.grad_share``."""
        if self.shard is None:
            return False
        w = self._weight_path(path)
        if self.peft:
            return (not self.rules.expert_split(w)
                    and self.rules.block_split(w))
        return self.rules.grad_share(w, self.spec(w, leaf), self.seq_split)

    def split_leaf(self, path: str, leaf) -> bool:
        """Does this trainable leaf hold only the rank's part over
        'model' (an expert stack's adapter under PEFT, a split param under
        full fine-tuning)?"""
        if self.shard is None:
            return False
        w = self._weight_path(path)
        if self.peft:
            return self.rules.expert_split(w)
        return "model" in self.spec(w, leaf)

    def reduce(self, grads, metrics):
        """Sum the shares of the gradients over 'model', then every
        (weighted) gradient and metric over the data axes."""
        paths = peft_lib.flatten_paths(grads)
        if self.shard is not None:
            part = [k for k, v in paths.items() if self.share(k, v)]
            if part:
                summed = _flat_reduce(self.shard.comm.all_reduce,
                                      [paths[k] for k in part])
                paths.update(zip(part, summed))
        keys = sorted(paths)
        names = sorted(metrics)
        both = self.tp_lib.dp_sum(
            self.mesh, [paths[k] for k in keys] +
            [metrics[k].to(torch.float32).reshape(1) for k in names])
        out = dict(zip(keys, both[:len(keys)]))
        mets = {k: v.reshape(()) for k, v in zip(names, both[len(keys):])}
        return _rebuild(grads, iter(out[k] for k in
                                    peft_lib.flatten_paths(grads))), mets

    def sum_sq(self, grads) -> torch.Tensor:
        """The reduced gradients' global sum of squares, the same on every
        rank: each split leaf's part summed over 'model', each replicated
        leaf once (JAX's ``global_norm`` over the whole tree)."""
        sq = [(self.split_leaf(k, v), torch.sum(torch.square(
                  v.to(torch.float32))))
              for k, v in peft_lib.flatten_paths(grads).items()]
        whole = sum(v for split, v in sq if not split)
        part = sum(v for split, v in sq if split)
        if torch.is_tensor(part):
            part = self.shard.comm.all_reduce(part)
        return whole + part


def _valid_tokens(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tokens a masked-mean loss counts in ``batch`` (fp32)."""
    if "mask" in batch:
        return batch["mask"].to(torch.float32).sum()
    return torch.tensor(float(batch["labels"].numel()),
                        device=batch["labels"].device)


def _flat_reduce(fn, tensors):
    """``fn`` over all of ``tensors`` at once: one fp32 buffer, cut back to
    each tensor's shape and dtype."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    flat = fn(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def build_grad_fn(cfg: ModelConfig, peft_cfg: peft_lib.PEFTConfig,
                  split: Optional[_MeshStep] = None):
    """grad_fn(trainable, frozen, batch) -> (loss, metrics, grads): the
    loss and the gradients w.r.t. the trainable tree (same nesting), as one
    train step takes them. ``split``: a rank's mesh context (its share of
    the gradients, before the step's reductions); there ``grad_fn(...,
    aux_weight=a)`` differentiates (and returns as the loss) the loss with
    its MoE load-balance term times ``a``: the rank's row weight over its
    token weight, as the step weights the cross entropy by tokens and the
    load-balance loss, a mean over rows, by rows."""
    tp = split.shard if split is not None else None

    def grad_fn(trainable, frozen, mb, aux_weight=1.0):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), trainable)
        with torch.enable_grad():
            loss, metrics = api.loss_fn(
                cfg, _params_of(peft_cfg, leaves, frozen, split), mb, tp)
            if cfg.is_moe and aux_weight != 1.0:
                loss = loss + (aux_weight - 1.0) * (MOE_AUX_COEF *
                                                    metrics["moe_aux"])
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat) if flat else []
        gtree = _rebuild(leaves, iter(grads))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gtree

    return grad_fn


def build_train_step(cfg: ModelConfig, tcfg: TrainStepConfig, mesh=None):
    """Returns train_step(frozen, trainable, opt_state, batch) ->
    (trainable, opt_state, metrics). PEFT: trainable = adapters; full FT:
    trainable = params and frozen is an empty dict. ``use_pallas`` plays no
    part: the kernels follow the device of the tensors. ``mesh``: a rank's
    step on a ``launch.mesh`` mesh (see the module docstring)."""
    n_micro = tcfg.num_microbatches
    schedule = tcfg.schedule or optim.constant()
    split = None
    if mesh is not None:
        split = _MeshStep(cfg, mesh, peft=tcfg.peft.is_peft)
    grad_fn = build_grad_fn(cfg, tcfg.peft, split)

    def train_step(frozen: Tree, trainable: Tree, opt_state: Tree,
                   batch: Dict[str, torch.Tensor]):
        sum_sq = None
        if split is not None:
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), trainable)
            lacc = None
            with split.one_step():
                for mb, w, w_row in split.microbatches(batch, n_micro):
                    loss, metrics, g = grad_fn(trainable, frozen, mb,
                                               w_row / w)
                    s = w / n_micro
                    gacc = tree_map(lambda a, b: a + b.to(torch.float32) * s,
                                    gacc, g)
                    del g       # full fine-tuning: a whole tree of params'
                    lacc = loss * s if lacc is None else lacc + loss * s
            # JAX keeps the last microbatch's metrics and the mean loss
            metrics = {k: v * (w_row if k == "moe_aux" else w)
                       for k, v in metrics.items()}
            metrics["loss"] = lacc
            grads, metrics = split.reduce(gacc, metrics)
            del gacc
            sum_sq = split.sum_sq
        elif n_micro > 1:
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), trainable)
            lacc = None
            for mb in _split_microbatches(batch, n_micro):
                loss, metrics, g = grad_fn(trainable, frozen, mb)
                gacc = tree_map(lambda a, b: a + b.to(torch.float32) / n_micro,
                                gacc, g)
                del g
                lacc = (loss / n_micro if lacc is None
                        else lacc + loss / n_micro)
            grads = gacc
            metrics["loss"] = lacc
        else:
            loss, metrics, grads = grad_fn(trainable, frozen, batch)
        lr_scale = schedule(opt_state["step"])
        with torch.no_grad():
            new_trainable, new_opt, om = optim.update(
                tcfg.opt, grads, opt_state, trainable, lr_scale, sum_sq)
        metrics = dict(metrics)
        metrics.update(om)
        return new_trainable, new_opt, metrics

    train_step.split = split
    return train_step


def _rebuild(tree: Tree, it) -> Tree:
    """A tree of ``tree``'s structure filled from ``it`` in sorted-key
    order (the order of ``tree_leaves``)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def build_eval_step(cfg: ModelConfig, tcfg: TrainStepConfig, mesh=None):
    """eval_step(frozen, trainable, batch) -> metrics (no gradients); on a
    mesh the rank's rows and shards, the metrics averaged over the data
    axes."""
    peft_cfg = tcfg.peft
    split = (_MeshStep(cfg, mesh, peft=peft_cfg.is_peft)
             if mesh is not None else None)
    tp = split.shard if split is not None else None

    @torch.no_grad()
    def eval_step(frozen, trainable, batch):
        params = _params_of(peft_cfg, trainable, frozen, split)
        if split is None:
            return api.loss_fn(cfg, params, batch, tp)[1]
        ((mb, w, w_row),) = split.microbatches(batch, 1)
        _, metrics = api.loss_fn(cfg, params, mb, tp)
        if cfg.is_moe:      # the loss's load-balance term is a row mean
            metrics["loss"] = metrics["loss"] + (w_row / w - 1.0) * (
                MOE_AUX_COEF * metrics["moe_aux"])
        return split.reduce({}, {k: v * (w_row if k == "moe_aux" else w)
                                 for k, v in metrics.items()})[1]

    return eval_step


def _tp_kw(tp) -> dict:
    """The family functions' ``tp=`` argument, passed only for a split
    model (the stateless families' functions take none)."""
    return {} if tp is None else {"tp": tp}


def build_decode_step(cfg: ModelConfig, tp=None):
    """step(params, ctx, tokens (B, 1), state, pos) -> (next_tok (B, 1),
    logits, state). ``pos`` is a scalar or (B,) per-slot positions; ``ctx``
    an optional AdapterContext (None serves the bare/merged model); ``tp``
    the rank's ``distrib.tp.TPShard`` of a split model. With a data axis
    the caller hands the rank's rows (``local_rows``) and a decode state
    built for them, as JAX's ``decode_state_spec`` splits the batch over
    the data axes, and ``gather_rows`` joins a per-row result back."""
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


def _decode_state_batch_axes(cfg: ModelConfig, max_len: int,
                             enc_len: int = 0) -> Tree:
    """Per-leaf batch axis of the decode state, found by diffing the state's
    shapes at batch 1 and 2 (``api.abstract_decode_state``, no memory): the
    leaves put it at different axes (kv (L, B, S, K, D); encdec enc_out (B,
    F, D); ssm Mamba state (L, B, ...); hybrid Mamba state (nsuper, per, B,
    ...))."""
    s1 = api.abstract_decode_state(cfg, 1, max_len, enc_len)
    s2 = api.abstract_decode_state(cfg, 2, max_len, enc_len)

    def axis(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"no batch axis in decode-state leaf {a.shape}")

    return tree_map(axis, s1, s2)


def build_slot_prefill_step(cfg: ModelConfig, *, max_len: int,
                            enc_len: int = 0, device: DeviceLike = "cuda",
                            tp=None):
    """Continuous-batching admission: prefill ONE request (batch 1) into a
    fresh state and copy every leaf of it into row ``slot`` of the engine's
    slot-array state, along that leaf's own batch axis (found as the JAX
    package finds it; ``enc_len``: the encoder output's rows a slot).
    step(params, req, state, slot) -> (first_token int, state)."""
    fam = api.family_ops(cfg)
    dev = resolve_device(device)
    axes = _decode_state_batch_axes(cfg, max_len, enc_len)
    kw = _tp_kw(tp)

    def scatter(dst, src, ax, slot):
        dst.select(ax, slot).copy_(src.select(ax, 0))

    @torch.inference_mode()
    def slot_prefill(params, req: peft_lib.PrefillRequest, state, slot: int):
        sub = fam.init_decode_state(cfg, 1, max_len, dev, enc_len=enc_len,
                                    **kw)
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


def gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """A per-row result of the rank's rows (dim 0) joined over the data
    axes in rank order: the whole batch's, on every rank (no autograd)."""
    from repro_torch.distrib import tp as tp_lib
    comm = tp_lib.dp_comm(mesh)
    return t if comm is None else comm.all_gather(t, 0)


def local_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a whole batch under the data axes (dim 0), as
    ``ShardingRules.batch_spec`` splits a batch (whole where it does not
    divide)."""
    n = shard_specs.dp_size(mesh)
    if n == 1 or t.shape[0] % n:
        return t
    spec = (shard_specs._ax(shard_specs.dp_axes(mesh)),)
    return shard_specs.local_slice(mesh, t, spec)
