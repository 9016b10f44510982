"""ModelRuntime — the serving entry point (port of ``repro/core/runtime.py``).

Binds ``ModelConfig + params + optional AdapterBank`` on one device.
``adapters`` + ``peft_cfg`` merge ONE adapter into the weights offline (the
paper's zero-overhead serving mode, §6.1, through the forward GS kernel);
``attach`` serves per-request adapters activation-side (GSOFT through the
transpose GS kernel, OFT and BOFT through the banked bdmm kernel,
Householder and Givens in plain torch) from an eager bank
(``{name: adapters}`` with one PEFTConfig or a ``{name: PEFTConfig}``
mapping) or from a store-paged bank under a device budget
(``hbm_budget=``, an ``AdapterStore``, or a checkpoint directory opened as
a disk-backed store). Merging and banking are mutually exclusive.
``quantized("int8")`` serves the same model over int8 base weights (the
bank, if any, carried over untouched: rotations stay in float and GSOFT's
fuse with the int8 matmul in one kernel). ``paged_state`` /
``paged_decode_fn`` / ``chunk_prefill_fn`` are the paged-KV engine's
surface. ``load_quantized`` serves a checkpoint over int8 weights.
``prefill_fn`` is the static engine's batched prefill; ``infer_fn`` /
``infer`` the stateless families' one whole-input forward (the image
family, served per request through the same bank and int8 weights).

The ``ssm`` and ``hybrid`` families build, prefill and decode here like the
decoder; as in the JAX package they serve no adapter bank (``attach``
builds one over mamba2 and its first prefill raises ValueError; zamba2's
(nsuper, per)-stacked weights refuse the bank when it is built) and have
no paged surface.

``mesh=`` (``distrib.tp.serve_mesh`` / ``launch.mesh.make_mesh``) serves
the model tensor-parallel, one process per rank: params are placed by
``ShardingRules.serve_params_tree``, one weight at a time (drawn from the
seed, read from a checkpoint, or taken from a tree the caller passes, and
merged with an offline adapter first when one is given), so a rank's
device holds its contiguous local slices and at most one whole weight
besides. A tree the caller passes stays the caller's: pass it on the host
and only the slices reach the card. ``attach`` commits an eager bank per
``bank_spec_tree`` (a store-paged bank's compact stacks follow the same
spec), ``quantized`` scales each split weight as the whole (a row-split
weight's per-channel max |w| is all-reduced), the decode and paged states
hold the rank's kv heads (``ShardingRules.kv_heads_kept``; the page table
replicated, its host allocation the same on every rank), and the step
closures carry the rank's ``TPShard`` to the model code's collectives. A
mesh that splits nothing (tp = 1) serves exactly as no mesh. The decoder,
``ssm`` and ``hybrid`` families split; the image family raises
NotImplementedError for tp > 1. An MoE decoder's expert stacks split by
experts where they divide (the rank holds its experts, ``TPShard.
experts``), else by d_ff; an offline merge then rotates only the rank's
experts, with their adapters.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from repro_torch import quant
from repro_torch.config import ModelConfig
from repro_torch.core import methods as methods_lib
from repro_torch.core import peft as peft_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api

Tree = Any


def _shape_of(leaf):
    """A zero-storage stand-in with ``leaf``'s shape, dtype and device
    (what bank and adapter builders read of a weight they do not hold)."""
    if quant.is_quant_tensor(leaf):
        return quant.QuantTensor(_shape_of(leaf.q), _shape_of(leaf.scale),
                                 leaf.meta)
    return torch.zeros((), dtype=leaf.dtype,
                       device=leaf.device).expand(leaf.shape)


def _check_bank_quant_compatible(bank) -> None:
    """Every method in the bank must be flagged ``quant_compatible`` (its
    rotation applies activation-side, in float, before the int8 matmul)."""
    bad = [m for m in bank.bank_methods
           if not methods_lib.get(m).quant_compatible]
    if bad:
        raise ValueError(
            f"bank methods {bad} are not quantization-compatible — they "
            "cannot serve over quantized base weights (see the "
            "quant_compatible flag on their core.methods records)")


def _placer(cfg: ModelConfig, mesh, device: torch.device):
    """(keep, shapes): ``keep(path, leaf)`` returns this rank's slice of a
    whole weight on ``device`` and records the weight's whole shape;
    ``shapes(local)`` is the tree of those whole shapes."""
    from repro_torch.sharding import specs as shard_specs
    rules, whole = shard_specs.ShardingRules(cfg, mesh), {}

    def keep(path, leaf):
        whole[path] = _shape_of(leaf)
        return shard_specs.place_leaf(mesh, leaf,
                                      rules.serve_leaf_spec(path, leaf), device)

    def shapes(local: Tree) -> Tree:
        out: Tree = {}
        for path, leaf in peft_lib.flatten_paths(local).items():
            peft_lib._nest_insert(out, path, whole[path] if path in whole
                                  else _shape_of(leaf))
        return out

    return keep, shapes


class ModelRuntime:
    """``ModelRuntime(cfg)`` initializes params from ``seed`` on ``device``
    (default the card); pass ``params=`` to reuse a tree already there.
    With ``mesh=`` each rank keeps its slice of every weight, placed one
    weight at a time (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, params: Optional[Tree] = None, *,
                 seed: int = 0, device: DeviceLike = "cuda", mesh=None,
                 bank: Optional[peft_lib.AdapterBank] = None,
                 adapters: Optional[Tree] = None,
                 peft_cfg: Optional[peft_lib.PEFTConfig] = None,
                 _shapes: Optional[Tree] = None):
        from repro_torch.distrib import tp as tp_lib
        self.cfg = cfg
        self._ops = api.family_ops(cfg)      # fails fast on unknown family
        self.device = resolve_device(device)
        self.mesh = mesh
        self.shard = tp_lib.model_shard(cfg, mesh)    # None: nothing splits
        if self.shard is not None and _shapes is not None and \
                adapters is not None:
            raise ValueError("merge adapters into the whole tree: pass it "
                             "unplaced with mesh=, not a rank's shards")
        if params is None and self.shard is None:
            params = api.init_params(cfg, seed, self.device)
        if adapters is not None and params is not None and \
                quant.is_quantized_tree(params):
            raise ValueError(
                "cannot merge adapters into already-quantized weights — "
                "merge first, then call runtime.quantized() (quantizing the "
                "merged tree keeps the rotation at full precision)")
        if (adapters is None) != (peft_cfg is None):
            raise ValueError(
                "offline merge needs BOTH adapters and peft_cfg — passing "
                "only one would silently serve the un-adapted base model")
        if adapters is not None and not adapters:
            raise ValueError(
                "empty adapter tree (target_patterns matched no weights?) — "
                "refusing a no-op merge that would silently serve the "
                "un-adapted base model")
        self._merged = adapters is not None
        if self._merged and bank is not None:
            raise ValueError(
                "pass EITHER merged adapters (adapters + peft_cfg) OR a "
                "per-request bank — merging and then rotating per "
                "request would apply adapters twice")
        if self.shard is not None and _shapes is None:
            params, _shapes = self._place(params, seed, adapters, peft_cfg)
        elif self._merged:
            params = peft_lib.materialize_tree(peft_cfg, params, adapters,
                                               merged=True)
        # the params' whole shapes (zero-storage views) for the bank and
        # adapter builders; the params themselves without a split
        self.param_shapes = params if _shapes is None else _shapes
        self.params = params
        self.bank = bank
        self.quant_cfg: Optional[quant.QuantConfig] = None   # set by quantized()
        self._slot_prefill = {}

    # -- tensor-parallel placement -------------------------------------------
    def _rules(self):
        from repro_torch.sharding.specs import ShardingRules
        return ShardingRules(self.cfg, self.mesh)

    def _place(self, params: Optional[Tree], seed: int,
               adapters: Optional[Tree], peft_cfg):
        """(local params, whole shapes): each weight drawn from ``seed``
        (``params`` None) or read from ``params``, merged with its adapter
        when ``adapters`` has one, then cut to this rank's slice before the
        next weight is touched."""
        from repro_torch.sharding import specs as shard_specs
        keep, shapes = _placer(self.cfg, self.mesh, self.device)
        rules = self._rules()
        merged = set()

        def take(path, leaf):
            if adapters is None or path not in adapters:
                return keep(path, leaf)
            merged.add(path)
            ad = adapters[path]
            if rules.expert_split(path):
                # the rank's experts with their own adapters: cut first,
                # then rotate the local stack
                local = keep(path, leaf)
                ad = shard_specs.place(
                    self.mesh, ad, rules.adapters_tree({path: ad})[path],
                    local.device)
                return peft_lib.materialize(
                    peft_lib.spec_for(peft_cfg, tuple(local.shape)), ad,
                    local)
            return keep(path, peft_lib.materialize(
                peft_lib.spec_for(peft_cfg, tuple(leaf.shape)), ad, leaf))

        if params is None:
            local = self._ops.init_params(self.cfg, seed, self.device,
                                          keep=take)
        else:
            local = peft_lib._map_paths(params, take)
        if adapters is not None and merged != set(adapters):
            raise ValueError(f"adapters for {sorted(set(adapters) - merged)} "
                             "found no weight to merge into")
        return local, shapes(local)

    @property
    def kv_heads(self) -> int:
        """The kv heads this rank's KV caches and page pools hold."""
        return (self.shard.kv_heads if self.shard is not None
                else self.cfg.num_kv_heads)

    def _tp_kw(self) -> dict:
        return {} if self.shard is None else {"tp": self.shard}

    # -- adapter bank ---------------------------------------------------------
    @property
    def banked(self) -> bool:
        return self.bank is not None

    @property
    def stateless(self) -> bool:
        """True for families with no token-level decode state (they serve
        whole inputs through ``infer_fn`` — the image family)."""
        return self._ops.stateless

    def context(self, slot_ids) -> Optional[peft_lib.AdapterContext]:
        """AdapterContext binding the bank to a batch of slot ids (None when
        this runtime serves the bare/merged model)."""
        if self.bank is None:
            return None
        return self.bank.context(slot_ids)

    def validate_adapter(self, name: Optional[str]) -> None:
        if self.bank is None:
            if name is not None:
                raise KeyError(f"runtime has no adapter bank; cannot serve "
                               f"adapter {name!r} — attach one with "
                               "ModelRuntime.attach")
            return
        self.bank.validate(name)

    def acquire_adapter(self, name: Optional[str]) -> Optional[int]:
        if self.bank is None:
            self.validate_adapter(name)
            return 0
        return self.bank.acquire(name)

    def release_adapter(self, name: Optional[str]) -> None:
        if self.bank is not None:
            self.bank.release(name)

    def attach(self, source,
               peft_cfg: Optional[peft_lib.PEFTConfigs] = None, *,
               hbm_budget: Optional[int] = None) -> "ModelRuntime":
        """New runtime over the same params serving per-request adapters
        (universal slot 0 stays the identity). ``source`` may be:

          * an ``AdapterStore``: host-offloaded adapters, LRU-paged into a
            slot-compacted device bank of ``hbm_budget`` adapters (default:
            everything resident, still compact);
          * a pre-built eager ``AdapterBank``;
          * ``{name: adapter_tree}`` + ``peft_cfg`` (one PEFTConfig or a
            ``{name: PEFTConfig}`` mapping): an eager bank, or store-paged
            when ``hbm_budget`` is given;
          * a checkpoint directory (str), opened as a disk-backed store: only
            the index is read now, each adapter's leaves on its page-in;
          * a list of ``"name=ckpt_dir"`` / ``"ckpt_dir"`` entries (the
            launcher's ``--adapters``), loaded onto this runtime's device.
        """
        from repro_torch import store as store_lib
        if self._merged:
            raise ValueError(
                "this runtime's params already contain a merged adapter; "
                "banking on top would rotate already-rotated activations — "
                "attach to the unmerged base runtime")
        if isinstance(source, (list, tuple)):
            if peft_cfg is not None:
                raise ValueError("checkpoint entries carry their own "
                                 "PEFTConfigs — do not pass peft_cfg")
            source, peft_cfg = store_lib.load_adapter_checkpoints(
                source, device=self.device)
        if isinstance(source, str):
            if peft_cfg is not None:
                raise ValueError("a checkpoint directory carries its own "
                                 "PEFTConfigs — do not pass peft_cfg")
            source = store_lib.AdapterStore.open(source)
        split = self.shard is not None
        paged_kw = dict(mesh=self.mesh, cfg=self.cfg) if split else {}
        if isinstance(source, peft_lib.AdapterBank):
            if peft_cfg is not None or hbm_budget is not None:
                raise ValueError("a pre-built AdapterBank is attached "
                                 "as-is — peft_cfg/hbm_budget do not apply")
            bank = source
            if split:
                self._place_bank(bank)
        elif isinstance(source, store_lib.AdapterStore):
            if peft_cfg is not None:
                raise ValueError("an AdapterStore carries its own "
                                 "PEFTConfigs — do not pass peft_cfg")
            bank = store_lib.PagedAdapterBank(source, self.param_shapes,
                                              hbm_budget=hbm_budget,
                                              **paged_kw)
        elif isinstance(source, Mapping):
            if peft_cfg is None:
                raise ValueError(
                    "attach({name: adapters}) needs peft_cfg — a single "
                    "PEFTConfig or a {name: PEFTConfig} mapping")
            if hbm_budget is not None:
                bank = store_lib.PagedAdapterBank(
                    store_lib.AdapterStore.from_adapters(source, peft_cfg),
                    self.param_shapes, hbm_budget=hbm_budget, **paged_kw)
            else:
                bank = peft_lib.build_adapter_bank(peft_cfg,
                                                   self.param_shapes, source)
                if split:       # commit the stacks per bank_spec_tree
                    self._place_bank(bank)
        else:
            raise TypeError(f"cannot attach {type(source).__name__}: expected "
                            "AdapterStore, AdapterBank, {name: adapters}, a "
                            "checkpoint dir, or checkpoint entries")
        if self.is_quantized:
            _check_bank_quant_compatible(bank)
        rt = ModelRuntime(self.cfg, self.params, device=self.device,
                          mesh=self.mesh, bank=bank,
                          _shapes=self._placed_shapes())
        rt.quant_cfg = self.quant_cfg   # quantize-then-bank commutes
        return rt

    def _placed_shapes(self) -> Optional[Tree]:
        """What a runtime over these (already placed) params passes on."""
        return self.param_shapes if self.shard is not None else None

    def _place_bank(self, bank) -> None:
        """An eager bank's stacks cut to this rank's part (in place; a
        stack the hook leaves whole stays shared)."""
        from repro_torch.sharding import specs as shard_specs
        if getattr(bank, "_placed", False):
            return
        bank.tree = shard_specs.place(
            self.mesh, bank.tree, self._rules().bank_spec_tree(bank.tree))
        bank._placed = True

    # -- quantized serving ----------------------------------------------------
    @property
    def is_quantized(self) -> bool:
        return self.quant_cfg is not None

    def quantized(self, mode: Optional[str] = None, *,
                  qcfg: Optional[quant.QuantConfig] = None,
                  release_source: bool = False) -> "ModelRuntime":
        """New runtime over the same model with base weights quantized for
        inference (per-output-channel symmetric int8 by default). Pass
        ``mode`` OR a full ``qcfg``; naming both only works when they agree.
        The adapter bank, when present, is carried over untouched.
        ``release_source=True`` frees each float weight once its codes
        exist (this runtime, and any sharing its params, must not serve
        afterwards): the float and int8 trees never both sit in memory
        whole."""
        if self.is_quantized:
            raise ValueError("runtime is already quantized "
                             f"(mode={self.quant_cfg.mode!r})")
        if qcfg is None:
            qcfg = quant.QuantConfig(mode=mode or "int8",
                                     use_pallas=self.cfg.use_pallas)
        elif mode is not None and qcfg.mode != mode:
            raise ValueError(
                f"quantized(mode={mode!r}) conflicts with qcfg.mode="
                f"{qcfg.mode!r} — pass one or the other")
        if self.bank is not None:
            _check_bank_quant_compatible(self.bank)
        rt = ModelRuntime(self.cfg,
                          quant.quantize_params(self.params, qcfg,
                                                release_source=release_source,
                                                amax_reduce=self._amax_reduce),
                          device=self.device, mesh=self.mesh, bank=self.bank,
                          _shapes=self._placed_shapes())
        rt._merged = self._merged
        rt.quant_cfg = qcfg
        return rt

    def _amax_reduce(self, path: str):
        """``quantize_params``' hook: a weight split along a dim its
        per-channel scale reduces over (row-parallel ``wo``) takes the max
        |w| over every rank's slice, so codes and scales equal the whole
        weight's; None for whole or column-split weights."""
        if self.shard is None:
            return None
        whole = peft_lib.flatten_paths(self.param_shapes)[path]
        spec = self._rules().serve_leaf_spec(path, whole)
        if any(ax is not None for ax in spec[:-1]):
            return self.shard.all_reduce_max
        return None

    @classmethod
    def load_quantized(cls, directory: str, cfg: ModelConfig, *,
                       qcfg: Optional[quant.QuantConfig] = None,
                       step: Optional[int] = None,
                       device: DeviceLike = "cuda",
                       mesh=None) -> "ModelRuntime":
        """Runtime from a checkpoint, served quantized, on ``device``.

        A quantized checkpoint (``CheckpointManager.save_quantized``)
        restores its codes and scales as they are under its saved
        QuantConfig (``use_pallas`` follows ``cfg`` / ``qcfg``); a plain
        float checkpoint is quantized on load with ``qcfg`` (default
        int8). With ``mesh=`` each leaf is read to the host and only this
        rank's slice of it reaches ``device`` (codes and scales by
        ``serve_leaf_spec``; a float checkpoint's slices are quantized
        after, as ``quantized`` does), so no rank holds the whole tree."""
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.distrib import tp as tp_lib
        dev = resolve_device(device)
        mgr = CheckpointManager(directory)
        if tp_lib.model_shard(cfg, mesh) is None:
            qparams, used_cfg = mgr.restore_quantized(
                cfg.weight_dtype, qcfg=qcfg, step=step,
                use_pallas=cfg.use_pallas, device=dev)
            rt = cls(cfg, qparams, device=dev, mesh=mesh)
            rt.quant_cfg = used_cfg
            return rt
        keep, shapes = _placer(cfg, mesh, dev)
        if mgr.extra(step).get("kind") != "quantized_params":
            local = mgr.restore(step=step, device="cpu", keep=keep)
            rt = cls(cfg, local, device=dev, mesh=mesh, _shapes=shapes(local))
            return rt.quantized(qcfg=qcfg or quant.QuantConfig(
                use_pallas=bool(cfg.use_pallas)), release_source=True)
        local, used_cfg = mgr.restore_quantized(
            cfg.weight_dtype, qcfg=qcfg, step=step, use_pallas=cfg.use_pallas,
            device="cpu", keep=keep)
        rt = cls(cfg, local, device=dev, mesh=mesh, _shapes=shapes(local))
        rt.quant_cfg = used_cfg
        return rt

    # -- state + step closures ------------------------------------------------
    def decode_state(self, batch: int, max_len: int, enc_len: int = 0):
        """Contiguous decode state (one max_len KV region per slot;
        ``enc_len`` rows of encoder output a slot for the encoder-decoder)."""
        if self._ops.init_decode_state is None:
            raise ValueError(
                f"family {self.cfg.family!r} is stateless — it has no "
                "decode state; serve it through infer_fn / ImageServeEngine")
        return self._ops.init_decode_state(self.cfg, batch, max_len,
                                           self.device, enc_len=enc_len,
                                           **self._tp_kw())

    def paged_state(self, batch: int, num_pages: int, page_size: int,
                    max_pages: int):
        """Paged decode state: per-layer (num_pages, page_size, K, D) pools
        shared by all slots + a (batch, max_pages + 1) int32 page table per
        slot (sentinel garbage column last)."""
        if self._ops.init_paged_state is None:
            raise ValueError(f"family {self.cfg.family!r} has no paged "
                             "KV serve path")
        return self._ops.init_paged_state(self.cfg, batch, num_pages,
                                          page_size, max_pages, self.device,
                                          **self._tp_kw())

    def paged_decode_fn(self):
        """(params, ctx, tokens, state, pos) -> (next_tok, logits, state)
        through page tables."""
        from repro_torch.train.steps import build_paged_decode_step
        return build_paged_decode_step(self.cfg, self.shard)

    def chunk_prefill_fn(self):
        """(params, req, state, slot, start) -> (first, state): one prompt
        chunk for one slot."""
        from repro_torch.train.steps import build_chunk_prefill_step
        return build_chunk_prefill_step(self.cfg, self.shard)

    def decode_fn(self):
        """(params, ctx, tokens, state, pos) -> (next_tok, logits, state)."""
        from repro_torch.train.steps import build_decode_step
        return build_decode_step(self.cfg, self.shard)

    def prefill_fn(self):
        """(params, PrefillRequest, state) -> (logits, state): a batched
        prefill, each row's logits at its own ``last_idx``."""
        from repro_torch.train.steps import build_prefill_step
        return build_prefill_step(self.cfg, self.shard)

    def infer_fn(self):
        """(params, ctx, inputs) -> logits — the STATELESS serving entry
        point (``FamilyOps.infer``): one whole-input batched forward, no KV.
        ``ctx`` is the AdapterContext the decode path takes, so per-request
        banked adapters work identically."""
        if self._ops.infer is None:
            raise ValueError(
                f"family {self.cfg.family!r} has no stateless infer entry "
                "point — serve it through prefill/decode")
        cfg, fam = self.cfg, self._ops

        @torch.inference_mode()
        def infer(params, ctx, inputs):
            return fam.infer(cfg, params, inputs, ctx=ctx)

        return infer

    def infer(self, inputs, ctx: Optional[peft_lib.AdapterContext] = None):
        return self.infer_fn()(self.params, ctx, inputs)

    def slot_prefill_fn(self, max_len: int, enc_len: int = 0):
        """(params, PrefillRequest, state, slot) -> (first, state)."""
        key = (max_len, enc_len)
        if key not in self._slot_prefill:
            from repro_torch.train.steps import build_slot_prefill_step
            self._slot_prefill[key] = build_slot_prefill_step(
                self.cfg, max_len=max_len, enc_len=enc_len,
                device=self.device, tp=self.shard)
        return self._slot_prefill[key]
