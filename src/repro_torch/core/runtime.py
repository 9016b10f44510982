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

Meshes raise NotImplementedError (the scale-out slice).
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


class ModelRuntime:
    """``ModelRuntime(cfg)`` initializes params from ``seed`` on ``device``
    (default the card); pass ``params=`` to reuse a tree already there."""

    def __init__(self, cfg: ModelConfig, params: Optional[Tree] = None, *,
                 seed: int = 0, device: DeviceLike = "cuda", mesh=None,
                 bank: Optional[peft_lib.AdapterBank] = None,
                 adapters: Optional[Tree] = None,
                 peft_cfg: Optional[peft_lib.PEFTConfig] = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded runtimes are not ported yet (scale-out slice)")
        self.cfg = cfg
        self._ops = api.family_ops(cfg)      # fails fast on unknown family
        self.device = resolve_device(device)
        if params is None:
            params = api.init_params(cfg, seed, self.device)
        if adapters is not None and quant.is_quantized_tree(params):
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
        if self._merged:
            if bank is not None:
                raise ValueError(
                    "pass EITHER merged adapters (adapters + peft_cfg) OR a "
                    "per-request bank — merging and then rotating per "
                    "request would apply adapters twice")
            params = peft_lib.materialize_tree(peft_cfg, params, adapters,
                                               merged=True)
        self.params = params
        self.bank = bank
        self.quant_cfg: Optional[quant.QuantConfig] = None   # set by quantized()
        self._slot_prefill = {}

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
        if isinstance(source, peft_lib.AdapterBank):
            if peft_cfg is not None or hbm_budget is not None:
                raise ValueError("a pre-built AdapterBank is attached "
                                 "as-is — peft_cfg/hbm_budget do not apply")
            bank = source
        elif isinstance(source, store_lib.AdapterStore):
            if peft_cfg is not None:
                raise ValueError("an AdapterStore carries its own "
                                 "PEFTConfigs — do not pass peft_cfg")
            bank = store_lib.PagedAdapterBank(source, self.params,
                                              hbm_budget=hbm_budget)
        elif isinstance(source, Mapping):
            if peft_cfg is None:
                raise ValueError(
                    "attach({name: adapters}) needs peft_cfg — a single "
                    "PEFTConfig or a {name: PEFTConfig} mapping")
            if hbm_budget is not None:
                bank = store_lib.PagedAdapterBank(
                    store_lib.AdapterStore.from_adapters(source, peft_cfg),
                    self.params, hbm_budget=hbm_budget)
            else:
                bank = peft_lib.build_adapter_bank(peft_cfg, self.params,
                                                   source)
        else:
            raise TypeError(f"cannot attach {type(source).__name__}: expected "
                            "AdapterStore, AdapterBank, {name: adapters}, a "
                            "checkpoint dir, or checkpoint entries")
        if self.is_quantized:
            _check_bank_quant_compatible(bank)
        rt = ModelRuntime(self.cfg, self.params, device=self.device,
                          bank=bank)
        rt.quant_cfg = self.quant_cfg   # quantize-then-bank commutes
        return rt

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
                                                release_source=release_source),
                          device=self.device, bank=self.bank)
        rt._merged = self._merged
        rt.quant_cfg = qcfg
        return rt

    @classmethod
    def load_quantized(cls, directory: str, cfg: ModelConfig, *,
                       qcfg: Optional[quant.QuantConfig] = None,
                       step: Optional[int] = None,
                       device: DeviceLike = "cuda") -> "ModelRuntime":
        """Runtime from a checkpoint, served quantized, on ``device``.

        A quantized checkpoint (``CheckpointManager.save_quantized``)
        restores its codes and scales as they are under its saved
        QuantConfig (``use_pallas`` follows ``cfg`` / ``qcfg``); a plain
        float checkpoint is quantized on load with ``qcfg`` (default
        int8)."""
        from repro_torch.checkpoint.manager import CheckpointManager
        dev = resolve_device(device)
        qparams, used_cfg = CheckpointManager(directory).restore_quantized(
            cfg.weight_dtype, qcfg=qcfg, step=step,
            use_pallas=cfg.use_pallas, device=dev)
        rt = cls(cfg, qparams, device=dev)
        rt.quant_cfg = used_cfg
        return rt

    # -- state + step closures ------------------------------------------------
    def decode_state(self, batch: int, max_len: int):
        """Contiguous decode state (one max_len KV region per slot)."""
        if self._ops.init_decode_state is None:
            raise ValueError(
                f"family {self.cfg.family!r} is stateless — it has no "
                "decode state; serve it through infer_fn / ImageServeEngine")
        return self._ops.init_decode_state(self.cfg, batch, max_len,
                                           self.device)

    def paged_state(self, batch: int, num_pages: int, page_size: int,
                    max_pages: int):
        """Paged decode state: per-layer (num_pages, page_size, K, D) pools
        shared by all slots + a (batch, max_pages + 1) int32 page table per
        slot (sentinel garbage column last)."""
        if self._ops.init_paged_state is None:
            raise ValueError(f"family {self.cfg.family!r} has no paged "
                             "KV serve path")
        return self._ops.init_paged_state(self.cfg, batch, num_pages,
                                          page_size, max_pages, self.device)

    def paged_decode_fn(self):
        """(params, ctx, tokens, state, pos) -> (next_tok, logits, state)
        through page tables."""
        from repro_torch.train.steps import build_paged_decode_step
        return build_paged_decode_step(self.cfg)

    def chunk_prefill_fn(self):
        """(params, req, state, slot, start) -> (first, state): one prompt
        chunk for one slot."""
        from repro_torch.train.steps import build_chunk_prefill_step
        return build_chunk_prefill_step(self.cfg)

    def decode_fn(self):
        """(params, ctx, tokens, state, pos) -> (next_tok, logits, state)."""
        from repro_torch.train.steps import build_decode_step
        return build_decode_step(self.cfg)

    def prefill_fn(self):
        """(params, PrefillRequest, state) -> (logits, state): a batched
        prefill, each row's logits at its own ``last_idx``."""
        from repro_torch.train.steps import build_prefill_step
        return build_prefill_step(self.cfg)

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

    def slot_prefill_fn(self, max_len: int):
        """(params, PrefillRequest, state, slot) -> (first, state)."""
        if max_len not in self._slot_prefill:
            from repro_torch.train.steps import build_slot_prefill_step
            self._slot_prefill[max_len] = build_slot_prefill_step(
                self.cfg, max_len=max_len, device=self.device)
        return self._slot_prefill[max_len]
