"""ModelRuntime — the serving entry point (port of ``repro/core/runtime.py``).

Binds ``ModelConfig + params + optional AdapterBank`` on one device.
``adapters`` + ``peft_cfg`` merge ONE adapter into the weights offline (the
paper's zero-overhead serving mode, §6.1, through the forward GS kernel);
``attach({name: adapters}, peft_cfg)`` serves per-request adapters from an
eager bank, activation-side (GSOFT through the transpose GS kernel, OFT and
BOFT through the banked bdmm kernel, Householder and Givens in plain
torch); ``peft_cfg`` is one PEFTConfig or a ``{name: PEFTConfig}`` mapping
for a mixed-method bank. Merging and banking are mutually exclusive.

Sources this slice does not port raise NotImplementedError naming the
slice they wait for: adapter stores and checkpoints (the store slice),
meshes (the scale-out slice), quantized weights (the int8 slice).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from repro_torch.config import ModelConfig
from repro_torch.core import peft as peft_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api

Tree = Any


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
        self._slot_prefill = {}

    # -- adapter bank ---------------------------------------------------------
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
        (slot 0 stays the identity). ``source`` is ``{name: adapter_tree}``
        with ``peft_cfg`` — one PEFTConfig, or ``{name: PEFTConfig}`` for a
        mixed-method bank — (eager bank) or a pre-built ``AdapterBank``.
        ``hbm_budget`` (a store-paged bank) waits for the store slice."""
        if hbm_budget is not None:
            raise NotImplementedError(
                "hbm_budget (a store-paged adapter bank) is not ported yet "
                "(store slice)")
        if self._merged:
            raise ValueError(
                "this runtime's params already contain a merged adapter; "
                "banking on top would rotate already-rotated activations — "
                "attach to the unmerged base runtime")
        if isinstance(source, peft_lib.AdapterBank):
            if peft_cfg is not None:
                raise ValueError("a pre-built AdapterBank is attached as-is "
                                 "— peft_cfg does not apply")
            bank = source
        elif isinstance(source, Mapping):
            if peft_cfg is None:
                raise ValueError("attach({name: adapters}) needs peft_cfg")
            bank = peft_lib.build_adapter_bank(peft_cfg, self.params, source)
        elif isinstance(source, (str, list, tuple)):
            raise NotImplementedError(
                "attaching checkpoints is not ported yet (store slice)")
        else:
            raise NotImplementedError(
                f"attaching {type(source).__name__} is not ported yet; the "
                "adapter store arrives with the store slice")
        return ModelRuntime(self.cfg, self.params, device=self.device,
                            bank=bank)

    def quantized(self, mode: Optional[str] = None, **kw) -> "ModelRuntime":
        raise NotImplementedError(
            "quantized serving is not ported yet (int8 slice)")

    # -- state + step closures ------------------------------------------------
    def decode_state(self, batch: int, max_len: int):
        """Contiguous decode state (one max_len KV region per slot)."""
        return self._ops.init_decode_state(self.cfg, batch, max_len,
                                           self.device)

    def decode_fn(self):
        """(params, ctx, tokens, state, pos) -> (next_tok, logits, state)."""
        from repro_torch.train.steps import build_decode_step
        return build_decode_step(self.cfg)

    def slot_prefill_fn(self, max_len: int):
        """(params, PrefillRequest, state, slot) -> (first, state)."""
        if max_len not in self._slot_prefill:
            from repro_torch.train.steps import build_slot_prefill_step
            self._slot_prefill[max_len] = build_slot_prefill_step(
                self.cfg, max_len=max_len, device=self.device)
        return self._slot_prefill[max_len]
