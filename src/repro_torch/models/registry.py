"""Family registry (port of ``repro/models/registry.py``): each model family
registers a ``FamilyOps`` record; ``models.api`` and ``ModelRuntime``
dispatch on ``ModelConfig.family``. ``models/transformer.py`` registers
``decoder``, ``ssm`` (mamba2) and ``hybrid`` (zamba2). This module is the
only place family strings are compared: call sites branch on the record's
traits, as in the JAX package:

* ``mixer`` — "attention" | "ssm" | "hybrid": the sequence mixer the stack
  runs (hybrid: Mamba2 layers with a shared attention block between
  super-blocks).

Uniform signatures:

* ``init_params(cfg, seed=0, device="cuda") -> params``
* ``forward(cfg, params, batch) -> (logits, aux)``
* ``loss(cfg, params, batch) -> (loss, metrics)``
* ``init_decode_state(cfg, batch, max_len, device="cuda") -> state``
* ``prefill(cfg, params, req: PrefillRequest, state) -> (last_logits, state)``
* ``decode_step(cfg, params, tokens, state, pos, ctx=None) -> (logits, state)``

Optional paged-KV surface (None -> the family has no paged serve path and
``PagedServeEngine`` refuses it):

* ``init_paged_state(cfg, batch, num_pages, page_size, max_pages,
  device="cuda") -> {"pages", "table"}`` (table width max_pages + 1, the
  sentinel garbage column last)
* ``paged_chunk_prefill(cfg, params, req, state, slot, start)
  -> (logits, state)`` — one prompt chunk, one slot
* ``paged_decode_step(cfg, params, tokens, state, pos, ctx=None)
  -> (logits, state)`` — full-batch decode through the tables
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class FamilyOps:
    family: str
    init_params: Callable
    forward: Callable
    loss: Callable
    init_decode_state: Callable
    prefill: Callable
    decode_step: Callable
    init_paged_state: Optional[Callable] = None
    paged_decode_step: Optional[Callable] = None
    paged_chunk_prefill: Optional[Callable] = None
    mixer: str = "attention"

    def __post_init__(self):
        if self.mixer not in ("attention", "ssm", "hybrid"):
            raise ValueError(f"family {self.family!r}: unknown mixer "
                             f"{self.mixer!r}")


_FAMILIES: Dict[str, FamilyOps] = {}


def register(ops: FamilyOps) -> FamilyOps:
    _FAMILIES[ops.family] = ops
    return ops


def get(family: str) -> FamilyOps:
    if family not in _FAMILIES:
        raise KeyError(f"unknown model family {family!r}; registered "
                       f"families: {sorted(_FAMILIES)}")
    return _FAMILIES[family]


def is_family(cfg, family: str) -> bool:
    """Registry-owned label check (the launcher's --family assertion):
    call sites do not compare ``cfg.family`` strings themselves."""
    return cfg.family == family
