"""Family registry (port of ``repro/models/registry.py``): each model family
registers a ``FamilyOps`` record; ``models.api`` and ``ModelRuntime``
dispatch on ``ModelConfig.family``. ``models/transformer.py`` registers
``decoder``, ``ssm`` (mamba2), ``hybrid`` (zamba2) and ``vlm`` (pixtral);
``models/encdec.py`` registers ``encdec`` (seamless-m4t);
``models/image.py`` registers ``image``. This module is the only place
family strings are compared: call sites branch on the record's traits, as
in the JAX package:

* ``mixer`` — "attention" | "ssm" | "hybrid" | "none": the sequence mixer
  the stack runs (hybrid: Mamba2 layers with a shared attention block
  between super-blocks; none: the stateless image family).
* ``has_patches`` / ``has_encoder`` — the vlm's patch stream (batch
  "patches" (B, P, frontend_dim), prepended to the text: the engines count
  P in every position) and the encoder-decoder's frames (batch "frames"
  (B, F, d_model), encoded once a prefill).
* ``stateless`` (property) — no token-level decode state: the family
  serves whole inputs through ``infer`` and ``ImageServeEngine``; the
  token engines refuse it.

Uniform signatures:

* ``init_params(cfg, seed=0, device="cuda") -> params``
* ``forward(cfg, params, batch) -> (logits, aux)``
* ``loss(cfg, params, batch) -> (loss, metrics)``

Token-decode surface (None -> the family is stateless):

* ``init_decode_state(cfg, batch, max_len, device="cuda", enc_len=0)
  -> state`` (``enc_len``: the encoder output's length a row; only the
  encoder-decoder reads it)
* ``prefill(cfg, params, req: PrefillRequest, state) -> (last_logits, state)``
* ``decode_step(cfg, params, tokens, state, pos, ctx=None) -> (logits, state)``

Stateless-inference surface (required iff the decode surface is absent):

* ``infer(cfg, params, inputs, ctx=None) -> logits`` — one whole-input
  batched forward; ``ctx`` is the AdapterContext the decode path takes.

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
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class FamilyOps:
    family: str
    init_params: Callable
    forward: Callable
    loss: Callable
    init_decode_state: Optional[Callable] = None
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    infer: Optional[Callable] = None
    init_paged_state: Optional[Callable] = None
    paged_decode_step: Optional[Callable] = None
    paged_chunk_prefill: Optional[Callable] = None
    mixer: str = "attention"
    has_patches: bool = False
    has_encoder: bool = False

    @property
    def stateless(self) -> bool:
        """No token-level decode state: serve through ``infer``."""
        return self.init_decode_state is None

    def __post_init__(self):
        if self.mixer not in ("attention", "ssm", "hybrid", "none"):
            raise ValueError(f"family {self.family!r}: unknown mixer "
                             f"{self.mixer!r}")
        if self.init_decode_state is None and self.infer is None:
            raise ValueError(
                f"family {self.family!r} registers neither a decode "
                f"surface nor a stateless ``infer`` entry point")


_FAMILIES: Dict[str, FamilyOps] = {}


def register(ops: FamilyOps) -> FamilyOps:
    _FAMILIES[ops.family] = ops
    return ops


def get(family: str) -> FamilyOps:
    if family not in _FAMILIES:
        raise KeyError(f"unknown model family {family!r}; registered "
                       f"families: {sorted(_FAMILIES)}")
    return _FAMILIES[family]


def families() -> List[str]:
    return sorted(_FAMILIES)


def is_family(cfg, family: str) -> bool:
    """Registry-owned label check (the launcher's --family assertion):
    call sites do not compare ``cfg.family`` strings themselves."""
    return cfg.family == family
