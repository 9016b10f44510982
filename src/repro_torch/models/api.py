"""Family-dispatched model API — a thin lookup over the family registry
(port of ``repro/models/api.py``)."""
from __future__ import annotations

import math

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike
from . import encdec, image, registry, transformer  # noqa: F401  (register)


def family_ops(cfg: ModelConfig) -> registry.FamilyOps:
    """The FamilyOps record for ``cfg.family`` (KeyError on unknown family)."""
    return registry.get(cfg.family)


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda"):
    return family_ops(cfg).init_params(cfg, seed, device)


def abstract_params(cfg: ModelConfig):
    """The params' tree on the meta device: shapes and dtypes, no memory
    and no draws (JAX's ``jax.eval_shape`` of ``init_params``)."""
    return family_ops(cfg).init_params(cfg, 0, "meta")


def forward(cfg: ModelConfig, params, batch):
    return family_ops(cfg).forward(cfg, params, batch)


def loss_fn(cfg: ModelConfig, params, batch, tp=None):
    """(loss, metrics) of the family's training objective; ``tp`` the
    rank's ``distrib.tp.TPShard`` of a split model (the families that
    split take it)."""
    kw = {} if tp is None else {"tp": tp}
    return family_ops(cfg).loss(cfg, params, batch, **kw)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int = 0, device: DeviceLike = "cuda"):
    """The family's decode state for ``batch`` rows of ``max_len``
    positions (``enc_len``: the encoder output's rows, encdec only)."""
    return family_ops(cfg).init_decode_state(cfg, batch, max_len, device,
                                             enc_len=enc_len)


def abstract_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                          enc_len: int = 0):
    """The decode state on the meta device: shapes only (JAX's
    ``abstract_decode_state``)."""
    return init_decode_state(cfg, batch, max_len, enc_len, "meta")


def param_count(cfg: ModelConfig) -> int:
    from repro_torch.core.peft import flatten_paths
    return sum(int(math.prod(leaf.shape))
               for leaf in flatten_paths(abstract_params(cfg)).values())


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token runs through: an MoE config counts top-k of its
    experts (``repro.models.transformer.active_param_count``); every dense
    family, the encoder-decoder included, all of them."""
    total = param_count(cfg)
    if not cfg.is_moe:
        return total
    from repro_torch.core.peft import flatten_paths
    expert = sum(int(math.prod(leaf.shape)) for path, leaf in
                 flatten_paths(abstract_params(cfg)).items()
                 if "/moe/w" in path)
    return total - expert + expert * cfg.moe_top_k // cfg.moe_experts
