"""Family-dispatched model API — a thin lookup over the family registry
(port of ``repro/models/api.py``)."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike
from . import image, registry, transformer  # noqa: F401  (registers FamilyOps)


def family_ops(cfg: ModelConfig) -> registry.FamilyOps:
    """The FamilyOps record for ``cfg.family`` (KeyError on unknown family)."""
    return registry.get(cfg.family)


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda"):
    return family_ops(cfg).init_params(cfg, seed, device)



def forward(cfg: ModelConfig, params, batch):
    return family_ops(cfg).forward(cfg, params, batch)


def loss_fn(cfg: ModelConfig, params, batch, tp=None):
    """(loss, metrics) of the family's training objective; ``tp`` the
    rank's ``distrib.tp.TPShard`` of a split model (the families that
    split take it)."""
    kw = {} if tp is None else {"tp": tp}
    return family_ops(cfg).loss(cfg, params, batch, **kw)
