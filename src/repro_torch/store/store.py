"""AdapterStore: host-offloaded residency for many named adapters (port of
``repro/store/store.py``).

An eager bank pre-processes and stacks every named adapter into device
memory up front, and a mixed-method bank holds identity factors at every
other method's slots. The store splits residency into tiers:

  host RAM   — RAW adapter param trees as CPU tensors (this module); cheap,
               effectively unbounded ("one adapter per customer")
  disk       — optional backing via the checkpoint manager's per-name
               method+spec index (``AdapterStore.open``): only the index
               is read up front, each adapter's leaves load on first use
  device     — a fixed-budget ``PagedAdapterBank`` (``store/paging.py``)
               that pages adapters in on admission with LRU eviction

Capability checks run at INSERT time: ``add`` applies the same
``core.peft.check_bank_member`` rule as an eager bank build, so a method
with no bank path (lora, double_gsoft) or a mismatched config is rejected
when the adapter enters the store — naming the method and the reason —
never at first admission mid-traffic.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch

from repro_torch.core import peft as peft_lib

Tree = Dict[str, Dict[str, torch.Tensor]]    # {weight_path: {param: tensor}}


def _host_tree(adapters: Tree) -> Tree:
    """One adapter's params as CPU tensors (the store is the off-device
    tier)."""
    return {path: {k: v.detach().to("cpu") for k, v in entry.items()}
            for path, entry in adapters.items()}


class AdapterStore:
    """Named adapters living in host RAM (optionally disk-backed), plus
    the config bookkeeping a paged bank needs: one canonical PEFTConfig
    per method, bank-wide target/kernel knobs from the first insert."""

    def __init__(self, cfg: Optional[peft_lib.PEFTConfig] = None):
        # name -> PEFTConfig; insertion-ordered (stable demo/bench traffic)
        self._cfgs: Dict[str, peft_lib.PEFTConfig] = {}
        self._host: Dict[str, Tree] = {}
        self._cfg_of_method: Dict[str, peft_lib.PEFTConfig] = {}
        self._primary = cfg                      # set by first add() if None
        if cfg is not None:
            peft_lib.bank_capability_check(None, cfg)
        self._manager = None                     # checkpoint backing (open)
        self._ckpt_step: Optional[int] = None

    # -- introspection -------------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._cfgs)

    @property
    def primary_cfg(self) -> peft_lib.PEFTConfig:
        if self._primary is None:
            raise ValueError(
                "empty AdapterStore has no PEFTConfig — add an adapter, or "
                "construct AdapterStore(cfg=...) for an identity-only store")
        return self._primary

    def __contains__(self, name: str) -> bool:
        return name in self._cfgs

    def __len__(self) -> int:
        return len(self._cfgs)

    def __iter__(self) -> Iterator[str]:
        return iter(self._cfgs)

    def cfg_for(self, name: str) -> peft_lib.PEFTConfig:
        if name not in self._cfgs:
            raise KeyError(f"store has no adapter {name!r}; it holds "
                           f"{sorted(self._cfgs)}")
        return self._cfgs[name]

    def method_of(self, name: str) -> str:
        return self.cfg_for(name).method

    def cfg_of_method(self, method: str) -> peft_lib.PEFTConfig:
        return self._cfg_of_method[method]

    def method_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for c in self._cfgs.values():
            counts[c.method] = counts.get(c.method, 0) + 1
        return counts

    # -- mutation ------------------------------------------------------------
    def add(self, name: str, adapters: Tree,
            peft_cfg: peft_lib.PEFTConfig) -> None:
        """Insert a named RAW adapter tree (as from ``init_peft``).

        All bank-membership rules run HERE: a ``bank_build=None`` method
        (lora / double_gsoft), ``use_scale``, mismatched target patterns /
        kernel path, or a same-method config fork all raise at insert time
        with the method named — the paged bank can then assume every store
        entry is admissible and page under traffic without surprises."""
        if name == peft_lib.BASE_ADAPTER:
            raise ValueError(f"{name!r} is the reserved identity slot")
        if name in self._cfgs:
            raise ValueError(f"store already holds adapter {name!r} — "
                             "remove() it first to replace")
        primary = self._primary if self._primary is not None else peft_cfg
        trial = dict(self._cfg_of_method)
        peft_lib.check_bank_member(name, peft_cfg, primary, trial)
        self._cfg_of_method = trial
        self._primary = primary
        self._cfgs[name] = peft_cfg
        self._host[name] = _host_tree(adapters)

    def remove(self, name: str) -> None:
        self.cfg_for(name)                       # KeyError listing names
        del self._cfgs[name]
        self._host.pop(name, None)
        counts = self.method_counts()
        self._cfg_of_method = {m: c for m, c in self._cfg_of_method.items()
                               if m in counts}

    def adapters_for(self, name: str) -> Tree:
        """The raw host param tree for one adapter; disk-backed entries
        load lazily on first use and stay cached in host RAM."""
        self.cfg_for(name)
        if name not in self._host:               # disk-backed (open())
            self._host[name] = self._manager.load_adapter(
                name, step=self._ckpt_step, device="cpu")
        return self._host[name]

    # -- persistence ---------------------------------------------------------
    def save(self, directory: str, step: int = 0) -> None:
        """Persist the store as an adapter-bank checkpoint (the same
        per-name method+spec index ``save_adapters`` has always written —
        old checkpoints open as stores and vice versa)."""
        from repro_torch.checkpoint.manager import CheckpointManager
        CheckpointManager(directory).save_adapters(
            step, {name: self.adapters_for(name) for name in self._cfgs},
            dict(self._cfgs) if self._cfgs else self.primary_cfg)

    @classmethod
    def open(cls, directory: str,
             step: Optional[int] = None) -> "AdapterStore":
        """Disk-backed store over an adapter-bank checkpoint: reads ONLY
        the index (names + per-name method/spec); adapter leaves load on
        first ``adapters_for``/page-in."""
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(directory)
        names, cfgs, _ = mgr.adapter_index(step=step)
        store = cls()
        store._manager = mgr
        store._ckpt_step = step
        for name in names:
            cfg = cfgs[name]
            primary = store._primary if store._primary is not None else cfg
            peft_lib.check_bank_member(name, cfg, primary,
                                       store._cfg_of_method)
            store._primary = primary
            store._cfgs[name] = cfg
        return store

    @classmethod
    def from_adapters(cls, adapters_by_name: Mapping[str, Tree],
                      peft_cfg: "peft_lib.PEFTConfigs") -> "AdapterStore":
        """Store from in-memory named adapters + a single PEFTConfig or a
        {name: PEFTConfig} mapping (``attach``'s argument pair)."""
        primary, cfg_by_name = peft_lib.normalize_bank_cfgs(
            adapters_by_name, peft_cfg)
        store = cls(cfg=primary)
        for name, tree in adapters_by_name.items():
            store.add(name, tree, cfg_by_name[name])
        return store


def load_adapter_checkpoints(entries, device="cuda"
                             ) -> Tuple[Dict[str, Tree],
                                        "peft_lib.PEFTConfigs"]:
    """``entries``: ["name=ckpt_dir" | "ckpt_dir"] -> (adapters_by_name,
    cfg), the adapters on ``device``, where ``cfg`` is a single PEFTConfig
    (homogeneous) or a {name: PEFTConfig} mapping — what ``ModelRuntime.attach``
    accepts. A bare dir loads every adapter in that checkpoint;
    ``name=dir`` picks one. An entry that IS an existing directory is
    always treated as bare, so checkpoint paths containing ``=`` are not
    misparsed."""
    import os

    from repro_torch.checkpoint.manager import CheckpointManager
    adapters_by_name: Dict[str, Tree] = {}
    cfg_by_name: Dict[str, peft_lib.PEFTConfig] = {}
    for entry in entries:
        if os.path.isdir(entry) or "=" not in entry:
            name, path = "", entry
        else:
            # split at the FIRST '=': adapter names never contain '=',
            # checkpoint paths may
            name, _, path = entry.partition("=")
        loaded, cfgs = CheckpointManager(path).restore_adapters(
            device=device)
        if name:          # name=dir form: pick one adapter out of the bank
            if name not in loaded:
                raise KeyError(f"{path} has adapters {list(loaded)}, "
                               f"not {name!r}")
            loaded = {name: loaded[name]}
        for n in loaded:
            prev = cfg_by_name.get(n)
            if prev is not None and prev != cfgs[n]:
                raise ValueError(f"adapter {n!r} ({entry}): PEFTConfig "
                                 f"mismatch ({cfgs[n]} != {prev})")
            cfg_by_name[n] = cfgs[n]
        adapters_by_name.update(loaded)
    if not cfg_by_name:
        raise ValueError("no adapter checkpoints given")
    if len(set(cfg_by_name.values())) == 1:       # frozen -> hashable
        return adapters_by_name, next(iter(cfg_by_name.values()))
    return adapters_by_name, cfg_by_name
