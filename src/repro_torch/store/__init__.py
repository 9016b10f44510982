"""Adapter store: host-offloaded named adapters and LRU-paged device banks
(port of ``repro.store``).

``AdapterStore`` is the host / disk residency tier ("one adapter per
customer"); ``PagedAdapterBank`` is its fixed-budget device view with
slot-compacted per-method stacks. ``ModelRuntime.attach`` takes a store
(paged), a checkpoint directory (a disk-backed store) or named adapters
(an eager bank, or paged under ``hbm_budget``) behind one API.
"""
from .paging import PagedAdapterBank, split_budget
from .store import AdapterStore, load_adapter_checkpoints

__all__ = ["AdapterStore", "PagedAdapterBank", "load_adapter_checkpoints",
           "split_budget"]
