"""PagedAdapterBank: a fixed device-memory budget over AdapterStore pages
(port of ``repro/store/paging.py``).

An eager ``AdapterBank`` builds every adapter into device memory and pads
each method's stack with identities at every other method's slots, so
resident bytes scale with N_adapters x N_methods. This bank fixes both:

  slot compaction   Each method's stack holds only its own members:
                    ``(batch..., c_m + 1, ...)`` where ``c_m`` is that
                    method's share of the budget and compact slot 0 is the
                    method's identity. Universal slot ids (0 = base,
                    1..capacity) stay what the engines see; a host table per
                    method maps universal slot -> compact slot (0 where the
                    slot's adapter uses another method), and ``context()``
                    resolves it into ``{method: (B,) compact ids}``, the ids
                    the kernels receive (the GSOFT stacks are read by slot
                    id in ``gs_fused_T_bank`` / ``gs_q_matmul_bank``).

  LRU paging        Adapters page in at admission: factors come from the
                    host page cache (an evict -> re-admit round trip never
                    rebuilds) or are built on the spot by
                    ``MethodOps.bank_build`` from the store's raw params,
                    then copied in place (``copy_``) into the method's stack
                    at the claimed compact slot. Victims are the least
                    recently admitted unpinned members of the same method;
                    active requests pin their adapter, so ``acquire``
                    returns None (an admission stall) rather than evict a
                    page a slot is still decoding with.

Stack shapes are fixed when the bank is built and page-in rewrites their
contents in place, so every context built afterwards reads the new tenant;
on a mesh (``mesh=``, the runtime's) the stacks hold this rank's part per
``ShardingRules.bank_spec_tree`` and a page-in writes that part of the
page;
``version`` is bumped on every page-in and eviction, and the engines key
their cached context on it. The per-method capacities are static: a hot
method cannot borrow a cold one's slots.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import methods as methods_lib
from repro_torch.core import peft as peft_lib
from repro_torch.obs.metrics import REGISTRY

from .store import AdapterStore

Tree = Any

#: reservoir size for the page-in latency histogram (bounded: constant
#: memory under any churn, p50 / p95 over the newest samples)
PAGE_IN_HIST_CAP = 1024


def split_budget(budget: int, counts: Dict[str, int]) -> Dict[str, int]:
    """Per-method compact capacities: proportional to store population,
    at least 1 each, never more than the method has members. Deterministic
    (ties break on method name)."""
    methods = sorted(counts)
    if not methods:
        return {}
    if budget < len(methods):
        raise ValueError(
            f"hbm_budget={budget} cannot hold one adapter per method — the "
            f"store mixes {len(methods)} methods ({methods})")
    caps = {m: 1 for m in methods}
    remaining = budget - len(methods)
    while remaining > 0:
        # most under-served method relative to its population, name-tied
        open_m = [m for m in methods if caps[m] < counts[m]]
        if not open_m:
            break
        pick = max(open_m, key=lambda m: (counts[m] / caps[m], m))
        caps[pick] += 1
        remaining -= 1
    return caps


class PagedAdapterBank:
    """LRU-paged, slot-compacted device bank over an ``AdapterStore``, on
    the device of ``params``.

    Duck-types the ``AdapterBank`` serving surface (``context`` /
    ``validate`` / ``acquire`` / ``release`` / ``bank_methods`` / ``cfg``)
    so ``ModelRuntime`` and ``ServeEngine`` drive either interchangeably.
    """

    def __init__(self, store: AdapterStore, params: Tree, *,
                 hbm_budget: Optional[int] = None, mesh=None, cfg=None):
        self.store = store
        counts = store.method_counts()
        if hbm_budget is None:
            hbm_budget = max(len(store), 1)     # everything fits; still compact
        self.caps = split_budget(hbm_budget, counts)
        self.capacity = sum(self.caps.values())     # universal slots 1..cap
        self._methods: Tuple[str, ...] = tuple(sorted(self.caps))
        self.cfg = store.primary_cfg
        self.device = peft_lib._tree_device(params)
        self._specs = peft_lib.bank_specs(self.cfg, params)

        # device stacks: {path: {method: {factor: (batch.., c_m+1, ...)}}},
        # nested into self.tree; page-in writes their contents in place
        self._stacks: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
        self.tree: Dict[str, Any] = {}
        # per-path A-axis index: the slot axis sits after any scan-stacked
        # weight batch dims, which differ per weight, not per method
        self._axis: Dict[str, int] = {}
        for path, spec in sorted(self._specs.items()):
            shape = tuple(spec.batch) + (spec.d_in, spec.d_out)
            self._axis[path] = len(spec.batch)
            entry: Dict[str, Dict[str, torch.Tensor]] = {}
            for m in self._methods:
                mspec = peft_lib.spec_for(store.cfg_of_method(m), shape)
                entry[m] = {k: v.contiguous() for k, v in
                            methods_lib.get(m).bank_build(
                                mspec, [None] * (self.caps[m] + 1),
                                self.device).items()}      # all-identity
            self._stacks[path] = entry
            peft_lib._nest_insert(self.tree, path, entry)
        # per-leaf specs of this rank's part (None: every rank holds all)
        self._mesh = mesh
        self._spec: Optional[Dict[str, Dict[str, Dict[str, tuple]]]] = None
        if mesh is not None:
            from repro_torch.sharding import specs as shard_specs
            spec_tree = shard_specs.ShardingRules(
                cfg, mesh).bank_spec_tree(self._stacks)
            self._stacks = shard_specs.place(mesh, self._stacks, spec_tree)
            self._spec = spec_tree
            self.tree = {}
            for path, entry in self._stacks.items():
                peft_lib._nest_insert(self.tree, path, entry)

        # host indirection: universal slot -> compact slot, per method
        self._lut: Dict[str, np.ndarray] = {
            m: np.zeros(self.capacity + 1, np.int32) for m in self._methods}
        # residency: name -> (universal slot, method, compact slot)
        self._resident: Dict[str, Tuple[int, str, int]] = {}
        self._lru: Dict[str, None] = {}             # insertion-ordered
        self._pins: Dict[str, int] = {}
        self._free_universal: List[int] = list(range(self.capacity, 0, -1))
        self._free_compact: Dict[str, List[int]] = {
            m: list(range(self.caps[m], 0, -1)) for m in self._methods}
        # built factor pages in host memory: evict -> re-admit skips
        # bank_build
        self._page_cache: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
        # instruments in the process metrics plane; `counters` (property)
        # and `stats()` are views. page_in_ms is a BOUNDED histogram now.
        scope = REGISTRY.scope("bank")
        self._c = scope.counters("hits", "misses", "evictions", "stalls",
                                 "builds", "build_cache_hits")
        self._page_in_ms = scope.histogram("page_in_ms",
                                           cap=PAGE_IN_HIST_CAP)
        self._max_resident = scope.gauge("max_resident")
        # bumped on every residency change (page-in / evict): engines key
        # their per-step AdapterContext cache on (slot ids, version), so a
        # context built over stale stacks can never serve a decode step
        self.version = 0

    # -- AdapterBank surface --------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        """Every servable name (host tier), identity first — residency is
        an implementation detail of the fixed device budget."""
        return (peft_lib.BASE_ADAPTER,) + self.store.names

    @property
    def num_slots(self) -> int:
        return self.capacity + 1

    @property
    def bank_methods(self) -> Tuple[str, ...]:
        return self._methods

    @property
    def resident(self) -> Tuple[str, ...]:
        return tuple(self._resident)

    def is_resident(self, name: str) -> bool:
        """Is this adapter's factor set paged into device memory now? The
        cluster router's affinity probe."""
        return name in self._resident

    def cfg_for(self, name: str) -> peft_lib.PEFTConfig:
        return self.store.cfg_for(name)

    def _unknown(self, name: str) -> KeyError:
        return KeyError(
            f"unknown adapter {name!r}; resident: "
            f"{sorted(self._resident)}; host store holds "
            f"{sorted(self.store.names)}")

    def validate(self, name: Optional[str]) -> None:
        """Raise KeyError (listing resident AND host-side names) unless
        ``name`` is servable. Does not touch residency."""
        if name is not None and name not in self.store:
            raise self._unknown(name)

    def slot(self, name: Optional[str]) -> int:
        """Universal slot of a RESIDENT adapter (None -> 0). Unlike the
        eager bank this can miss for a known name — admission goes through
        ``acquire``, which pages in."""
        if name is None:
            return 0
        rec = self._resident.get(name)
        if rec is None:
            if name in self.store:
                raise KeyError(
                    f"adapter {name!r} is in the store but not resident — "
                    "admission must go through acquire(), which pages it in")
            raise self._unknown(name)
        return rec[0]

    def context(self, slot_ids) -> peft_lib.AdapterContext:
        """Per-request context from UNIVERSAL slot ids: the host tables
        resolve them into per-method compact ids, which the rotations read
        their stacks with."""
        ids = np.asarray(slot_ids, np.int64)
        slots = {m: torch.as_tensor(self._lut[m][ids], dtype=torch.int64,
                                    device=self.device)
                 for m in self._methods}
        return peft_lib.AdapterContext(bank=self.tree, slots=slots)

    # -- residency ------------------------------------------------------------
    def acquire(self, name: Optional[str]) -> Optional[int]:
        """Admission: pin ``name`` and return its universal slot, paging
        it in first on a miss. Returns None when every compact slot of the
        adapter's method is pinned by in-flight requests (admission stall
        — the caller keeps decoding resident slots and retries later).
        Balance every non-None acquire with ``release``."""
        if name is None:
            return 0
        if name not in self.store:
            raise self._unknown(name)
        rec = self._resident.get(name)
        if rec is not None:
            self._c["hits"].inc()
            self._lru.pop(name, None)
            self._lru[name] = None                   # move to MRU
            self._pins[name] = self._pins.get(name, 0) + 1
            return rec[0]

        method = self.store.method_of(name)
        if method not in self.caps:
            raise ValueError(
                f"adapter {name!r} uses method {method!r}, added to the "
                "store after this bank was built — re-attach to size a "
                "compact region for it")
        self._c["misses"].inc()
        if not self._free_compact[method]:
            victim = next((n for n in self._lru
                           if self._resident[n][1] == method
                           and not self._pins.get(n)), None)
            if victim is None:
                self._c["stalls"].inc()
                return None
            self._evict(victim)
        cslot = self._free_compact[method].pop()
        # every resident holds one universal + one compact slot, so a free
        # compact slot guarantees a free universal one
        uslot = self._free_universal.pop()

        t0 = time.perf_counter()
        self._page_in(name, method, cslot)
        self._page_in_ms.observe((time.perf_counter() - t0) * 1e3)
        self._lut[method][uslot] = cslot
        self._resident[name] = (uslot, method, cslot)
        self._lru[name] = None
        self._pins[name] = self._pins.get(name, 0) + 1
        self._max_resident.set_max(len(self._resident))
        return uslot

    def release(self, name: Optional[str]) -> None:
        """Request finished: unpin (the page stays resident until LRU
        eviction needs its compact slot)."""
        if name is None or name not in self._pins:
            return
        self._pins[name] -= 1
        if self._pins[name] <= 0:
            del self._pins[name]

    def _evict(self, name: str) -> None:
        self.version += 1
        uslot, method, cslot = self._resident.pop(name)
        self._lru.pop(name, None)
        self._lut[method][uslot] = 0                 # universal id -> identity
        self._free_universal.append(uslot)
        self._free_compact[method].append(cslot)
        self._c["evictions"].inc()
        # the stale page stays in the stack: nothing maps to its compact
        # slot until a new admission overwrites it

    # -- page materialization -------------------------------------------------
    def _pages_for(self, name: str,
                   method: str) -> Dict[str, Dict[str, torch.Tensor]]:
        """Factor pages of one adapter, one per adapted path: from the host
        page cache, else built by ``bank_build`` on the bank's device over
        the store's raw params (read lazily from disk if backed) and cached
        on the host."""
        cached = self._page_cache.get(name)
        if cached is not None:
            self._c["build_cache_hits"].inc()
            return cached
        self._c["builds"].inc()
        mcfg = self.store.cfg_of_method(method)
        ops = methods_lib.get(method)
        raw = self.store.adapters_for(name)
        pages: Dict[str, Dict[str, torch.Tensor]] = {}
        for path, spec in self._specs.items():
            if path not in raw:
                raise KeyError(f"adapter {name!r} has no params for {path}")
            shape = tuple(spec.batch) + (spec.d_in, spec.d_out)
            mspec = peft_lib.spec_for(mcfg, shape)
            built = ops.bank_build(mspec, [raw[path]], self.device)  # A = 1
            axis = len(mspec.batch)
            pages[path] = {k: v.select(axis, 0) for k, v in built.items()}
        self._page_cache[name] = {
            path: {k: v.to("cpu") for k, v in page.items()}
            for path, page in pages.items()}
        return pages

    def _page_in(self, name: str, method: str, cslot: int) -> None:
        """Write one adapter's pages into compact slot ``cslot`` of its
        method's stacks, in place, and wait for the copies."""
        self.version += 1
        pages = self._pages_for(name, method)
        for path, page in pages.items():
            entry = self._stacks[path][method]
            ax = self._axis[path]
            for k, dst in entry.items():
                src = page[k]
                if self._spec is not None:      # this rank's part only
                    from repro_torch.sharding.specs import local_slice
                    spec = self._spec[path][method][k]
                    if spec:
                        src = local_slice(self._mesh, src,
                                          spec[:ax] + spec[ax + 1:])
                dst.select(ax, cslot).copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- accounting -----------------------------------------------------------
    def resident_bytes(self) -> int:
        """Device bytes held by the compact stacks (identity slots
        included)."""
        return sum(arr.numel() * arr.element_size()
                   for entry in self._stacks.values()
                   for factors in entry.values()
                   for arr in factors.values())

    def padded_bytes(self) -> int:
        """What the SAME universal capacity would cost in the eager padded
        representation: every method stack spanning all capacity+1 slots
        (identities at other methods' slots) instead of its c_m+1."""
        total = 0
        for entry in self._stacks.values():
            for m, factors in entry.items():
                per_slot = sum(a.numel() * a.element_size()
                               for a in factors.values()) // (self.caps[m] + 1)
                total += per_slot * (self.capacity + 1)
        return total

    @property
    def counters(self) -> Dict[str, Any]:
        """Read-only value view of the bank's registry instruments, keyed
        by their short names."""
        return {k: c.value for k, c in self._c.items()}

    def stats(self) -> Dict[str, Any]:
        """View over the bank's registry instruments, with the JAX bank's
        keys; page-in percentiles come from the bounded histogram."""
        c = self.counters
        resident = self.resident_bytes()
        padded = self.padded_bytes()
        seen = c["hits"] + c["misses"]
        return {
            "store_adapters": len(self.store),
            "methods": dict(self.caps),
            "capacity": self.capacity,
            "resident": len(self._resident),
            "max_resident": self._max_resident.value,
            "hits": c["hits"],
            "misses": c["misses"],
            "hit_rate": c["hits"] / seen if seen else 0.0,
            "evictions": c["evictions"],
            "admission_stalls": c["stalls"],
            "builds": c["builds"],
            "build_cache_hits": c["build_cache_hits"],
            "page_in_ms_p50": self._page_in_ms.percentile(50),
            "page_in_ms_p95": self._page_in_ms.percentile(95),
            "resident_bank_bytes": resident,
            "padded_bank_bytes": padded,
            "compaction_ratio": padded / resident if resident else 0.0,
        }
