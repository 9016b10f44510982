"""KV page pool: fixed-size pages + a refcounted shared-prefix cache (port of
``repro/serve/kv.py``).

Every slot of the paged engine owns a list of fixed-size PAGES drawn from
one static pool sized by an HBM byte budget, instead of one contiguous
``max_len`` region. Allocation and free are host-side list operations at
admission and finish, never on the decode loop; the device sees an int32
page table per slot.

Page 0 is the GARBAGE page: it is never allocated and every unused table
entry points at it, so parked rows of the full decode batch write there
harmlessly (``models.attention.paged_attention_block``).

Shared prefixes: FULL prompt pages are content-hashed with a chained sha1
seeded by the adapter name (K/V depend on the adapter's rotations, so the
same tokens under different adapters must not share pages). After a
prompt's prefill completes its full pages are published hash -> page; a
later request claims the longest published prefix of its own page hashes
(refcount + 1; prefill skips those tokens). Only full, completed prompt
pages are shared, a request claims at most ``(plen - 1) // page_size`` of
them, and decode writes land after the prompt, so a shared page is
read-only for its whole life. Pages whose refcount drops to zero park in an
LRU and are evicted (hash retired) only when the free list runs dry.

The counters live in the process metrics plane (``repro_torch.obs``,
scope ``kvpool``); ``stats()`` is a view over them with the JAX pool's keys.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.obs.metrics import REGISTRY

GARBAGE_PAGE = 0

_COUNTERS = ("alloc", "freed", "prefix_queries", "prefix_hits",
             "cache_evictions", "kv_stalls")


def kv_page_bytes(cfg: ModelConfig, page_size: int,
                  kv_heads: Optional[int] = None) -> int:
    """Device bytes one page costs across ALL layers (k + v), at
    ``kv_heads`` heads (a split model's local count; default all)."""
    itemsize = torch.empty((), dtype=cfg.act_dtype).element_size()
    return (2 * cfg.num_layers * page_size * (kv_heads or cfg.num_kv_heads)
            * cfg.d_head * itemsize)


def pages_for_budget(cfg: ModelConfig, page_size: int, budget: int,
                     kv_heads: Optional[int] = None) -> int:
    """Static pool size from a device byte budget (>= garbage + 1 real);
    on a split model the budget is per card (its local kv heads)."""
    return max(2, budget // kv_page_bytes(cfg, page_size, kv_heads))


@dataclasses.dataclass
class SlotPages:
    """One admitted request's page claim (host bookkeeping only)."""
    pages: List[int]                 # in sequence order, cached prefix first
    n_cached: int                    # tokens already materialized from cache
    hashes: List[str]                # chained hashes of the FULL prompt pages
    n_prompt_full: int               # how many leading pages are full-prompt
    registered: bool = False


class KVPagePool:
    """Host-side allocator for the shared KV page pool.

    ``num_pages`` INCLUDES the garbage page 0; capacity is num_pages - 1.
    Every method is O(pages touched) and runs at admission / finish only."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (garbage + 1 allocatable)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs = np.zeros(num_pages, np.int32)
        self._by_hash: Dict[str, int] = {}
        self._page_hash: Dict[int, str] = {}
        # refcount-0 pages with still-published content, LRU order
        self._reusable: "OrderedDict[int, None]" = OrderedDict()
        # instruments live in the process metrics plane; stats() is a view
        scope = REGISTRY.scope("kvpool")
        self._c = scope.counters(*_COUNTERS)
        self._g_in_use = scope.gauge("in_use")
        self._g_free = scope.gauge("free")
        self._g_cached = scope.gauge("cached")

    # -- capacity -------------------------------------------------------------
    @property
    def available(self) -> int:
        """Pages obtainable right now (free + evictable cached)."""
        return len(self._free) + len(self._reusable)

    @property
    def in_use(self) -> int:
        return int((self._refs > 0).sum())

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.page_size)

    # -- shared-prefix hashing ------------------------------------------------
    def prefix_hashes(self, adapter: Optional[str],
                      tokens: Sequence[int]) -> List[str]:
        """Chained content hashes of the FULL pages of ``tokens``, seeded by
        the adapter name."""
        ps = self.page_size
        h = hashlib.sha1(f"adapter:{adapter or ''}".encode()).hexdigest()
        out = []
        for i in range(len(tokens) // ps):
            blob = h + ":" + ",".join(str(t) for t in tokens[i*ps:(i+1)*ps])
            h = hashlib.sha1(blob.encode()).hexdigest()
            out.append(h)
        return out

    # -- admission / finish ---------------------------------------------------
    def admit(self, adapter: Optional[str], tokens: Sequence[int],
              max_new: int) -> Optional[SlotPages]:
        """Claim pages for a request: reuse the longest published prefix of
        its full prompt pages, allocate the rest fresh. None when the pool
        cannot satisfy it right now (an admission stall: keep decoding,
        retry after a finish)."""
        ps = self.page_size
        plen = len(tokens)
        total = self.pages_needed(plen, max_new)
        hashes = self.prefix_hashes(adapter, tokens)
        # never claim the page holding the prompt's last token: its logits
        # seed generation, so at least one suffix token is always prefilled
        n_claimable = min(len(hashes), (plen - 1) // ps) if plen else 0
        self._c["prefix_queries"].inc()
        claim: List[int] = []
        for h in hashes[:n_claimable]:
            pid = self._by_hash.get(h)
            if pid is None:
                break
            claim.append(pid)
        n_fresh = total - len(claim)
        if n_fresh > len(self._free) + len(self._reusable) - sum(
                1 for p in claim if p in self._reusable):
            self._c["kv_stalls"].inc()
            return None
        for pid in claim:                  # pin cached pages, then allocate
            if self._refs[pid] == 0:
                self._reusable.pop(pid, None)
            self._refs[pid] += 1
        pages = list(claim)
        for _ in range(n_fresh):
            pages.append(self._take_free())
        self._c["prefix_hits"].inc(len(claim))
        self._c["alloc"].inc(n_fresh)
        return SlotPages(pages=pages, n_cached=len(claim) * ps,
                         hashes=hashes, n_prompt_full=len(hashes))

    def _take_free(self) -> int:
        if self._free:
            pid = self._free.pop()
        else:
            # evict the least-recently-parked cached page
            pid, _ = self._reusable.popitem(last=False)
            h = self._page_hash.pop(pid, None)
            if h is not None:
                self._by_hash.pop(h, None)
            self._c["cache_evictions"].inc()
        self._refs[pid] = 1
        return pid

    def register(self, sp: SlotPages) -> None:
        """Publish a finished prefill's full prompt pages into the prefix
        cache (idempotent; duplicate hashes keep the first publisher)."""
        if sp.registered:
            return
        sp.registered = True
        for i in range(sp.n_prompt_full):
            h = sp.hashes[i]
            if h in self._by_hash:
                continue
            pid = sp.pages[i]
            self._by_hash[h] = pid
            self._page_hash[pid] = h

    def finish(self, sp: SlotPages) -> None:
        """Release a request's claim: published pages with no remaining
        users park in the LRU cache, private pages return to the free list."""
        for pid in sp.pages:
            self._refs[pid] -= 1
            if self._refs[pid] > 0:
                continue
            if pid in self._page_hash:
                self._reusable[pid] = None
                self._reusable.move_to_end(pid)
            else:
                self._free.append(pid)
                self._c["freed"].inc()
        sp.pages = []

    # -- device view ----------------------------------------------------------
    def table_row(self, sp: SlotPages, width: int) -> np.ndarray:
        """(width,) int32 table row: the claim's pages in order, garbage
        everywhere else (the sentinel last column included)."""
        if len(sp.pages) > width - 1:
            raise ValueError(f"claim of {len(sp.pages)} pages exceeds table "
                             f"width {width} (max_pages {width - 1})")
        row = np.full(width, GARBAGE_PAGE, np.int32)
        row[:len(sp.pages)] = sp.pages
        return row

    def stats(self) -> Dict[str, int]:
        """View over the pool's registry instruments (the JAX pool's keys)
        plus live occupancy, mirrored into gauges so
        ``REGISTRY.snapshot()`` sees it too."""
        self._g_in_use.set(self.in_use)
        self._g_free.set(len(self._free))
        self._g_cached.set(len(self._reusable))
        out = {k: c.value for k, c in self._c.items()}
        out.update(in_use=self.in_use, free=len(self._free),
                   cached=len(self._reusable), num_pages=self.num_pages,
                   page_size=self.page_size)
        return out


def merge_pool_stats(stats: "List[Dict[str, int]]") -> Dict[str, int]:
    """Aggregate N pools' ``stats()``: counters and capacities sum;
    ``page_size`` must agree."""
    if not stats:
        raise ValueError("merge_pool_stats needs at least one stats dict")
    sizes = {s["page_size"] for s in stats}
    if len(sizes) > 1:
        raise ValueError(f"cannot merge pools with mixed page sizes {sizes}")
    out = dict(stats[0])
    for s in stats[1:]:
        for k, v in s.items():
            if k != "page_size":
                out[k] += v
    return out
