"""EngineCluster: N serving-engine replicas behind one engine surface
(port of ``repro/distrib/cluster.py``).

Data-parallel serving for the multi-tenant adapter story: each replica is
a full engine (continuous, paged or image) over its own ``ModelRuntime``
— the same weights, its own KV state and its own (usually store-paged)
adapter bank. Replicas may share one card: the params exist once and each
replica keeps its own KV and paged bank. The cluster routes arrivals by
ADAPTER AFFINITY: a tenant's requests keep landing on the replica whose
``PagedAdapterBank`` already holds their factors, so page-ins happen once
per tenant per home, not once per admission. Spillover (home overloaded
while a sibling idles) falls back to least-loaded, and queued-but-
unadmitted work rebalances off overloaded replicas each tick.

The surface duck-types a single engine (``add_request`` / ``step`` /
``run`` / ``idle`` / ``finished`` / ``drain_finished`` / ``stats`` /
``add_wall``), so ``launch.serve.drive_streaming`` drives 1 or N replicas
with the same loop; ``cluster_stats()`` is the one aggregated report, of
which the single-replica launcher output is the N=1 case. Routing counters
live in the port's ``REGISTRY`` under scope ``cluster``.

Each tick launches EVERY replica's decode step before committing any of
them (``step_launch`` / ``step_commit``): CUDA launches are asynchronous,
so one replica's device work queues while the host does another's
bookkeeping.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.slo import SLOMonitor
from repro_torch.serve.engine import Request
from repro_torch.serve.kv import merge_pool_stats


def _bank_resident(eng, name: str) -> bool:
    """Is this adapter's factor set warm in the replica's bank? Eager
    banks have no ``resident`` surface — everything is resident."""
    bank = eng.rt.bank
    probe = getattr(bank, "is_resident", None)
    if probe is not None:
        return probe(name)
    return bank is not None


class EngineCluster:
    """Affinity-routing front over ``engines`` (all replicas must serve
    the same adapter universe — same store / same named bank)."""

    def __init__(self, engines: Sequence, *,
                 spill_depth: Optional[int] = None,
                 rebalance_margin: Optional[int] = None,
                 auto_rebalance: bool = True,
                 slo: Optional[SLOMonitor] = None):
        if not engines:
            raise ValueError("EngineCluster needs at least one engine")
        self.engines = list(engines)
        b0 = self.engines[0].max_batch
        # a home replica counts as overloaded once its backlog exceeds a
        # full extra batch; spilling earlier would shred affinity for a
        # queue that one tick of decode progress will absorb anyway
        self.spill_depth = 2 * b0 if spill_depth is None else spill_depth
        self.rebalance_margin = (b0 if rebalance_margin is None
                                 else rebalance_margin)
        self.auto_rebalance = auto_rebalance
        self._affinity: Dict[str, int] = {}          # adapter -> home replica
        self._rid_map: Dict[Tuple[int, int], int] = {}
        self._next_crid = 0
        self._results: Dict[int, List[int]] = {}
        self.finished: List[Request] = []
        self._wall = 0.0
        # routing counters live in the process metrics plane; the
        # `routing` property keeps the pre-obs dict read surface
        self._routing = REGISTRY.scope("cluster").counters(
            "routed", "base", "fresh", "affinity_hits",
            "affinity_spills", "rebalanced")
        # SLO-driven admission backpressure: when the monitor's thresholds
        # breach, `accepting` drops and streaming drivers hold arrivals
        # until it clears (transition callbacks — no per-request polling)
        self.slo = slo
        self.accepting = True
        if slo is not None and slo.thresholds:
            slo.on_breach(lambda *a: setattr(self, "accepting", False))
            slo.on_clear(
                lambda *a: setattr(self, "accepting",
                                   not slo.any_breached))

    # -- routing --------------------------------------------------------------
    def _least_loaded(self, exclude: Optional[int] = None) -> int:
        cands = [i for i in range(len(self.engines)) if i != exclude]
        return min(cands, key=lambda i: (self.engines[i].load, i))

    def _route(self, adapter: Optional[str]) -> Tuple[int, str]:
        """(replica, kind) for one arrival. kind is the routing-counter
        key: 'base' (no adapter — pure load balancing), 'fresh' (first
        sighting — establishes the home), 'affinity_hits' (repeat tenant
        on its warm home), 'affinity_spills' (home overloaded, sent to
        least-loaded; the home stays sticky so the tenant returns)."""
        if adapter is None:
            return self._least_loaded(), "base"
        home = self._affinity.get(adapter)
        if home is None:
            # pre-warmed somewhere (earlier traffic, pre-seeded store)?
            home = next((i for i, e in enumerate(self.engines)
                         if _bank_resident(e, adapter)), None)
            if home is None:
                home = self._least_loaded()
            self._affinity[adapter] = home
            return home, "fresh"
        if self.engines[home].load >= self.spill_depth:
            alt = self._least_loaded()
            if (alt != home and self.engines[alt].load
                    + self.rebalance_margin <= self.engines[home].load):
                return alt, "affinity_spills"
        return home, "affinity_hits"

    def add_request(self, prompt: List[int], max_new_tokens: int = 16,
                    adapter: Optional[str] = None) -> int:
        i, kind = self._route(adapter)
        local = self.engines[i].add_request(prompt, max_new_tokens,
                                            adapter=adapter)
        self._routing["routed"].inc()
        self._routing[kind].inc()
        crid = self._next_crid
        self._next_crid += 1
        self._rid_map[(i, local)] = crid
        return crid

    # -- rebalance / drain ----------------------------------------------------
    def rebalance(self) -> int:
        """Move queued (never-admitted) requests from the most- to the
        least-loaded replica until the spread is within
        ``rebalance_margin``. Moves only backlog — in-flight slots stay."""
        moved = 0
        while True:
            hi = max(range(len(self.engines)),
                     key=lambda i: (self.engines[i].load, -i))
            lo = self._least_loaded(exclude=hi)
            if (lo == hi or self.engines[hi].queue_depth == 0 or
                    self.engines[hi].load - self.engines[lo].load
                    <= self.rebalance_margin):
                return moved
            req = self.engines[hi].steal_queued()
            if req is None:
                return moved
            crid = self._rid_map.pop((hi, req.rid))
            self._rid_map[(lo, self.engines[lo].submit(req))] = crid
            self._routing["rebalanced"].inc()
            moved += 1

    def drain(self, idx: int) -> int:
        """Drain replica ``idx``'s whole backlog onto its siblings
        (overload relief / taking a replica out of rotation)."""
        if len(self.engines) < 2:
            return 0
        moved = 0
        while self.engines[idx].queue_depth:
            req = self.engines[idx].steal_queued()
            crid = self._rid_map.pop((idx, req.rid))
            lo = self._least_loaded(exclude=idx)
            self._rid_map[(lo, self.engines[lo].submit(req))] = crid
            self._routing["rebalanced"].inc()
            moved += 1
        return moved

    # -- engine surface -------------------------------------------------------
    @property
    def idle(self) -> bool:
        return all(e.idle for e in self.engines)

    @property
    def num_active(self) -> int:
        return sum(e.num_active for e in self.engines)

    @property
    def queue_depth(self) -> int:
        return sum(e.queue_depth for e in self.engines)

    def add_wall(self, dt: float) -> None:
        self._wall += dt

    def _collect(self) -> None:
        """Pull finished requests out of the replicas, re-keyed to cluster
        rids (per-engine rids collide across replicas by construction)."""
        for i, eng in enumerate(self.engines):
            for r in eng.drain_finished():
                crid = self._rid_map.pop((i, r.rid))
                r.rid = crid
                self.finished.append(r)
                self._results[crid] = r.output

    def step(self) -> bool:
        """One cluster tick: rebalance backlog, LAUNCH every replica's
        decode step, then commit them in launch order — device work
        overlaps across replicas while the host syncs one at a time."""
        if self.auto_rebalance and len(self.engines) > 1:
            self.rebalance()
        pending = [eng.step_launch() for eng in self.engines]
        alive = [eng.step_commit(p)
                 for eng, p in zip(self.engines, pending)]
        self._collect()
        return any(alive)

    def run(self) -> Dict[int, List[int]]:
        """Drain all replicas to completion; {cluster rid: tokens}."""
        t0 = time.perf_counter()
        while self.step():
            pass
        self.add_wall(time.perf_counter() - t0)
        out, self._results = self._results, {}
        return out

    def drain_finished(self) -> List[Request]:
        out, self.finished = self.finished, []
        for r in out:
            self._results.pop(r.rid, None)
        return out

    # -- stats ----------------------------------------------------------------
    @property
    def routing(self) -> Dict[str, int]:
        """Read-only value view of the routing counters (pre-obs keys)."""
        return {k: c.value for k, c in self._routing.items()}

    @property
    def stats(self) -> Dict[str, Any]:
        """Single-engine-shaped aggregate (the keys ``describe`` and the
        benches read). Computed on access — mutate via ``add_wall``."""
        agg = {"requests": 0, "tokens_generated": 0, "decode_steps": 0,
               "prefills": 0, "admission_stalls": 0}
        for eng in self.engines:
            for k in agg:
                agg[k] += eng.stats[k]
        agg["wall_s"] = self._wall
        return agg

    def adapter_stats(self) -> Optional[Dict[str, Any]]:
        per = [eng.adapter_stats() for eng in self.engines]
        per = [p for p in per if p is not None]
        if not per:
            return None
        n = len(per)
        out = {"hits": sum(p["hits"] for p in per),
               "misses": sum(p["misses"] for p in per),
               "evictions": sum(p["evictions"] for p in per),
               "max_resident": sum(p["max_resident"] for p in per),
               "capacity": sum(p["capacity"] for p in per),
               "page_in_ms_p95": max(p["page_in_ms_p95"] for p in per),
               "compaction_ratio": sum(p["compaction_ratio"]
                                       for p in per) / n}
        seen = out["hits"] + out["misses"]
        out["hit_rate"] = out["hits"] / seen if seen else 0.0
        return out

    def kv_stats(self) -> Optional[Dict[str, int]]:
        per = [eng.kv_stats() for eng in self.engines
               if hasattr(eng, "kv_stats")]
        return merge_pool_stats(per) if per else None

    def affinity_hit_rate(self) -> float:
        """Fraction of REPEAT-adapter arrivals routed to their warm home.
        First sightings are compulsory cold starts and 'base' traffic has
        no affinity to hit — neither belongs in the denominator."""
        h = self.routing["affinity_hits"]
        s = self.routing["affinity_spills"]
        return h / (h + s) if h + s else 1.0

    def cluster_stats(self) -> Dict[str, Any]:
        """The one serving report: aggregate + routing + per-replica rows.
        The launcher prints this for N=1 too — single-engine output is
        the degenerate case, not a separate formatter."""
        agg = dict(self.stats)
        wall = agg["wall_s"]
        agg["tok_s"] = agg["tokens_generated"] / wall if wall > 0 else 0.0
        routing = dict(self.routing)
        routing["affinity_hit_rate"] = self.affinity_hit_rate()
        per = []
        for eng in self.engines:
            per.append({
                "queue_depth": eng.queue_depth,
                "active": eng.num_active,
                "requests": eng.stats["requests"],
                "tokens_generated": eng.stats["tokens_generated"],
                "decode_steps": eng.stats["decode_steps"],
                "prefills": eng.stats["prefills"],
                "admission_stalls": eng.stats["admission_stalls"],
                "adapter": eng.adapter_stats(),
                "kv": (eng.kv_stats() if hasattr(eng, "kv_stats")
                       else None),
            })
        return {"replicas": len(self.engines), "aggregate": agg,
                "routing": routing, "per_replica": per,
                "slo": self.slo.report() if self.slo is not None else None}


def format_cluster_report(cs: Dict[str, Any]) -> str:
    """Human-readable ``cluster_stats()`` — shared by the launcher (N>=1)
    and the bench logs."""
    agg, routing = cs["aggregate"], cs["routing"]
    lines = [f"cluster: {cs['replicas']} replica(s), "
             f"{agg['requests']} requests, {agg['tokens_generated']} tokens "
             f"in {agg['wall_s']:.2f}s ({agg['tok_s']:.1f} tok/s, "
             f"{agg['decode_steps']} decode steps, "
             f"{agg['prefills']} prefills, "
             f"{agg['admission_stalls']} stalls)"]
    if routing["routed"]:
        lines.append(
            f"routing: {routing['routed']} routed "
            f"(base={routing['base']} fresh={routing['fresh']} "
            f"hits={routing['affinity_hits']} "
            f"spills={routing['affinity_spills']} "
            f"rebalanced={routing['rebalanced']}) "
            f"affinity_hit_rate={routing['affinity_hit_rate']:.2f}")
    for i, row in enumerate(cs["per_replica"]):
        lines.append(f"  replica[{i}]: requests={row['requests']} "
                     f"tokens={row['tokens_generated']} "
                     f"steps={row['decode_steps']} "
                     f"stalls={row['admission_stalls']}")
        ad = row["adapter"]
        if ad is not None:
            lines.append(f"    bank: hit_rate={ad['hit_rate']:.2f} "
                         f"page_ins={ad['misses']} "
                         f"evictions={ad['evictions']} "
                         f"resident<={ad['max_resident']}/{ad['capacity']}")
        kv = row["kv"]
        if kv is not None:
            lines.append(f"    kv: pool={kv['num_pages']}x"
                         f"{kv['page_size']}tok alloc={kv['alloc']} "
                         f"prefix_hits={kv['prefix_hits']} "
                         f"kv_stalls={kv['kv_stalls']}")
    if cs.get("slo") is not None:
        lines.append(SLOMonitor.format_report(cs["slo"]))
    return "\n".join(lines)
