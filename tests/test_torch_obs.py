"""The port's metrics plane against the JAX package's on the CPU: mirrors
the metrics tests of tests/test_obs.py (instrument semantics, idempotent
registration and kind collisions, scope uniquifying, snapshot expansion,
the bounded page-in histogram under LRU thrash), each compared with JAX's
instruments fed the same observations, and the process registry's
snapshot keys after the same serve run in both packages (the continuous
and paged engines, the KV page pool and a store-paged bank). Counts and
snapshots compare exactly; wall-clock values (``wall_s``, ``page_in_ms``)
are compared by key only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.serve.engine import PagedServeEngine as JaxPaged  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.store import AdapterStore as JaxStore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.obs import (REGISTRY, Counter, Gauge, Histogram,  # noqa: E402
                             MetricsRegistry)
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.serve.engine import PagedServeEngine, ServeEngine  # noqa: E402
from repro_torch.store import AdapterStore  # noqa: E402
from repro_torch.store import paging  # noqa: E402

CPU = "cpu"
# wall-clock instruments: present in both snapshots, values differ
TIMED = ("wall_s", "page_in_ms")


def test_instrument_semantics_match_jax():
    for mod in (tmetrics, jmetrics):
        c = mod.Counter("c")
        c.inc()
        c.inc(3)
        assert c.value == 4
        g = mod.Gauge("g")
        g.set(7)
        g.set_max(3)
        g.set_max(11)
        assert g.value == 11
    h, jh = Histogram("h", cap=8), jmetrics.Histogram("h", cap=8)
    rng = np.random.default_rng(0)
    for v in rng.normal(size=100) * 10:
        h.observe(float(v))
        jh.observe(float(v))
    assert h.count == jh.count == 100 and len(h) == len(jh) == 8
    assert h.sum == jh.sum and h.mean == jh.mean
    assert h.percentiles() == jh.percentiles()
    assert h.percentiles((0, 25, 100)) == jh.percentiles((0, 25, 100))
    with pytest.raises(ValueError):
        Histogram("bad", cap=0)
    assert Histogram("e").percentile(50) == 0.0 and Histogram("e").mean == 0
    assert isinstance(Counter("x"), Counter) and isinstance(Gauge("x"), Gauge)


def test_registry_idempotent_and_kind_collision():
    r = MetricsRegistry()
    assert r.counter("x") is r.counter("x")
    with pytest.raises(TypeError):
        r.gauge("x")
    with pytest.raises(TypeError):
        r.histogram("x")


def test_scope_uniquify_isolates_replicas():
    r = MetricsRegistry()
    s0, s1 = r.scope("kvpool"), r.scope("kvpool")
    assert s0.prefix == "kvpool" and s1.prefix == "kvpool:1"
    c0 = s0.counters("alloc", "freed")
    c1 = s1.counters("alloc", "freed")
    c0["alloc"].inc(5)
    assert c1["alloc"].value == 0
    assert r.get("kvpool/alloc").value == 5
    assert r.get("kvpool:1/alloc").value == 0


def test_snapshot_expands_histograms_as_jax_does():
    snaps = []
    for mod in (tmetrics, jmetrics):
        r = mod.MetricsRegistry()
        s = r.scope("bank")
        s.counter("hits").inc(2)
        s.gauge("max_resident").set_max(3)
        h = s.histogram("page_in_ms", cap=16)
        for v in (1.0, 2.0, 3.0):
            h.observe(v)
        snaps.append(r.snapshot())
        assert r.snapshot(prefix="nope") == {}
        r.reset()
        assert r.names() == []
    assert snaps[0] == snaps[1]
    assert snaps[0]["bank/page_in_ms.count"] == 3
    assert snaps[0]["bank/page_in_ms.mean"] == pytest.approx(2.0)


@pytest.fixture(scope="module")
def world():
    jrt = JaxRuntime(jax_smoke_config("qwen2-72b"), key=jax.random.PRNGKey(0))
    rt = ModelRuntime(get_smoke_config("qwen2-72b"),
                      convert.params_from_numpy(
                          jax.tree.map(np.asarray, jrt.params), device=CPU),
                      device=CPU)
    return jrt, rt


def _stores(world, n):
    """The same n GSOFT tenants (b = 8) in a port store and a JAX store."""
    jrt, _ = world
    store, jstore = AdapterStore(), JaxStore()
    for i in range(n):
        jcfg = jpeft.PEFTConfig(method="gsoft", block_size=8)
        ad = jpeft.init_peft(jcfg, jrt.params, jax.random.PRNGKey(i))
        ad = jax.tree.map(lambda a, i=i: a + 0.2 * jax.random.normal(
            jax.random.PRNGKey(100 + i), a.shape), ad)
        jstore.add(f"a{i}", ad, jcfg)
        store.add(f"a{i}", convert.adapters_from_numpy(
            jax.tree.map(np.asarray, ad), device=CPU),
            tpeft.PEFTConfig(method="gsoft", block_size=8))
    return store, jstore


def test_page_in_histogram_bounded_under_thrash(world, monkeypatch):
    monkeypatch.setattr(paging, "PAGE_IN_HIST_CAP", 4)
    store, _ = _stores(world, 6)
    bank = world[1].attach(store, hbm_budget=3).bank
    for i in range(12):
        name = f"a{i % 6}"
        assert bank.acquire(name) is not None
        bank.release(name)
    hist = bank._page_in_ms
    assert hist.count > 4 and len(hist) <= 4
    st = bank.stats()
    assert st["page_in_ms_p95"] >= st["page_in_ms_p50"] >= 0.0


def _drive(rt, engine_cls, paged_cls, store):
    """One serve run: a contiguous engine and a paged-KV engine over a
    store-paged bank (budget 2 of 4 tenants), the same ragged traffic."""
    banked = rt.attach(store, hbm_budget=2)
    rng = np.random.default_rng(0)
    work = [([int(t) for t in rng.integers(1, 100,
                                           size=int(rng.integers(4, 12)))],
             int(rng.integers(2, 6)), f"a{i % 4}") for i in range(8)]
    out = []
    for eng in (engine_cls(banked, max_batch=2, max_len=32, eos_id=-1),
                paged_cls(banked, max_batch=2, max_len=32, eos_id=-1,
                          page_size=4, prefill_chunk=4)):
        rids = [eng.add_request(p, max_new_tokens=n, adapter=a)
                for p, n, a in work]
        res = eng.run()
        out.append([res[r] for r in rids])
        if hasattr(eng, "kv_stats"):
            eng.kv_stats()          # mirrors occupancy into the gauges
    return out


def test_registry_snapshot_after_a_serve_run_equals_jax(world):
    """The same traffic through both packages leaves the same instrument
    names in the process registry, with equal counts (and equal tokens)."""
    jrt, rt = world
    store, jstore = _stores(world, 4)
    REGISTRY.reset()
    jmetrics.REGISTRY.reset()
    try:
        got = _drive(rt, ServeEngine, PagedServeEngine, store)
        want = _drive(jrt, JaxEngine, JaxPaged, jstore)
        assert got == want
        snap, jsnap = REGISTRY.snapshot(), jmetrics.REGISTRY.snapshot()
    finally:
        REGISTRY.reset()
        jmetrics.REGISTRY.reset()
    assert sorted(snap) == sorted(jsnap)
    prefixes = {k.split("/")[0] for k in snap}
    assert prefixes == {"serve", "paged", "kvpool", "bank"}
    untimed = {k: v for k, v in snap.items()
               if not any(t in k for t in TIMED)}
    assert untimed == {k: jsnap[k] for k in untimed}
    assert snap["serve/requests"] == snap["paged/requests"] == 8
    assert snap["bank/evictions"] > 0 and snap["bank/page_in_ms.count"] > 0
