"""The port's adapter store and store-paged bank against the JAX package on
the CPU (qwen2-72b smoke config, f32): mirrors the ten tests of
tests/test_store.py — the budget split, insert-time capability checks,
unknown-name errors, the LRU order and the bank's counters under a
synthetic trace, pinned pages stalling, tokens across evict / re-page
against each tenant's solo merged run, the compacted bank against the
padded bank (unquantized and int8), the lazy store <-> checkpoint round
trip, and late inserts — each compared with JAX's result on the same
inputs. Also the engines' context-cache repair: the cached AdapterContext
is keyed on (slot ids, bank version), so a slot id that stays the same
while its tenant is evicted and paged in again serves the right tenant.

Greedy tokens are compared exactly (f32 on both sides, as
tests/test_torch_methods.py's bank tokens); counters and orders exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.store import AdapterStore as JaxStore  # noqa: E402
from repro.store import PagedAdapterBank as JaxPagedBank  # noqa: E402
from repro.store import split_budget as jax_split_budget  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.serve.engine import PagedServeEngine, ServeEngine  # noqa: E402
from repro_torch.store import (AdapterStore, PagedAdapterBank,  # noqa: E402
                               split_budget)

CPU = "cpu"
CFG = get_smoke_config("qwen2-72b")
JCFG = jax_smoke_config("qwen2-72b")
METHODS = ("gsoft", "boft", "householder")
PROMPT = [3, 4, 5, 6]


def _tc(method, **kw):
    return tpeft.PEFTConfig(method=method, block_size=8, **kw)


def _jc(method, **kw):
    return jpeft.PEFTConfig(method=method, block_size=8, **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    jrt = JaxRuntime(JCFG, key=jax.random.PRNGKey(0))
    rt = ModelRuntime(CFG, convert.params_from_numpy(_np_tree(jrt.params),
                                                     device=CPU), device=CPU)
    return jrt, rt


def _jtuned(cfg, params, seed, scale=0.3):
    ad = jpeft.init_peft(cfg, params, jax.random.PRNGKey(seed))
    return jax.tree.map(
        lambda a: a + scale * jax.random.normal(
            jax.random.PRNGKey(seed + 100), a.shape), ad)


def _mixed(world, n):
    """(port store, JAX store, port adapters, JAX adapters, port cfgs, JAX
    cfgs), tenants t0..t{n-1} round-robin over METHODS with the same
    (JAX-drawn) factors on both sides."""
    jrt, _ = world
    tcfgs = {f"t{i}": _tc(METHODS[i % 3]) for i in range(n)}
    jcfgs = {f"t{i}": _jc(METHODS[i % 3]) for i in range(n)}
    jad = {name: _jtuned(c, jrt.params, i + 1)
           for i, (name, c) in enumerate(jcfgs.items())}
    tad = convert.adapters_from_numpy(_np_tree(jad), device=CPU)
    store, jstore = AdapterStore(), JaxStore()
    for name in tcfgs:
        store.add(name, tad[name], tcfgs[name])
        jstore.add(name, jad[name], jcfgs[name])
    return store, jstore, tad, jad, tcfgs, jcfgs


def _solo(world, adapters, cfg, max_new=4):
    """Single-request reference: the one adapter merged offline."""
    _, rt = world
    merged = ModelRuntime(CFG, rt.params, device=CPU, adapters=adapters,
                          peft_cfg=cfg)
    eng = ServeEngine(merged, max_batch=1, max_len=32, eos_id=-1)
    rid = eng.add_request(list(PROMPT), max_new_tokens=max_new)
    return eng.run()[rid]


def _serve(engine, names, max_new=4):
    rids = [(n, engine.add_request(list(PROMPT), max_new_tokens=max_new,
                                   adapter=n)) for n in names]
    out = engine.run()
    return [(n, out[r]) for n, r in rids]


# ---------------------------------------------------------------------------
# budget split
# ---------------------------------------------------------------------------

def test_split_budget_proportional_floored_and_capped():
    assert split_budget(4, {"a": 10, "b": 1}) == {"a": 3, "b": 1}
    assert split_budget(10, {"a": 2, "b": 2}) == {"a": 2, "b": 2}
    with pytest.raises(ValueError, match="one adapter per method"):
        split_budget(1, {"a": 3, "b": 3})
    rng = np.random.default_rng(0)
    for _ in range(50):
        counts = {m: int(rng.integers(1, 9)) for m in
                  rng.choice(["gsoft", "boft", "oft", "householder"],
                             size=int(rng.integers(1, 5)), replace=False)}
        budget = int(rng.integers(len(counts), 30))
        assert split_budget(budget, counts) == jax_split_budget(budget,
                                                                counts)
    assert split_budget(5, {}) == jax_split_budget(5, {}) == {}


# ---------------------------------------------------------------------------
# insert-time capability checks
# ---------------------------------------------------------------------------

def test_store_rejects_unbankable_methods_at_insert():
    store = AdapterStore()
    with pytest.raises(ValueError, match="lora.*weight-side"):
        store.add("x", {}, tpeft.PEFTConfig(method="lora"))
    with pytest.raises(ValueError, match="double_gsoft.*output-side"):
        store.add("x", {}, tpeft.PEFTConfig(method="double_gsoft"))
    with pytest.raises(ValueError, match="use_scale"):
        store.add("x", {}, tpeft.PEFTConfig(method="gsoft", use_scale=True))
    assert len(store) == 0


def test_store_rejects_config_forks_and_duplicates(world):
    store, _, tad, _, _, _ = _mixed(world, 3)
    with pytest.raises(ValueError, match="one bank holds one stack"):
        store.add("fork", tad["t0"], tpeft.PEFTConfig(method="gsoft",
                                                      block_size=4))
    with pytest.raises(ValueError, match="already holds"):
        store.add("t0", tad["t0"], _tc("gsoft"))
    with pytest.raises(ValueError, match="reserved identity"):
        store.add(tpeft.BASE_ADAPTER, tad["t0"], _tc("gsoft"))
    store.remove("t0")
    assert "t0" not in store and "gsoft" not in store.method_counts()
    # removing a method's last member frees its canonical config
    fork = tpeft.PEFTConfig(method="gsoft", block_size=4)
    store.add("fork", tpeft.init_peft(fork, world[1].params, device=CPU),
              fork)
    assert store.method_counts() == {"boft": 1, "householder": 1, "gsoft": 1}


def test_unknown_name_errors_list_resident_and_host_tiers(world):
    _, rt = world
    store, _, _, _, _, _ = _mixed(world, 3)
    bank = PagedAdapterBank(store, rt.params, hbm_budget=3)
    bank.acquire("t0")
    with pytest.raises(KeyError) as ei:
        bank.validate("nope")
    msg = str(ei.value)
    assert "t0" in msg and "t1" in msg and "t2" in msg and "resident" in msg
    with pytest.raises(KeyError, match="acquire"):
        bank.slot("t1")
    assert bank.slot("t0") == bank.acquire("t0")


# ---------------------------------------------------------------------------
# LRU paging + pinning, against JAX's bank on the same trace
# ---------------------------------------------------------------------------

def _gsoft_pair(world, n=3):
    jrt, rt = world
    store, jstore = AdapterStore(), JaxStore()
    for i in range(n):
        jad = _jtuned(_jc("gsoft"), jrt.params, i + 1)
        store.add(f"g{i}", convert.adapters_from_numpy(_np_tree(jad),
                                                       device=CPU),
                  _tc("gsoft"))
        jstore.add(f"g{i}", jad, _jc("gsoft"))
    return (PagedAdapterBank(store, rt.params, hbm_budget=2),
            JaxPagedBank(jstore, jrt.params, hbm_budget=2))


_NUMERIC = ("hits", "misses", "evictions", "admission_stalls", "builds",
            "build_cache_hits", "resident", "max_resident", "capacity",
            "store_adapters", "hit_rate", "methods")


def _same_state(bank, jbank):
    assert bank.resident == jbank.resident
    assert bank.counters == jbank.counters
    st, jst = bank.stats(), jbank.stats()
    assert sorted(st) == sorted(jst)
    assert {k: st[k] for k in _NUMERIC} == {k: jst[k] for k in _NUMERIC}
    for m in bank.bank_methods:
        np.testing.assert_array_equal(bank._lut[m], jbank._lut[m])
    assert bank.version == jbank.version


def test_lru_eviction_order_under_synthetic_trace(world):
    bank, jbank = _gsoft_pair(world)
    assert bank.caps == jbank.caps == {"gsoft": 2} and bank.capacity == 2
    trace = ["g0", "g1", "g0", "g2", "g1", "g0", "g2", "g2", "g1"]
    for name in trace:
        assert bank.acquire(name) == jbank.acquire(name), name
        bank.release(name)
        jbank.release(name)
        _same_state(bank, jbank)
    assert bank.counters["evictions"] > 0
    assert bank.counters["build_cache_hits"] > 0
    assert bank.counters["builds"] == 3
    # the resident pages hold the built factors JAX's stacks hold
    for path, entry in bank._stacks.items():
        for k, v in entry["gsoft"].items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(jbank._stacks[path]["gsoft"][k]),
                atol=1e-6)


def test_pinned_pages_stall_instead_of_evicting(world):
    bank, jbank = _gsoft_pair(world)
    for b in (bank, jbank):
        b.acquire("g0")
        b.acquire("g1")
        assert b.acquire("g2") is None
        assert b.stats()["admission_stalls"] == 1
        assert set(b.resident) == {"g0", "g1"}
        b.release("g1")
        assert b.acquire("g2") is not None
        assert set(b.resident) == {"g0", "g2"}
    _same_state(bank, jbank)


# ---------------------------------------------------------------------------
# served tokens
# ---------------------------------------------------------------------------

def test_paged_tokens_match_solo_and_jax_across_evict_repage(world):
    """6 tenants x 3 methods under budget 3 (one compact slot per method):
    every admission past the first of a method evicts; tokens equal each
    tenant's solo merged run and JAX's store-paged run, on revisits after
    an eviction too."""
    jrt, rt = world
    store, jstore, tad, _, tcfgs, _ = _mixed(world, 6)
    prt = rt.attach(store, hbm_budget=3)
    jprt = jrt.attach(jstore, hbm_budget=3)
    assert prt.bank.capacity == 3
    refs = {name: _solo(world, tad[name], tcfgs[name]) for name in tcfgs}
    order = [f"t{i}" for i in (0, 3, 1, 4, 2, 5)]
    for round_no in range(2):
        eng = ServeEngine(prt, max_batch=2, max_len=32, eos_id=-1)
        jeng = JaxEngine(jprt, max_batch=2, max_len=32, eos_id=-1)
        got = _serve(eng, order)
        assert got == _serve(jeng, order), round_no
        for name, toks in got:
            assert toks == refs[name], (round_no, name)
        assert eng.stats["admission_stalls"] == \
            jeng.stats["admission_stalls"] >= 1
    st = prt.bank.stats()
    assert st["evictions"] > 0
    assert st["max_resident"] <= st["capacity"] == 3
    _same_state(prt.bank, jprt.bank)


@pytest.mark.parametrize("quantize", [False, True])
def test_compacted_bank_matches_padded_bank_and_jax(world, quantize):
    """Slot compaction is a representation change only: the paged bank and
    the eager padded bank serve the same tokens, unquantized and over int8
    weights, equal to JAX's paged bank, and compaction saves >= 2x at 3
    methods."""
    jrt, rt = world
    _, _, tad, jad, tcfgs, jcfgs = _mixed(world, 3)
    base = rt.quantized("int8") if quantize else rt
    jbase = jrt.quantized("int8") if quantize else jrt
    names = list(tcfgs) + [None]

    def tokens(r, engine_cls=ServeEngine):
        return _serve(engine_cls(r, max_batch=2, max_len=32, eos_id=-1),
                      names)

    padded = tokens(base.attach(dict(tad), dict(tcfgs)))
    paged_rt = base.attach(dict(tad), dict(tcfgs), hbm_budget=3)
    assert isinstance(paged_rt.bank, PagedAdapterBank)
    assert tokens(paged_rt) == padded
    assert tokens(jbase.attach(dict(jad), dict(jcfgs), hbm_budget=3),
                  JaxEngine) == padded
    st = paged_rt.bank.stats()
    assert st["compaction_ratio"] >= 2.0, st
    assert st["resident_bank_bytes"] < st["padded_bank_bytes"]


def test_paged_kv_engine_serves_the_store(world):
    """The paged KV engine over a store-paged bank gives the contiguous
    engine's tokens."""
    _, rt = world
    store, _, _, _, tcfgs, _ = _mixed(world, 6)
    order = [f"t{i}" for i in (0, 3, 1, 4, 2, 5)]
    want = _serve(ServeEngine(rt.attach(store, hbm_budget=3), max_batch=2,
                              max_len=32, eos_id=-1), order)
    store2, _, _, _, _, _ = _mixed(world, 6)
    eng = PagedServeEngine(rt.attach(store2, hbm_budget=3), max_batch=2,
                           max_len=32, eos_id=-1, page_size=4,
                           prefill_chunk=4)
    assert _serve(eng, order) == want


# ---------------------------------------------------------------------------
# persistence: store <-> checkpoint
# ---------------------------------------------------------------------------

def test_store_checkpoint_roundtrip_is_lazy_and_exact(world, tmp_path):
    jrt, rt = world
    store, _, tad, _, tcfgs, jcfgs = _mixed(world, 3)
    store.save(str(tmp_path))
    opened = AdapterStore.open(str(tmp_path))
    assert opened.names == store.names
    assert {n: opened.cfg_for(n) for n in opened.names} == tcfgs
    assert not opened._host
    tree = opened.adapters_for("t1")
    assert "t1" in opened._host and "t0" not in opened._host
    for path, entry in tad["t1"].items():
        for k, v in entry.items():
            assert torch.equal(tree[path][k], v)
            assert tree[path][k].device.type == "cpu"
    # JAX opens the port's store too, with the same configs
    jopened = JaxStore.open(str(tmp_path))
    assert jopened.names == opened.names
    assert {n: jopened.cfg_for(n) for n in jopened.names} == jcfgs
    rt2 = rt.attach(str(tmp_path), hbm_budget=3)
    eng = ServeEngine(rt2, max_batch=1, max_len=32, eos_id=-1)
    rid = eng.add_request(list(PROMPT), max_new_tokens=4, adapter="t2")
    assert eng.run()[rid] == _solo(world, tad["t2"], tcfgs["t2"])


def test_store_insert_after_attach_requires_reattach(world):
    jrt, rt = world
    store, _, _, _, _, _ = _mixed(world, 2)
    bank = PagedAdapterBank(store, rt.params, hbm_budget=2)
    late = tpeft.init_peft(_tc("householder"), rt.params, device=CPU)
    store.add("late", late, _tc("householder"))
    with pytest.raises(ValueError, match="re-attach"):
        bank.acquire("late")


# ---------------------------------------------------------------------------
# the context-cache repair
# ---------------------------------------------------------------------------

def test_context_cache_follows_the_bank_version(world, monkeypatch):
    """One decode slot and one compact GSOFT slot: g0, g1, g0 in turn hold
    the same universal slot id (1) while each admission evicts the other
    tenant and pages the new one in. The engine's cached context is keyed
    on (slot ids, bank version), so every page-in rebuilds it, and each
    request serves its own tenant's tokens (its solo merged run)."""
    jrt, rt = world
    store = AdapterStore()
    tads = {}
    for i in range(2):
        jad = _jtuned(_jc("gsoft"), jrt.params, i + 11)
        tads[f"g{i}"] = convert.adapters_from_numpy(_np_tree(jad),
                                                    device=CPU)
        store.add(f"g{i}", tads[f"g{i}"], _tc("gsoft"))
    prt = rt.attach(store, hbm_budget=1)
    built = []
    real = prt.context

    def counting(ids):
        # the engine's decode context passes its numpy slot-id array, the
        # admission prefill a one-element list
        if isinstance(ids, np.ndarray):
            built.append((tuple(int(i) for i in ids), prt.bank.version))
        return real(ids)

    monkeypatch.setattr(prt, "context", counting)
    eng = ServeEngine(prt, max_batch=1, max_len=32, eos_id=-1)
    got = _serve(eng, ["g0", "g1", "g0"], max_new=4)
    refs = {n: _solo(world, tads[n], _tc("gsoft")) for n in tads}
    assert [t for _, t in got] == [refs["g0"], refs["g1"], refs["g0"]]
    assert refs["g0"] != refs["g1"]
    # the slot id stayed (1,) for all three requests; the decode context
    # was rebuilt under the version of each request's page-in
    assert {ids for ids, _ in built} == {(1,)}
    assert len(built) == 3 and len({v for _, v in built}) == 3
    assert eng._ctx_key == ((1,), prt.bank.version)
    assert prt.bank.stats()["evictions"] == 2
