"""The port's ``EngineCluster`` against the JAX package's on the CPU
(qwen2-72b smoke config, f32), on the setup of tests/test_distributed.py:
four tenants (two GSOFT, two BOFT) in a store, one store-paged bank per
replica. Each test drives both clusters with the same arrivals and holds
the port to JAX's routing counters, affinity homes, page-ins, spill /
rebalance / drain moves, ``cluster_stats()`` keys and
``format_cluster_report`` text, and greedy tokens — exactly (f32 on both
sides, the params and adapters carried across, as the other bank tests
do). Also the N=1 degenerate case, SLO backpressure through ``accepting``
and the launcher's ``--replicas 2`` lane."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.distrib import EngineCluster as JaxCluster  # noqa: E402
from repro.distrib import format_cluster_report as jax_report  # noqa: E402
from repro.obs.slo import SLOMonitor as JaxSLO  # noqa: E402
from repro.obs.trace import TraceRecorder as JaxTracer  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.store import AdapterStore as JaxStore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.distrib import EngineCluster, format_cluster_report  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.obs import SLOMonitor, TraceRecorder  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.store import AdapterStore  # noqa: E402

CPU = "cpu"
CFG = get_smoke_config("qwen2-72b")
JCFG = jax_smoke_config("qwen2-72b")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    """(JAX runtime, port runtime, JAX store, port store, tenant names):
    the same params and the same (JAX-drawn) tenant factors."""
    jrt = JaxRuntime(JCFG, key=jax.random.PRNGKey(0))
    rt = ModelRuntime(CFG, convert.params_from_numpy(_np_tree(jrt.params),
                                                     device=CPU), device=CPU)
    methods = {f"t{i}": "gsoft" if i < 2 else "boft" for i in range(4)}
    jstore, store = JaxStore(), AdapterStore()
    for i, (name, m) in enumerate(methods.items()):
        jc = jpeft.PEFTConfig(method=m, block_size=8)
        ad = jpeft.init_peft(jc, jrt.params, jax.random.PRNGKey(i + 1))
        ad = jax.tree.map(lambda a, s=i: a + 0.3 * jax.random.normal(
            jax.random.PRNGKey(s + 100), a.shape), ad)
        jstore.add(name, ad, jc)
        store.add(name, convert.adapters_from_numpy(_np_tree(ad), device=CPU),
                  tpeft.PEFTConfig(method=m, block_size=8))
    return jrt, rt, jstore, store, list(methods)


def _clusters(world, n, budget=2, max_batch=2, **kw):
    jrt, rt, jstore, store, _ = world
    jcl = JaxCluster([JaxEngine(jrt.attach(jstore, hbm_budget=budget),
                                max_batch=max_batch, max_len=32, eos_id=-1)
                      for _ in range(n)], **kw)
    cl = EngineCluster([ServeEngine(rt.attach(store, hbm_budget=budget),
                                    max_batch=max_batch, max_len=32,
                                    eos_id=-1)
                        for _ in range(n)], **kw)
    return jcl, cl


def _workload(names, n_req, seed=0):
    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(1, 200, size=int(
                 rng.integers(4, 11))).tolist(),
             "max_new_tokens": int(rng.integers(2, 7)),
             "adapter": names[i % len(names)]}
            for i in range(n_req)]


def _both(jcl, cl, wl):
    """Submit ``wl`` to both clusters and run them: (JAX, port) outputs in
    submission order."""
    jr = [jcl.add_request(**r) for r in wl]
    tr = [cl.add_request(**r) for r in wl]
    jout, tout = jcl.run(), cl.run()
    return [jout[c] for c in jr], [tout[c] for c in tr]


def _misses(cl):
    return [e.rt.bank.counters["misses"] for e in cl.engines]


def test_affinity_keeps_tenants_warm_as_jax(world):
    """Repeat traffic lands on the home whose bank holds the tenant: the
    homes, page-ins and routing counters equal JAX's after each round."""
    jcl, cl = _clusters(world, 2)
    wl = _workload(world[4], 8)
    for _ in range(2):
        jt, tt = _both(jcl, cl, wl)
        assert tt == jt
        assert dict(cl._affinity) == dict(jcl._affinity)
        assert _misses(cl) == _misses(jcl)
        assert cl.routing == jcl.routing
    assert sorted(cl._affinity.values()) == [0, 0, 1, 1]
    assert cl.affinity_hit_rate() == jcl.affinity_hit_rate() == 1.0
    assert cl.routing["fresh"] == 4 and cl.routing["affinity_hits"] == 12


def test_tokens_equal_single_engine_and_jax(world):
    """Routing schedules, it does not compute: the cluster's greedy tokens
    equal one engine's serving the same arrivals, and JAX's cluster's."""
    _, rt, _, store, names = world
    wl = _workload(names, 10, seed=1)
    solo = ServeEngine(rt.attach(store, hbm_budget=4), max_batch=2,
                       max_len=32, eos_id=-1)
    rids = [solo.add_request(**r) for r in wl]
    ref = solo.run()
    jcl, cl = _clusters(world, 2)
    jt, tt = _both(jcl, cl, wl)
    assert tt == [ref[r] for r in rids] == jt


def test_spill_rebalance_and_drain_as_jax(world):
    """A flooded home spills to the least-loaded sibling (the home stays
    sticky); ``rebalance`` and ``drain`` move only queued backlog, as many
    requests as JAX's cluster moves, and every request still finishes."""
    jcl, cl = _clusters(world, 2, auto_rebalance=False)
    for c in (jcl, cl):
        for _ in range(10):
            c.add_request([3, 4, 5], max_new_tokens=3, adapter="t0")
    assert cl.routing == jcl.routing and cl.routing["affinity_spills"] > 0
    assert cl._affinity["t0"] == jcl._affinity["t0"] == 0
    assert [e.load for e in cl.engines] == [e.load for e in jcl.engines]
    assert cl.rebalance() == jcl.rebalance()
    assert [e.queue_depth for e in cl.engines] == \
        [e.queue_depth for e in jcl.engines]
    assert cl.drain(0) == jcl.drain(0) > 0
    assert cl.engines[0].queue_depth == jcl.engines[0].queue_depth == 0
    assert cl.routing == jcl.routing
    tout, jout = cl.run(), jcl.run()
    assert tout == jout and sorted(tout) == list(range(10))
    assert cl.stats["requests"] == jcl.stats["requests"] == 10


def _walled(c, wall=2.0):
    c._wall = wall          # the one clock-dependent number, pinned
    return c.cluster_stats()


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return None


def test_cluster_stats_and_report_equal_jax(world):
    """``cluster_stats()`` has JAX's keys at every level and the same
    counts; ``format_cluster_report`` prints the same text (the wall time
    pinned on both sides)."""
    jcl, cl = _clusters(world, 2)
    _both(jcl, cl, _workload(world[4], 6, seed=2))
    cs, jcs = _walled(cl), _walled(jcl)
    assert _keys(cs) == _keys(jcs)
    assert cs["aggregate"] == jcs["aggregate"]
    assert cs["routing"] == jcs["routing"]
    skip = {"page_in_ms_p50", "page_in_ms_p95"}
    for row, jrow in zip(cs["per_replica"], jcs["per_replica"]):
        assert {k: v for k, v in row.items() if k != "adapter"} == \
            {k: v for k, v in jrow.items() if k != "adapter"}
        assert {k: v for k, v in row["adapter"].items() if k not in skip} \
            == {k: v for k, v in jrow["adapter"].items() if k not in skip}
    text = format_cluster_report(cs)
    assert text == jax_report(jcs)
    assert "2 replica(s)" in text and "replica[1]" in text and "bank:" in text


def test_n1_is_the_degenerate_case(world):
    """One replica behind the cluster surface: its tokens, stats and
    report equal JAX's N=1 cluster (nothing to spill to)."""
    jcl, cl = _clusters(world, 1, budget=4)
    jt, tt = _both(jcl, cl, _workload(world[4], 4, seed=3))
    assert tt == jt
    cs, jcs = _walled(cl), _walled(jcl)
    assert cs["replicas"] == jcs["replicas"] == 1
    assert cl.affinity_hit_rate() == 1.0 and cl.drain(0) == 0
    assert format_cluster_report(cs) == jax_report(jcs)


def test_slo_backpressure_drops_accepting_as_jax(world):
    """A breached SLO threshold turns ``accepting`` off on both clusters
    (streaming drivers then hold arrivals), and the report carries the SLO
    block."""
    jrt, rt, jstore, store, names = world
    th = {"ttft_ms.p95": 0.0}
    jslo, slo = JaxSLO(window=8, thresholds=th), SLOMonitor(window=8,
                                                            thresholds=th)
    jcl = JaxCluster([JaxEngine(jrt.attach(jstore, hbm_budget=4),
                                max_batch=2, max_len=32, eos_id=-1,
                                tracer=JaxTracer(slo=jslo))], slo=jslo)
    cl = EngineCluster([ServeEngine(rt.attach(store, hbm_budget=4),
                                    max_batch=2, max_len=32, eos_id=-1,
                                    tracer=TraceRecorder(slo=slo))], slo=slo)
    assert cl.accepting and jcl.accepting
    _both(jcl, cl, _workload(names, 3, seed=4))
    assert not cl.accepting and not jcl.accepting
    assert "ttft_ms" in format_cluster_report(cl.cluster_stats())


def test_launcher_serves_two_replicas_on_the_cpu(capsys):
    """``--replicas 2`` over a store-paged demo bank: one cluster report
    with a row (and a bank line) per replica, and the JSON summary names
    the replica count."""
    assert tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--requests", "8",
                         "--replicas", "2", "--demo-adapters", "4",
                         "--demo-methods", "gsoft,boft",
                         "--hbm-adapter-budget", "2", "--log-json",
                         "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "cluster: 2 replica(s), 8 requests" in out
    assert "replica[0]" in out and "replica[1]" in out
    assert out.count("    bank: hit_rate=") == 2
    assert "routing: 8 routed" in out
    summary = [json.loads(line) for line in out.splitlines()
               if line.startswith('{"event": "summary"')]
    assert summary and summary[0]["replicas"] == 2
    with pytest.raises(SystemExit, match="steppable"):
        tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--engine", "static",
                      "--replicas", "2", "--device", CPU])
