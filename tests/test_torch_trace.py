"""The port's request tracer and SLO monitor (``obs/trace.py``,
``obs/slo.py``), the engines' tracer hooks and the launcher's streaming
driver, against the JAX package on the CPU.

* Both recorders fed the same event sequence on an injected clock give
  equal ``report()`` dicts, byte-equal ``export_jsonl`` and equal Chrome
  JSON; breach and clear callbacks fire once per transition in both.
* On the qwen2-72b smoke config (f32; JAX's params carried across), the
  engines record the same stalls as JAX's under the same traffic: an
  ``adapter`` stall through a store-paged bank under a budget, a ``kv``
  stall through a small KV pool. Wall-clock values are checked for
  consistency only (they are times of two different programs).
* A traced run serves the untraced run's tokens, every trace complete;
  ``drive_streaming`` on a fixed arrival schedule serves the up-front
  run's tokens; the launcher runs with ``--arrival-rate --trace
  --trace-out x.jsonl --log-json``.
"""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.serve.engine import PagedServeEngine as JaxPaged  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.store import AdapterStore as JaxStore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.obs import (STALL_REASONS, MetricsRegistry,  # noqa: E402
                             RequestTrace, SLOMonitor, TraceRecorder)
from repro_torch.serve.engine import PagedServeEngine, ServeEngine  # noqa: E402
from repro_torch.store import AdapterStore  # noqa: E402

CPU = "cpu"
JCFG = jax_smoke_config("qwen2-72b")
CFG = get_smoke_config("qwen2-72b")


class _Clock:
    """A deterministic clock: each reading advances by its own step."""

    def __init__(self):
        self.t, self.k = 100.0, 0

    def __call__(self):
        self.k += 1
        self.t += 0.001 * (1 + self.k % 7)
        return self.t


def _script(rec):
    """One event sequence over two engines: stalls of every reason, chunked
    prefill, a dropped (stolen) request resubmitted with its old time."""
    a, b = rec.register_engine("serve"), rec.register_engine("paged")
    rec.submit(a, 0, adapter="alice", prompt_len=5)
    rec.submit(a, 1, prompt_len=3)
    rec.submit(b, 0, adapter="bob", prompt_len=9)
    rec.stall(a, 1, "queue")
    rec.stall(b, 0, "kv")
    rec.stall(b, 0, "kv")
    rec.stall(b, 0, "adapter")
    rec.prefill_start(a, 0)
    rec.prefill_end(a, 0)
    rec.first_token(a, 0)
    for _ in range(3):
        rec.token(a, 0)
    rec.drop(a, 1)
    rec.submit(b, 1, prompt_len=3, t_submit=100.002)
    for _ in range(2):                         # two prompt chunks
        rec.prefill_start(b, 0)
        rec.prefill_end(b, 0)
    rec.first_token(b, 0)
    rec.finish(a, 0)
    rec.token(b, 0)
    rec.prefill_start(b, 1)
    rec.prefill_end(b, 1)
    rec.first_token(b, 1)
    rec.finish(b, 1)
    rec.finish(b, 0)
    rec.finish(b, 7)                           # unknown: ignored by both


def _recorders():
    regs = (MetricsRegistry(), JaxRegistry())
    slos = (SLOMonitor(window=8), jslo.SLOMonitor(window=8))
    recs = (TraceRecorder(slo=slos[0], registry=regs[0], clock=_Clock()),
            jtrace.TraceRecorder(slo=slos[1], registry=regs[1],
                                 clock=_Clock()))
    for r in recs:
        _script(r)
    return recs, slos, regs


def test_recorder_and_monitor_equal_jax_on_one_event_sequence():
    (rec, jrec), (slo, jslo_), (reg, jreg) = _recorders()
    assert STALL_REASONS == jtrace.STALL_REASONS
    assert slo.report() == jslo_.report()
    assert reg.snapshot() == jreg.snapshot()
    assert reg.snapshot()["trace/stalls_kv"] == 2
    assert [t.complete for t in rec.finished] == [True] * 3
    assert rec.pending_count == jrec.pending_count == 0
    assert SLOMonitor.format_report(slo.report()) == \
        jslo.SLOMonitor.format_report(jslo_.report())
    bufs = [io.StringIO(), io.StringIO()]
    assert rec.export_jsonl(bufs[0]) == jrec.export_jsonl(bufs[1])
    assert bufs[0].getvalue() == bufs[1].getvalue()
    bufs = [io.StringIO(), io.StringIO()]
    assert rec.export_chrome(bufs[0]) == jrec.export_chrome(bufs[1])
    assert bufs[0].getvalue() == bufs[1].getvalue()
    doc = json.loads(bufs[0].getvalue())
    assert {ev["ph"] for ev in doc["traceEvents"]} == {"M", "X", "i"}
    assert [t.rid for t in rec.drain()] == [0, 1, 0] and not rec.finished


def test_trace_properties_and_ring_match_jax():
    kw = dict(engine="e0", rid=3, t_submit=1.0, t_first=1.5, t_finish=2.0,
              prefill_spans=[(1.1, 1.4)], token_times=[1.5, 1.7, 2.0],
              stalls={"kv": 2})
    t, j = RequestTrace(**kw), jtrace.RequestTrace(**kw)
    for attr in ("ttft_s", "tpot_s", "n_tokens", "prefill_s", "complete"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.events() == j.events()
    rec = TraceRecorder(registry=MetricsRegistry(), max_finished=4)
    tag = rec.register_engine()
    for rid in range(9):
        rec.submit(tag, rid)
        rec.finish(tag, rid)
    assert 2 <= len(rec.finished) <= 4


def _fake(rid, ttft_s, n_tok=2, t0=0.0):
    return RequestTrace(engine="e0", rid=rid, t_submit=t0, t_first=t0 + ttft_s,
                        t_finish=t0 + ttft_s + 0.01,
                        prefill_spans=[(t0, t0 + ttft_s / 2)],
                        token_times=[t0 + ttft_s + 0.01 * i
                                     for i in range(n_tok)])


def test_slo_thresholds_fire_once_per_transition_as_in_jax():
    fired = []
    for mod in (None, jslo):
        cls = SLOMonitor if mod is None else mod.SLOMonitor
        slo = cls(window=4, thresholds={"ttft_ms.p95": 50.0, "tok_s": 10.0})
        log = []
        slo.on_breach(lambda m, v, lim, log=log: log.append(("breach", m)))
        slo.on_clear(lambda m, v, lim, log=log: log.append(("clear", m)))
        for rid in range(3):
            slo.observe(_fake(rid, 0.010))
        for rid in range(3, 7):
            slo.observe(_fake(rid, 0.100))
        assert slo.any_breached and slo.report()["breached"] == \
            ["ttft_ms.p95"]
        for rid in range(7, 11):
            slo.observe(_fake(rid, 0.010))
        for rid in range(11, 15):            # a slow trickle: tok_s floor
            slo.observe(_fake(rid, 0.010, n_tok=1, t0=rid * 1.0))
        assert slo.total_observed == 15 and len(slo) == 4
        fired.append(log)
    assert fired[0] == fired[1]
    assert fired[0] == [("breach", "ttft_ms.p95"), ("clear", "ttft_ms.p95"),
                        ("breach", "tok_s")]
    with pytest.raises(ValueError):
        SLOMonitor(window=0)


def test_profiler_annotations_name_the_dispatches():
    rec = TraceRecorder(registry=MetricsRegistry(), profiler_annotations=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.annotate("decode"):
            torch.ones(4) + 1
    assert "decode" in {e.key for e in prof.key_averages()}
    off = TraceRecorder(registry=MetricsRegistry())
    with off.annotate("decode"):        # a no-op without the flag
        pass


@pytest.fixture(scope="module")
def world():
    jrt = JaxRuntime(JCFG, key=jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jrt.params),
                                       device=CPU)
    return jrt, ModelRuntime(CFG, params, device=CPU)


def _traffic(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, 100,
                                           size=int(rng.integers(4, 12)))],
             int(rng.integers(2, 8))) for _ in range(n)]


def test_traced_run_serves_the_untraced_tokens_with_complete_traces(world):
    _, rt = world
    reg = MetricsRegistry()
    slo = SLOMonitor(window=64)
    tracer = TraceRecorder(slo=slo, registry=reg)
    outs = []
    for tr in (None, tracer):
        eng = ServeEngine(rt, max_batch=2, max_len=32, eos_id=-1, tracer=tr)
        for prompt, n in _traffic():
            eng.add_request(prompt, max_new_tokens=n)
        outs.append(eng.run())
    assert outs[0] == outs[1]
    assert len(tracer.finished) == 8 and tracer.pending_count == 0
    for t in tracer.finished:
        assert t.complete and t.ttft_s >= t.prefill_s > 0.0
        assert t.n_tokens == len(outs[1][t.rid])
        assert set(t.stalls) <= {"queue"}
    snap = reg.snapshot(prefix="trace/")
    assert snap["trace/submitted"] == snap["trace/finished"] == 8
    assert snap["trace/tokens"] == sum(len(v) for v in outs[1].values())
    assert snap["trace/stalls_queue"] > 0
    rep = slo.report()
    assert rep["ttft_ms"]["p95"] >= rep["ttft_ms"]["p50"] > 0
    assert rep["tpot_ms"]["p50"] > 0 and rep["tok_s"] > 0


def _bank_adapters(params, n, seed=1):
    cfgs = {f"a{i}": tpeft.PEFTConfig(method="gsoft", block_size=8)
            for i in range(n)}
    return cfgs, tlaunch.make_demo_adapters(list(cfgs), params, cfgs, CPU,
                                            seed=seed)


def _stalls(eng, tracer, reqs, reg):
    for prompt, n, name in reqs:
        eng.add_request(prompt, max_new_tokens=n, adapter=name)
    out = eng.run()
    snap = reg.snapshot(prefix="trace/")
    return out, {r: snap[f"trace/stalls_{r}"] for r in STALL_REASONS}, \
        eng.stats["admission_stalls"]


def test_adapter_stalls_match_jax_under_a_paged_budget(world):
    """Four tenants through a store-paged bank of three slots, on both
    packages: the same tokens and the same stalls, every ``adapter`` stall
    on a finished trace."""
    jrt, rt = world
    cfgs, ads = _bank_adapters(rt.params, 4)
    jcfgs = {n: jpeft.PEFTConfig(method="gsoft", block_size=8) for n in cfgs}
    jads = jax.tree.map(jnp.asarray, convert.to_numpy(ads))
    reqs = [([1, 2, 3, 4], 4, f"a{i % 4}") for i in range(8)]
    reg, jreg = MetricsRegistry(), JaxRegistry()
    tracer = TraceRecorder(registry=reg)
    jtracer = jtrace.TraceRecorder(registry=jreg)
    got = _stalls(ServeEngine(rt.attach(AdapterStore.from_adapters(ads, cfgs),
                                        hbm_budget=3),
                              max_batch=4, max_len=32, eos_id=-1,
                              tracer=tracer), tracer, reqs, reg)
    want = _stalls(JaxEngine(jrt.attach(JaxStore.from_adapters(jads, jcfgs),
                                        hbm_budget=3),
                             max_batch=4, max_len=32, eos_id=-1,
                             tracer=jtracer), jtracer, reqs, jreg)
    assert got == want
    assert got[1]["adapter"] == got[2] > 0
    assert any(t.stalls.get("adapter") for t in tracer.finished)


def test_kv_stalls_match_jax_under_a_small_pool(world):
    jrt, rt = world
    reqs = [(p, n, None) for p, n in _traffic(6, 1)]
    reg, jreg = MetricsRegistry(), JaxRegistry()
    tracer = TraceRecorder(registry=reg)
    jtracer = jtrace.TraceRecorder(registry=jreg)
    kw = dict(max_batch=3, max_len=32, eos_id=-1, num_pages=5)
    got = _stalls(PagedServeEngine(rt, tracer=tracer, **kw), tracer, reqs,
                  reg)
    want = _stalls(JaxPaged(jrt, tracer=jtracer, **kw), jtracer, reqs, jreg)
    assert got == want
    assert got[1]["kv"] > 0
    assert all(t.complete for t in tracer.finished)
    # chunked prefill: one span per 16-token chunk, at least one a request
    assert all(len(t.prefill_spans) >= 1 for t in tracer.finished)


def test_drive_streaming_serves_the_upfront_tokens(world):
    _, rt = world
    reqs = [{"prompt": p, "max_new_tokens": n} for p, n in _traffic(6, 2)]
    eng = ServeEngine(rt, max_batch=2, max_len=32, eos_id=-1)
    for r in reqs:
        eng.add_request(**r)
    upfront = eng.run()
    tracer = TraceRecorder(slo=SLOMonitor(), registry=MetricsRegistry())
    eng = ServeEngine(rt, max_batch=2, max_len=32, eos_id=-1, tracer=tracer)
    ticks = []
    arrivals = np.asarray([0.0, 0.0, 0.01, 0.02, 0.05, 0.05])
    got = tlaunch.drive_streaming(eng, reqs, arrivals,
                                  tick_hook=lambda: ticks.append(1))
    assert got == upfront
    assert ticks and eng.stats["wall_s"] > 0 and eng.idle
    assert [t.complete for t in tracer.finished] == [True] * 6
    assert len(eng.drain_finished()) == 6 and not eng.finished


def test_tick_observer_emits_reports_and_records(world, capsys):
    _, rt = world
    slo = SLOMonitor()
    eng = ServeEngine(rt, max_batch=2, max_len=32, eos_id=-1,
                      tracer=TraceRecorder(slo=slo,
                                           registry=MetricsRegistry()))
    eng.add_request([1, 2, 3], max_new_tokens=3)
    for log_json in (True, False):
        obs = tlaunch.make_tick_observer(eng, slo, 0.0, log_json)
        obs()
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[0])
    assert rec["event"] == "tick" and rec["queue_depth"] == 1
    assert rec["slo"]["window_requests"] == 0
    assert out[1].startswith("slo: 0 req in window")


def test_launcher_streams_traces_and_logs_json(tmp_path, capsys):
    path = tmp_path / "x.jsonl"
    assert tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--requests", "6",
                         "--arrival-rate", "200", "--trace", "--trace-out",
                         str(path), "--log-json", "--mixed-lengths",
                         "--device", CPU]) == 0
    lines = capsys.readouterr().out.splitlines()
    recs = [json.loads(line) for line in lines if line.startswith("{")]
    assert recs[-1]["event"] == "summary" and recs[-1]["requests"] == 6
    assert recs[-1]["slo"]["total_requests"] == 6
    assert any(r["event"] == "tick" for r in recs)
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert {e["event"] for e in events} >= {"submit", "prefill",
                                            "first_token", "finish"}
    assert len({e["rid"] for e in events}) == 6
    assert any("trace: 6 requests" in line for line in lines)
