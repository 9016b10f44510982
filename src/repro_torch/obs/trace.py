"""Per-request trace spans: where a token's time goes.

A :class:`TraceRecorder` follows every request through the engine tick
loop as a sequence of SPANS and EVENTS on one wall clock
(``time.perf_counter``):

    submit ──(queue/adapter/kv stalls)──> prefill chunk(s) ──> first token
           ──> decode token ... decode token ──> finish

From those it derives the two serving latencies the SLO monitor and the
benches report:

    TTFT  time-to-first-token   = t_first  - t_submit
    TPOT  per-token decode gap  = diffs of the token timestamps

and STALL ATTRIBUTION — each tick an engine cannot admit the queue head
it records why (``kv`` pool exhausted, ``adapter`` bank fully pinned, or
plain ``queue`` head-of-line waiting on a slot), so a latency regression
names the resource that caused it.

Engines call the recorder only when one is attached (``tracer=None`` is
the default and costs nothing); every hook is a couple of float appends,
which is meant to keep tracing-on throughput within 5% of off.

Keys are ``(engine_tag, rid)``: each engine registers itself once
(:meth:`TraceRecorder.register_engine`) so a cluster of replicas records
into ONE recorder without rid collisions. A rebalanced request is
``drop``-ed by the engine it is stolen from and re-``submit``-ed (with
its original submit timestamp) by the engine that receives it.

Finished traces export as JSON-lines (one event per line — greppable,
streamable) or as the Chrome ``trace_event`` format readable by
``chrome://tracing`` / Perfetto. An opt-in profiler hook (``annotate``,
``profiler_annotations=True``) wraps the engines' prefill and decode
dispatches in named ``torch.profiler.record_function`` ranges, so a
``torch.profiler`` capture shows ``prefill`` / ``decode`` beside the
device's kernels.

Port of ``repro/obs/trace.py``: the same spans, counters (scope ``trace``
of the port's ``REGISTRY``) and export formats, byte for byte.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, TextIO, Tuple

from .metrics import REGISTRY, MetricsRegistry
from .slo import SLOMonitor

#: stall attribution reasons engines may record
STALL_REASONS = ("kv", "adapter", "queue")


@dataclasses.dataclass
class RequestTrace:
    """One request's lifecycle. Times are ``perf_counter`` seconds."""

    engine: str
    rid: int
    adapter: Optional[str] = None
    prompt_len: int = 0
    t_submit: float = 0.0
    t_first: float = 0.0
    t_finish: float = 0.0
    #: (start, end) of each prefill dispatch — one span for whole-prompt
    #: prefill, one per chunk under chunked prefill
    prefill_spans: List[Tuple[float, float]] = \
        dataclasses.field(default_factory=list)
    #: commit timestamp of every generated token (first token included)
    token_times: List[float] = dataclasses.field(default_factory=list)
    #: ticks spent stalled at admission, by reason
    stalls: Dict[str, int] = dataclasses.field(default_factory=dict)

    # -- derived latencies ----------------------------------------------------
    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_submit

    @property
    def tpot_s(self) -> List[float]:
        """Decode gaps between consecutive token commits (n_tokens - 1
        entries; empty for single-token requests)."""
        tt = self.token_times
        return [tt[i + 1] - tt[i] for i in range(len(tt) - 1)]

    @property
    def n_tokens(self) -> int:
        return len(self.token_times)

    @property
    def prefill_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.prefill_spans)

    @property
    def complete(self) -> bool:
        """Did this request record its full lifecycle? (submit, at least
        one prefill span, a first token, and a finish, in order)."""
        return (self.t_submit > 0.0 and bool(self.prefill_spans)
                and self.t_first >= self.t_submit
                and self.t_finish >= self.t_first
                and bool(self.token_times))

    # -- export ---------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """Flat event records (JSONL rows), times in absolute seconds."""
        base = {"engine": self.engine, "rid": self.rid}
        if self.adapter is not None:
            base["adapter"] = self.adapter
        ev = [dict(base, event="submit", t=self.t_submit,
                   prompt_len=self.prompt_len)]
        for reason, n in sorted(self.stalls.items()):
            ev.append(dict(base, event="stall", reason=reason, ticks=n))
        for t0, t1 in self.prefill_spans:
            ev.append(dict(base, event="prefill", t=t0, dur_s=t1 - t0))
        if self.t_first:
            ev.append(dict(base, event="first_token", t=self.t_first,
                           ttft_ms=self.ttft_s * 1e3))
        for t in self.token_times[1:]:
            ev.append(dict(base, event="token", t=t))
        if self.t_finish:
            ev.append(dict(base, event="finish", t=self.t_finish,
                           n_tokens=self.n_tokens))
        return ev


class TraceRecorder:
    """Collects :class:`RequestTrace` records from one or more engines.

    ``slo``: an optional :class:`SLOMonitor` fed every finished trace.
    ``profiler_annotations``: wrap ``annotate``-d dispatches in
    ``torch.profiler.record_function`` so a ``torch.profiler`` capture
    shows named prefill/decode ranges (off by default — it is only useful
    under an active profiler session).
    ``max_finished`` bounds the finished-trace buffer (ring semantics)
    the same way histograms bound their reservoirs; drivers that export
    should call ``drain`` or ``export_*`` periodically.
    """

    def __init__(self, *, slo: Optional[SLOMonitor] = None,
                 profiler_annotations: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 max_finished: int = 65536,
                 clock=time.perf_counter):
        self.slo = slo
        self.profiler_annotations = profiler_annotations
        self.clock = clock
        self.max_finished = max_finished
        self._pending: Dict[Tuple[str, int], RequestTrace] = {}
        self.finished: List[RequestTrace] = []
        self._tags: Dict[str, int] = {}
        scope = (registry or REGISTRY).scope("trace")
        self._c = scope.counters(
            "submitted", "finished", "dropped", "tokens",
            *(f"stalls_{r}" for r in STALL_REASONS))

    # -- engine registration --------------------------------------------------
    def register_engine(self, kind: str = "engine") -> str:
        """A unique tag for one engine's requests (``serve0``, ``serve1``,
        ``paged0``...): rids are per-engine, tags make them global."""
        n = self._tags.get(kind, 0)
        self._tags[kind] = n + 1
        return f"{kind}{n}"

    # -- lifecycle hooks (engines call these) ---------------------------------
    def submit(self, tag: str, rid: int, adapter: Optional[str] = None,
               prompt_len: int = 0,
               t_submit: Optional[float] = None) -> None:
        """New request. ``t_submit`` carries the ORIGINAL timestamp when a
        rebalanced request re-enters on another engine."""
        self._pending[(tag, rid)] = RequestTrace(
            engine=tag, rid=rid, adapter=adapter, prompt_len=prompt_len,
            t_submit=self.clock() if t_submit is None else t_submit)
        self._c["submitted"].inc()

    def stall(self, tag: str, rid: int, reason: str) -> None:
        """The engine could not admit this (queue-head) request this tick:
        ``kv`` = page pool exhausted, ``adapter`` = bank slots all pinned,
        ``queue`` = no free decode slot."""
        tr = self._pending.get((tag, rid))
        if tr is not None:
            tr.stalls[reason] = tr.stalls.get(reason, 0) + 1
        self._c[f"stalls_{reason}"].inc()

    def prefill_start(self, tag: str, rid: int) -> None:
        tr = self._pending.get((tag, rid))
        if tr is not None:
            tr.prefill_spans.append((self.clock(), 0.0))

    def prefill_end(self, tag: str, rid: int) -> None:
        tr = self._pending.get((tag, rid))
        if tr is not None and tr.prefill_spans:
            t0, _ = tr.prefill_spans[-1]
            tr.prefill_spans[-1] = (t0, self.clock())

    def first_token(self, tag: str, rid: int) -> None:
        tr = self._pending.get((tag, rid))
        if tr is not None:
            tr.t_first = self.clock()
            tr.token_times.append(tr.t_first)
            self._c["tokens"].inc()

    def token(self, tag: str, rid: int) -> None:
        tr = self._pending.get((tag, rid))
        if tr is not None:
            tr.token_times.append(self.clock())
            self._c["tokens"].inc()

    def drop(self, tag: str, rid: int) -> None:
        """Forget a pending trace — the request left this engine (cluster
        rebalance steals it from the queue; it re-submits elsewhere)."""
        if self._pending.pop((tag, rid), None) is not None:
            self._c["dropped"].inc()

    def finish(self, tag: str, rid: int) -> Optional[RequestTrace]:
        tr = self._pending.pop((tag, rid), None)
        if tr is None:
            return None
        tr.t_finish = self.clock()
        self.finished.append(tr)
        if len(self.finished) > self.max_finished:     # bounded ring
            del self.finished[:-self.max_finished // 2]
        self._c["finished"].inc()
        if self.slo is not None:
            self.slo.observe(tr)
        return tr

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def drain(self) -> List[RequestTrace]:
        out, self.finished = self.finished, []
        return out

    # -- profiler hook --------------------------------------------------------
    def annotate(self, name: str):
        """Context manager for one dispatch: a named
        ``torch.profiler.record_function`` range when
        ``profiler_annotations`` is on, otherwise a no-op."""
        if not self.profiler_annotations:
            return contextlib.nullcontext()
        import torch.profiler
        return torch.profiler.record_function(name)

    # -- export ---------------------------------------------------------------
    def export_jsonl(self, path_or_file) -> int:
        """One JSON event per line for every finished trace, in finish
        order; returns the number of lines written."""
        n = 0
        with _open(path_or_file, "w") as f:
            for tr in self.finished:
                for ev in tr.events():
                    f.write(json.dumps(ev, sort_keys=True) + "\n")
                    n += 1
        return n

    def export_chrome(self, path_or_file) -> int:
        """Chrome ``trace_event`` JSON (load in chrome://tracing or
        Perfetto): one row (tid) per engine, an X span per request and per
        prefill chunk, instant events for tokens. Returns event count."""
        if not self.finished:
            t0 = 0.0
        else:
            t0 = min(tr.t_submit for tr in self.finished)
        tids = {tag: i + 1 for i, tag in
                enumerate(sorted({tr.engine for tr in self.finished}))}

        def us(t: float) -> float:
            return (t - t0) * 1e6

        events: List[Dict[str, Any]] = [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
             "args": {"name": tag}} for tag, tid in tids.items()]
        for tr in self.finished:
            tid = tids[tr.engine]
            args = {"rid": tr.rid, "adapter": tr.adapter,
                    "prompt_len": tr.prompt_len, "n_tokens": tr.n_tokens,
                    "ttft_ms": tr.ttft_s * 1e3, "stalls": tr.stalls}
            events.append({"name": f"request {tr.rid}", "cat": "request",
                           "ph": "X", "pid": 1, "tid": tid,
                           "ts": us(tr.t_submit),
                           "dur": us(tr.t_finish) - us(tr.t_submit),
                           "args": args})
            for t0s, t1s in tr.prefill_spans:
                events.append({"name": "prefill", "cat": "prefill",
                               "ph": "X", "pid": 1, "tid": tid,
                               "ts": us(t0s), "dur": us(t1s) - us(t0s),
                               "args": {"rid": tr.rid}})
            for t in tr.token_times:
                events.append({"name": "token", "cat": "decode", "ph": "i",
                               "s": "t", "pid": 1, "tid": tid, "ts": us(t),
                               "args": {"rid": tr.rid}})
        with _open(path_or_file, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return len(events)


@contextlib.contextmanager
def _open(path_or_file, mode: str):
    if hasattr(path_or_file, "write"):
        yield path_or_file                       # caller-owned handle
    else:
        f: TextIO = open(path_or_file, mode)
        try:
            yield f
        finally:
            f.close()
