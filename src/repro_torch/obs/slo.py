"""Sliding-window SLO monitor over finished request traces (port of
``repro/obs/slo.py``; plain Python, no torch).

The :class:`SLOMonitor` keeps the last ``window`` finished requests
(deque — constant memory like every obs buffer) and answers the serving
questions operators actually ask:

* TTFT p50/p95/p99 (ms) — how long until a request streams?
* TPOT p50/p95/p99 (ms) — how smooth is decode once it starts?
* tok/s over the window — is the fleet keeping up?
* stall rate and per-reason stall counts — WHICH resource is the
  bottleneck when it is not?

``report()`` renders all of that as one flat-ish dict that
``launch/serve.py --report-interval`` prints and ``--log-json`` emits.

Thresholds turn the monitor into a control input: register
``on_breach`` / ``on_clear`` callbacks and a driver can shed or
re-admit load when p95 TTFT crosses a line (admission backpressure).
Callbacks fire only on TRANSITIONS (ok→breach, breach→ok), not every
observation, so a hovering metric does not flap the caller.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

#: report percentiles for both TTFT and TPOT
SLO_PERCENTILES = (50, 95, 99)


def _pcts(samples_ms: List[float]) -> Dict[str, float]:
    if not samples_ms:
        return {f"p{q}": 0.0 for q in SLO_PERCENTILES}
    arr = np.asarray(samples_ms)
    return {f"p{q}": float(np.percentile(arr, q)) for q in SLO_PERCENTILES}


class SLOMonitor:
    """Window of the last ``window`` finished :class:`RequestTrace`-likes.

    Anything with ``ttft_s``, ``tpot_s``, ``n_tokens``, ``t_submit``,
    ``t_finish`` and ``stalls`` duck-types in; in practice it is fed by
    ``TraceRecorder.finish`` (pass the monitor as ``TraceRecorder(slo=...)``).

    ``thresholds`` maps a metric path (``"ttft_ms.p95"``, ``"tpot_ms.p99"``,
    ``"stall_rate"``, ``"tok_s"``) to a ceiling — except ``tok_s``, which
    is a FLOOR (too slow is the breach). Breach state is re-evaluated per
    ``observe``.
    """

    def __init__(self, window: int = 256,
                 thresholds: Optional[Dict[str, float]] = None):
        if window < 1:
            raise ValueError("SLO window must be >= 1")
        self.window = window
        self.thresholds = dict(thresholds or {})
        self._traces: "collections.deque" = collections.deque(maxlen=window)
        self._total = 0
        self._breached: Dict[str, bool] = {m: False for m in self.thresholds}
        self._on_breach: List[Callable[[str, float, float], None]] = []
        self._on_clear: List[Callable[[str, float, float], None]] = []

    # -- feeding --------------------------------------------------------------
    def observe(self, trace) -> None:
        self._traces.append(trace)
        self._total += 1
        if self.thresholds:
            self._check()

    @property
    def total_observed(self) -> int:
        """Requests ever observed (the window only bounds retention)."""
        return self._total

    def __len__(self) -> int:
        return len(self._traces)

    # -- thresholds / backpressure --------------------------------------------
    def on_breach(self, fn: Callable[[str, float, float], None]) -> None:
        """``fn(metric, value, threshold)`` fires when a metric FIRST
        crosses its threshold (and again only after it clears)."""
        self._on_breach.append(fn)

    def on_clear(self, fn: Callable[[str, float, float], None]) -> None:
        self._on_clear.append(fn)

    @property
    def breached(self) -> Dict[str, bool]:
        return dict(self._breached)

    @property
    def any_breached(self) -> bool:
        return any(self._breached.values())

    def _metric(self, path: str, rep: Dict) -> float:
        cur = rep
        for part in path.split("."):
            cur = cur[part]
        return float(cur)

    def _check(self) -> None:
        rep = self.report()
        for metric, limit in self.thresholds.items():
            value = self._metric(metric, rep)
            # tok_s is a floor (breach = too slow); everything else a ceiling
            bad = value < limit if metric == "tok_s" else value > limit
            was = self._breached.get(metric, False)
            if bad and not was:
                self._breached[metric] = True
                for fn in self._on_breach:
                    fn(metric, value, limit)
            elif was and not bad:
                self._breached[metric] = False
                for fn in self._on_clear:
                    fn(metric, value, limit)

    # -- reporting ------------------------------------------------------------
    def _window_span(self) -> Tuple[float, int]:
        """(wall seconds covered by the window, tokens in it)."""
        if not self._traces:
            return 0.0, 0
        t0 = min(tr.t_submit for tr in self._traces)
        t1 = max(tr.t_finish for tr in self._traces)
        toks = sum(tr.n_tokens for tr in self._traces)
        return max(t1 - t0, 1e-9), toks

    def report(self) -> Dict:
        """The SLO surface: percentile latencies, window throughput, stall
        attribution, and current breach flags."""
        ttft = [tr.ttft_s * 1e3 for tr in self._traces]
        tpot = [g * 1e3 for tr in self._traces for g in tr.tpot_s]
        stalls: Dict[str, int] = {}
        stalled_reqs = 0
        for tr in self._traces:
            if tr.stalls:
                stalled_reqs += 1
            for reason, n in tr.stalls.items():
                stalls[reason] = stalls.get(reason, 0) + n
        span_s, toks = self._window_span()
        n = len(self._traces)
        return {
            "window_requests": n,
            "total_requests": self._total,
            "ttft_ms": _pcts(ttft),
            "tpot_ms": _pcts(tpot),
            "tok_s": toks / span_s if n else 0.0,
            "stall_rate": stalled_reqs / n if n else 0.0,
            "stalls": stalls,
            "breached": [m for m, b in self._breached.items() if b],
        }

    @staticmethod
    def format_report(rep: Dict) -> str:
        """One human line per concern — what --report-interval prints."""
        t, p = rep["ttft_ms"], rep["tpot_ms"]
        lines = [
            f"slo: {rep['window_requests']} req in window "
            f"({rep['total_requests']} total), {rep['tok_s']:.1f} tok/s",
            f"  ttft_ms p50={t['p50']:.2f} p95={t['p95']:.2f} "
            f"p99={t['p99']:.2f}",
            f"  tpot_ms p50={p['p50']:.2f} p95={p['p95']:.2f} "
            f"p99={p['p99']:.2f}",
            f"  stall_rate={rep['stall_rate']:.3f} stalls={rep['stalls']}",
        ]
        if rep["breached"]:
            lines.append(f"  BREACH: {', '.join(rep['breached'])}")
        return "\n".join(lines)
