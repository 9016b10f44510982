"""The metrics plane: one process-wide registry of typed instruments
(port of ``repro/obs/metrics.py``; plain Python, no torch).

``Counter``     monotonically increasing int/float (``inc``).
``Gauge``       last-written value (``set`` / ``set_max``).
``Histogram``   bounded observation reservoir: a ``deque(maxlen=cap)``
                keeps the most recent ``cap`` samples for percentile
                queries while ``count`` / ``sum`` stream exactly, so memory
                stays constant however long the process serves. The
                reservoir keeps the newest samples, as JAX's does: it draws
                nothing at random, so it needs no generator and two runs of
                one trace hold the same samples.

Owners of instruments (a KV pool, an adapter bank, an engine) take a
:class:`MetricsScope` from the process registry: ``REGISTRY.scope("kvpool")``
hands back a namespace whose instruments land under ``kvpool/...``
(``kvpool:1/...`` for the second pool). The owners' ``stats()`` surfaces are
views over their instruments, with the same keys as the JAX package's, and
``REGISTRY.snapshot()`` is the whole process in one flat dict.

Single-threaded host bookkeeping: no locks, no background threads, so an
update is an attribute add, cheap enough for per-token accounting.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

Number = Union[int, float]

#: default Histogram reservoir size — large enough for stable p99s, small
#: enough that a histogram can never be a leak
DEFAULT_HIST_CAP = 1024


class Counter:
    """Monotonic accumulator (ints or float seconds both welcome)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v: Number = 0

    def inc(self, n: Number = 1) -> None:
        self._v += n

    @property
    def value(self) -> Number:
        return self._v

    def __repr__(self) -> str:
        return f"Counter({self.name}={self._v})"


class Gauge:
    """Last-written value (resident counts, high-water marks via set_max)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v: Number = 0

    def set(self, v: Number) -> None:
        self._v = v

    def set_max(self, v: Number) -> None:
        """High-water mark: keep the larger of current and ``v``."""
        if v > self._v:
            self._v = v

    @property
    def value(self) -> Number:
        return self._v

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self._v})"


class Histogram:
    """Bounded-reservoir histogram: exact streaming count/sum, percentiles
    over the most recent ``cap`` observations. Replaces the append-forever
    latency lists (the ``page_in_ms`` leak) with constant memory."""

    __slots__ = ("name", "cap", "_buf", "_count", "_sum")

    def __init__(self, name: str, cap: int = DEFAULT_HIST_CAP):
        if cap < 1:
            raise ValueError("histogram cap must be >= 1")
        self.name = name
        self.cap = cap
        self._buf: "collections.deque[float]" = collections.deque(maxlen=cap)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: Number) -> None:
        self._buf.append(float(v))
        self._count += 1
        self._sum += float(v)

    @property
    def count(self) -> int:
        """Total observations ever (not capped)."""
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def __len__(self) -> int:
        """Samples currently held — never exceeds ``cap``."""
        return len(self._buf)

    def percentile(self, q: Number) -> float:
        if not self._buf:
            return 0.0
        return float(np.percentile(np.asarray(self._buf), q))

    def percentiles(self, qs: Iterable[Number] = (50, 95, 99)
                    ) -> Dict[str, float]:
        return {f"p{q:g}": self.percentile(q) for q in qs}

    def __repr__(self) -> str:
        return (f"Histogram({self.name}, n={self._count}, "
                f"held={len(self._buf)}/{self.cap})")


Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Flat name -> instrument map. ``REGISTRY`` (below) is the process-
    wide instance every serving component registers into; fresh registries
    exist for tests and for isolated tooling."""

    def __init__(self):
        self._instruments: Dict[str, Instrument] = {}
        self._prefixes: Dict[str, int] = {}

    # -- instrument constructors (idempotent per name) ------------------------
    def _make(self, name: str, factory, kind) -> Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = factory(name)
        elif not isinstance(inst, kind):
            raise TypeError(f"instrument {name!r} already registered as "
                            f"{type(inst).__name__}, not {kind.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._make(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._make(name, Gauge, Gauge)

    def histogram(self, name: str, cap: int = DEFAULT_HIST_CAP) -> Histogram:
        return self._make(name, lambda n: Histogram(n, cap), Histogram)

    # -- namespacing ----------------------------------------------------------
    def scope(self, prefix: str) -> "MetricsScope":
        """A namespaced view whose instruments land under ``prefix/``.
        Repeat prefixes auto-uniquify (``kvpool``, ``kvpool:1``, ...) so N
        replicas of the same component never share instruments."""
        n = self._prefixes.get(prefix, 0)
        self._prefixes[prefix] = n + 1
        return MetricsScope(self, prefix if n == 0 else f"{prefix}:{n}")

    # -- queries --------------------------------------------------------------
    def get(self, name: str) -> Optional[Instrument]:
        return self._instruments.get(name)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def snapshot(self, prefix: str = "") -> Dict[str, Number]:
        """The whole plane as one flat dict. Histograms expand into
        ``name.count`` / ``name.mean`` / ``name.p50|p95|p99``."""
        out: Dict[str, Number] = {}
        for name, inst in sorted(self._instruments.items()):
            if prefix and not name.startswith(prefix):
                continue
            if isinstance(inst, Histogram):
                out[f"{name}.count"] = inst.count
                out[f"{name}.mean"] = inst.mean
                for k, v in inst.percentiles().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = inst.value
        return out

    def reset(self) -> None:
        """Drop every instrument and prefix (test isolation)."""
        self._instruments.clear()
        self._prefixes.clear()


class MetricsScope:
    """Prefix-qualified instrument constructor bound to one registry."""

    def __init__(self, registry: MetricsRegistry, prefix: str):
        self.registry = registry
        self.prefix = prefix

    def _q(self, name: str) -> str:
        return f"{self.prefix}/{name}"

    def counter(self, name: str) -> Counter:
        return self.registry.counter(self._q(name))

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(self._q(name))

    def histogram(self, name: str, cap: int = DEFAULT_HIST_CAP) -> Histogram:
        return self.registry.histogram(self._q(name), cap)

    def counters(self, *names: str) -> Dict[str, Counter]:
        """A batch of counters keyed by their SHORT names — the migration
        shim for what used to be an ad-hoc ``{"alloc": 0, ...}`` dict."""
        return {n: self.counter(n) for n in names}


#: the process-wide plane — serving components register into this one
REGISTRY = MetricsRegistry()
