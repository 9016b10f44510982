"""Serving engines (port of ``ServeEngine``, ``PagedServeEngine`` and
``StaticServeEngine`` from ``repro/serve/engine.py``).

``ServeEngine`` schedules requests over ``max_batch`` persistent decode
slots of one ``ModelRuntime`` of any ported token family (decoder,
``encdec``, ``ssm``, ``hybrid``, ``vlm``):

  * requests enter free slots as others finish (EOS or token budget);
  * each slot carries its own position; decode runs one step over the full
    slot array with per-slot write positions and KV-length masks;
  * admission prefills one request (batch 1, prompt padded to a power-of-two
    bucket) and copies the fresh state into the slot (every leaf along its
    own batch axis: KV caches, Mamba conv and SSM states);
  * with an ``AdapterBank`` on the runtime, row i rotates its activations
    with its own adapter x Q_i before every adapted projection (the
    ``gs_fused_T`` kernel on the card; over int8 weights the fused
    ``gs_q_matmul`` kernel); slot 0 is the identity.

``PagedServeEngine`` keeps the KV cache in fixed-size pages of one shared
pool (``serve/kv.py``), prefills prompts in fixed-width chunks one per tick,
and shares full prompt pages between requests of one adapter.

``StaticServeEngine`` is the drain-queue -> pad -> prefill -> lockstep
decode reference (the paper's merged-weight serving story, §6.1): one
adapter merged into the weights offline (``ModelRuntime(adapters=...,
peft_cfg=...)``, the forward GS kernel on the card), zero per-token
overhead. It refuses a banked runtime.

Every engine samples each row's first token at its own last prompt
position. Requests carry tokens only: as in JAX, the engines feed the vlm
ZERO patches (their P positions lead the stream, so every position and
``last_idx`` is offset by P) and the encoder-decoder ZERO frames
(``max(max_len // 4, 8)`` a slot; the static engine ``max(prompt // 4,
8)``), whose encoder output then carries no request's content. An
engine's counters live in the process metrics plane
(``repro_torch.obs.REGISTRY``, scope ``serve``, ``paged`` or ``static``);
``EngineMetrics`` is the dict-style view. ``tracer=`` takes a
``repro_torch.obs.TraceRecorder``: the engine then records each request's
lifecycle (submit, stalls by reason, prefill spans, tokens, finish), from
which the recorder's SLO monitor reads TTFT and TPOT. ``tracer=None`` (the
default) skips every hook. The engines also carry the surface a
multi-replica driver and the streaming launcher need (``queue_depth``,
``load``, ``add_wall``, ``steal_queued``, ``submit``, ``drain_finished``,
``adapter_stats``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.peft import PrefillRequest
from repro_torch.core.runtime import ModelRuntime
from repro_torch.models import registry
from repro_torch.obs.metrics import REGISTRY
from .kv import KVPagePool, SlotPages, pages_for_budget


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    adapter: Optional[str] = None        # bank adapter name (None = base)
    output: Optional[List[int]] = None
    # timing (perf_counter seconds; filled by the engines)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class EngineMetrics:
    """An engine's stats, backed by the process metrics plane: writes go to
    counters of ``REGISTRY.scope(kind)``, reads keep the dict-style surface
    (``eng.stats["requests"]``) with the JAX engine's keys.
    ``admission_log`` stays a bounded list of ``(rid, decode_step)``
    tuples, a diagnostics ring rather than an instrument."""

    COUNTER_KEYS = ("requests", "tokens_generated", "decode_steps",
                    "prefills", "admission_stalls")

    def __init__(self, kind: str = "serve"):
        scope = REGISTRY.scope(kind)
        self._c = scope.counters(*self.COUNTER_KEYS)
        self._wall = scope.counter("wall_s")
        self.admission_log: List[Any] = []

    def inc(self, key: str, n: int = 1) -> None:
        self._c[key].inc(n)

    def add_wall(self, dt: float) -> None:
        self._wall.inc(dt)

    def log_admission(self, rid: int) -> None:
        log = self.admission_log
        log.append((rid, self._c["decode_steps"].value))
        if len(log) > 4096:          # diagnostics ring, not a ledger
            del log[:-2048]

    def __getitem__(self, key: str) -> Any:
        if key == "admission_log":
            return self.admission_log
        if key == "wall_s":
            return self._wall.value
        return self._c[key].value


def prompt_bucket(plen: int, max_len: int) -> int:
    """Power-of-two prompt pad length (at least 8), clamped to the slot
    cache: the prefill's token count for a prompt of ``plen`` tokens."""
    b = 8
    while b < plen:
        b *= 2
    return min(b, max_len)


def _stream_prefix(cfg: ModelConfig) -> int:
    """Non-text positions prepended to the decode stream: the vlm's
    patches (0 for every other family)."""
    return cfg.frontend_tokens if registry.get(cfg.family).has_patches else 0


def _family_feed(cfg: ModelConfig, toks: np.ndarray, enc_len: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Prefill feed of a (B, S) token block plus the family's extra
    stream, as JAX's engines build it: ZERO frames (B, enc_len, d_model)
    for the encoder-decoder, ZERO patches (B, frontend_tokens,
    frontend_dim) for the vlm (requests carry tokens only)."""
    feed = {"tokens": torch.as_tensor(toks, device=device)}
    b = toks.shape[0]
    t = registry.get(cfg.family)
    if t.has_encoder:
        feed["frames"] = torch.zeros((b, enc_len, cfg.d_model),
                                     dtype=cfg.act_dtype, device=device)
    if t.has_patches:
        feed["patches"] = torch.zeros(
            (b, cfg.frontend_tokens, cfg.frontend_dim), dtype=cfg.act_dtype,
            device=device)
    return feed


def _check_token_family(cfg: ModelConfig) -> None:
    """Token engines need a prefill/decode surface; stateless families
    (``FamilyOps.stateless`` — whole-input forward, no KV) are served by
    ``serve.image.ImageServeEngine`` instead."""
    if registry.get(cfg.family).stateless:
        raise ValueError(
            f"family {cfg.family!r} is stateless (no prefill/decode "
            "surface) — serve it through serve.image.ImageServeEngine")


def _check_capacity(cfg: ModelConfig, prompt: List[int], max_new: int,
                    max_len: int) -> None:
    plen = len(prompt) + _stream_prefix(cfg)
    if plen + max_new > max_len:
        raise ValueError(f"prompt ({plen}) + max_new ({max_new}) "
                         f"exceeds max_len={max_len}")


def latency_percentiles(requests: List[Request],
                        qs=(50, 95)) -> Dict[int, float]:
    """{q: seconds} request-latency percentiles over finished Requests."""
    lats = [r.latency_s for r in requests]
    if not lats:
        return {q: 0.0 for q in qs}
    return {q: float(np.percentile(lats, q)) for q in qs}


def _tracer_hooks(tracer, kind: str):
    """(engine tag, annotate) of an engine: the tag registers the engine
    with the tracer; annotate wraps a dispatch in a named profiler range
    when the tracer asks for it (a no-op without a tracer)."""
    if tracer is None:
        return "", lambda name: contextlib.nullcontext()
    return tracer.register_engine(kind), tracer.annotate


class ServeEngine:
    """Continuous-batching engine over ``max_batch`` slots of one runtime.

    It serves on the runtime's device, which the runtime resolved from its
    own ``device=`` (the card unless the CPU was asked for). ``tracer``: an
    optional ``repro_torch.obs.TraceRecorder`` (see the module docstring).
    """

    _kind = "serve"          # metrics-scope prefix + tracer tag family

    def __init__(self, runtime: ModelRuntime, *, max_batch: int = 8,
                 max_len: int = 256, eos_id: int = 0, tracer=None):
        _check_token_family(runtime.cfg)
        self.rt = runtime
        self.cfg = runtime.cfg
        self.device = runtime.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.tracer = tracer
        self._ttag, self._annot = _tracer_hooks(tracer, self._kind)
        self._enc_len = max(max_len // 4, 8)
        self._prefix = _stream_prefix(self.cfg)

        self._setup_compute()

        self._pos = np.zeros(max_batch, np.int64)
        self._last = np.zeros(max_batch, np.int64)
        self._slot_ids = np.zeros(max_batch, np.int64)
        self._slot_req: List[Optional[Request]] = [None] * max_batch
        self._outs: List[List[int]] = [[] for _ in range(max_batch)]

        self._queue: "collections.deque[Request]" = collections.deque()
        self._next_id = 0
        self._results: Dict[int, List[int]] = {}
        # completed Requests (latency accounting): grows until drained, so
        # long-running streaming drivers call drain_finished()
        self.finished: List[Request] = []
        self.stats = EngineMetrics(self._kind)
        self._ctx_key: Any = None
        self._ctx_val = None

    def _setup_compute(self) -> None:
        """Step closures + device state (the paged engine overrides it)."""
        self._slot_prefill = self.rt.slot_prefill_fn(self.max_len,
                                                     self._enc_len)
        self._decode = self.rt.decode_fn()
        self._state = self.rt.decode_state(self.max_batch, self.max_len,
                                           enc_len=self._enc_len)

    # -- submission -----------------------------------------------------------
    def add_request(self, prompt: List[int], max_new_tokens: int = 16,
                    adapter: Optional[str] = None) -> int:
        self.rt.validate_adapter(adapter)
        _check_capacity(self.cfg, prompt, max_new_tokens, self.max_len)
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, list(prompt), max_new_tokens, adapter=adapter,
                      t_submit=time.perf_counter())
        self._queue.append(req)
        if self.tracer is not None:
            self.tracer.submit(self._ttag, rid, adapter=adapter,
                               prompt_len=len(prompt), t_submit=req.t_submit)
        return rid

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def queue_depth(self) -> int:
        """Requests submitted but not yet slotted (a router's load signal)."""
        return len(self._queue)

    @property
    def load(self) -> int:
        """Queued + in-flight work — a router's balance metric."""
        return self.queue_depth + self.num_active

    @property
    def idle(self) -> bool:
        return not self._queue and self.num_active == 0

    def add_wall(self, dt: float) -> None:
        """Account driver wall time (drivers call this instead of poking
        ``stats``)."""
        self.stats.add_wall(dt)

    # -- multi-replica hooks ---------------------------------------------------
    def steal_queued(self) -> Optional[Request]:
        """Pop the YOUNGEST queued (never-admitted) request so a router can
        move it to a less-loaded replica; None when empty. Stealing from
        the tail keeps FIFO order for what stays."""
        if not self._queue:
            return None
        req = self._queue.pop()
        if self.tracer is not None:        # re-submits on the new engine
            self.tracer.drop(self._ttag, req.rid)
        return req

    def submit(self, req: Request) -> int:
        """Enqueue an existing Request under a FRESH local rid (a moved
        request keeps its submit timestamp and adapter)."""
        self.rt.validate_adapter(req.adapter)
        _check_capacity(self.cfg, req.prompt, req.max_new_tokens,
                        self.max_len)
        req.rid = self._next_id
        self._next_id += 1
        self._queue.append(req)
        if self.tracer is not None:        # keeps the ORIGINAL submit time
            self.tracer.submit(self._ttag, req.rid, adapter=req.adapter,
                               prompt_len=len(req.prompt),
                               t_submit=req.t_submit)
        return req.rid

    # -- internals ------------------------------------------------------------
    def _feed(self, prompt: List[int]) -> Dict[str, torch.Tensor]:
        toks = np.zeros((1, prompt_bucket(len(prompt),
                                          self.max_len - self._prefix)),
                        np.int64)
        toks[0, :len(prompt)] = prompt
        return _family_feed(self.cfg, toks, self._enc_len, self.device)

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        req.output = self._outs[slot][:req.max_new_tokens]
        req.t_done = time.perf_counter()
        self._results[req.rid] = req.output
        self.finished.append(req)
        self.stats.inc("requests")
        self.stats.inc("tokens_generated", len(req.output))
        if self.tracer is not None:
            self.tracer.finish(self._ttag, req.rid)
        self._slot_req[slot] = None
        self._slot_ids[slot] = 0            # identity until re-admitted
        self.rt.release_adapter(req.adapter)

    def _admit(self) -> None:
        """Fill free slots from the queue: batch-1 prefill copied into the
        slot, first token sampled at the prompt's own last position. On a
        store-paged bank a full bank STALLS admission (FIFO head-of-line):
        keep decoding, which is what unpins slots."""
        for slot in range(self.max_batch):
            if not self._queue:
                return
            if self._slot_req[slot] is not None:
                continue
            req = self._queue[0]
            aid = self.rt.acquire_adapter(req.adapter)
            if aid is None:                  # admission stall, not an error
                self.stats.inc("admission_stalls")
                if self.tracer is not None:
                    self.tracer.stall(self._ttag, req.rid, "adapter")
                return
            self._queue.popleft()
            feed = PrefillRequest(
                batch=self._feed(req.prompt),
                last_idx=torch.as_tensor(self._prefix + len(req.prompt) - 1,
                                         device=self.device),
                ctx=self.rt.context([aid]))
            if self.tracer is not None:
                self.tracer.prefill_start(self._ttag, req.rid)
            with self._annot("prefill"):
                first, self._state = self._slot_prefill(
                    self.rt.params, feed, self._state, slot)
            req.t_first = time.perf_counter()
            if self.tracer is not None:
                self.tracer.prefill_end(self._ttag, req.rid)
                self.tracer.first_token(self._ttag, req.rid)
            self.stats.inc("prefills")
            self.stats.log_admission(req.rid)
            self._slot_req[slot] = req
            self._outs[slot] = [first]
            self._pos[slot] = self._prefix + len(req.prompt)
            self._last[slot] = first
            self._slot_ids[slot] = aid
            if first == self.eos_id or req.max_new_tokens <= 1:
                self._finish(slot)
        # every slot is occupied and work is still queued: head-of-line
        # wait on a decode slot, not on a resource
        if self._queue and self.tracer is not None:
            self.tracer.stall(self._ttag, self._queue[0].rid, "queue")

    def _context(self):
        """AdapterContext for the current slot ids, cached across decode
        steps under the key (slot ids, bank version): a store-paged bank
        bumps its version on every page-in and eviction, which remaps
        universal slots to compact ones while the ids stay the same, so a
        context built before can never serve another tenant's factors."""
        key = (tuple(int(i) for i in self._slot_ids),
               getattr(self.rt.bank, "version", 0))
        if key != self._ctx_key:
            self._ctx_val = self.rt.context(self._slot_ids)
            self._ctx_key = key
        return self._ctx_val

    def _row_active(self, slot: int) -> bool:
        """Is this slot decoding? (The paged engine parks slots that are
        still mid chunked prefill.)"""
        return self._slot_req[slot] is not None

    def _decode_launch(self) -> torch.Tensor:
        """Launch one decode step over the full slot array; returns the
        next-token tensor without reading it on the host."""
        tokens = torch.as_tensor(self._last[:, None], device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
        ctx = self._context()
        with self._annot("decode"):
            nt, _, self._state = self._decode(self.rt.params, ctx, tokens,
                                              self._state, pos)
        self.stats.inc("decode_steps")
        return nt

    def _decode_commit(self, nt: torch.Tensor) -> None:
        """Read the step's tokens and advance every decoding slot."""
        vals = nt[:, 0].cpu().numpy()
        for slot in range(self.max_batch):
            if not self._row_active(slot):
                continue
            req = self._slot_req[slot]
            tok = int(vals[slot])
            self._outs[slot].append(tok)
            self._pos[slot] += 1
            self._last[slot] = tok
            if self.tracer is not None:
                self.tracer.token(self._ttag, req.rid)
            if tok == self.eos_id or len(self._outs[slot]) >= req.max_new_tokens:
                self._finish(slot)

    def step_launch(self) -> Optional[torch.Tensor]:
        """First half of a tick: admit into free slots, launch the decode
        step; returns the pending tokens (None when no slot decodes)."""
        self._admit()
        if self.num_active:
            return self._decode_launch()
        return None

    def step_commit(self, pending: Optional[torch.Tensor]) -> bool:
        """Second half of a tick: read and book the launched step. Returns
        True while work remains queued or in flight."""
        if pending is not None:
            self._decode_commit(pending)
        return not self.idle

    def step(self) -> bool:
        """One scheduler tick: admit into free slots, then one decode step
        over all slots. Returns True while work remains (the streaming
        driver's loop condition)."""
        return self.step_commit(self.step_launch())

    def drain_finished(self) -> List[Request]:
        """Hand over (and forget) everything completed so far — the
        bounded-memory accessor for long-running streaming loops (also
        releases the corresponding pending run() results)."""
        out, self.finished = self.finished, []
        for r in out:
            self._results.pop(r.rid, None)
        return out

    def adapter_stats(self) -> Optional[Dict[str, Any]]:
        """Residency counters of a store-paged bank — hit rate, page-in
        latency, evictions, resident / padded bytes (None on eager banks)."""
        stats = getattr(self.rt.bank, "stats", None)
        return stats() if callable(stats) else None

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue to completion; returns {rid: tokens}."""
        t0 = time.perf_counter()
        while self.step():
            pass
        self.stats.add_wall(time.perf_counter() - t0)
        res, self._results = self._results, {}
        return res


class StaticServeEngine:
    """Static-batch reference: drain queue -> pad -> prefill -> lockstep
    decode. One adapter (per deployment) is merged into the runtime's
    weights offline — the paper's zero-overhead serving mode. A banked
    runtime is refused."""

    _kind = "static"

    def __init__(self, runtime: ModelRuntime, *, max_batch: int = 8,
                 max_len: int = 256, eos_id: int = 0, tracer=None):
        _check_token_family(runtime.cfg)
        if runtime.banked:
            raise ValueError(
                "static serving merges ONE adapter offline "
                "(ModelRuntime(adapters=..., peft_cfg=...)); per-request "
                "banks need the continuous ServeEngine")
        self.rt = runtime
        self.cfg = runtime.cfg
        self.device = runtime.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.tracer = tracer
        self._ttag, self._annot = _tracer_hooks(tracer, self._kind)
        self._queue: List[Request] = []
        self._next_id = 0
        self.finished: List[Request] = []    # completed Requests (latency)
        self._prefill = runtime.prefill_fn()
        self._decode = runtime.decode_fn()
        self.stats = EngineMetrics(self._kind)

    def add_request(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        _check_capacity(self.cfg, prompt, max_new_tokens, self.max_len)
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, list(prompt), max_new_tokens,
                      t_submit=time.perf_counter())
        self._queue.append(req)
        if self.tracer is not None:
            self.tracer.submit(self._ttag, rid, prompt_len=len(prompt),
                               t_submit=req.t_submit)
        return rid

    def drain_finished(self) -> List[Request]:
        """Hand over (and forget) the completed-Request history."""
        out, self.finished = self.finished, []
        return out

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def add_wall(self, dt: float) -> None:
        self.stats.add_wall(dt)

    # -- internals ------------------------------------------------------------
    def _run_batch(self, batch: List[Request]) -> None:
        b = len(batch)
        prefix = _stream_prefix(self.cfg)
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(batch):
            toks[i, :len(r.prompt)] = r.prompt          # right-padded
        enc_len = max(plen // 4, 8)
        state = self.rt.decode_state(b, self.max_len, enc_len=enc_len)
        # each row samples at its OWN last prompt position and decodes from
        # its own position counter: padded rows never read the pad tail
        last_idx = np.asarray([prefix + len(r.prompt) - 1 for r in batch],
                              np.int64)
        if self.tracer is not None:
            for r in batch:
                self.tracer.prefill_start(self._ttag, r.rid)
        req = PrefillRequest(
            batch=_family_feed(self.cfg, toks, enc_len, self.device),
            last_idx=torch.as_tensor(last_idx, device=self.device))
        with self._annot("prefill"):
            logits, state = self._prefill(self.rt.params, req, state)
        last = torch.argmax(logits[:, -1], dim=-1)[:, None]
        first = last[:, 0].cpu().numpy()
        self.stats.inc("prefills")
        for r in batch:
            r.t_first = time.perf_counter()
            if self.tracer is not None:
                self.tracer.prefill_end(self._ttag, r.rid)
                self.tracer.first_token(self._ttag, r.rid)

        max_new = max(r.max_new_tokens for r in batch)
        outs = [[int(first[i])] for i in range(b)]
        done = np.asarray([outs[i][0] == self.eos_id or r.max_new_tokens <= 1
                           for i, r in enumerate(batch)])
        pos0 = np.asarray([prefix + len(r.prompt) for r in batch], np.int64)
        for t in range(max_new - 1):
            if done.all():
                break
            with self._annot("decode"):
                last, _, state = self._decode(
                    self.rt.params, None, last, state,
                    torch.as_tensor(pos0 + t, device=self.device))
            self.stats.inc("decode_steps")
            vals = last[:, 0].cpu().numpy()
            for i in range(b):
                if not done[i]:
                    outs[i].append(int(vals[i]))
                    if self.tracer is not None:
                        self.tracer.token(self._ttag, batch[i].rid)
                    done[i] |= (vals[i] == self.eos_id
                                or len(outs[i]) >= batch[i].max_new_tokens)
        for i, r in enumerate(batch):
            r.output = outs[i][:r.max_new_tokens]
            r.t_done = time.perf_counter()
            self.stats.inc("tokens_generated", len(r.output))
            if self.tracer is not None:
                self.tracer.finish(self._ttag, r.rid)

    def run(self) -> Dict[int, List[int]]:
        t0 = time.perf_counter()
        results: Dict[int, List[int]] = {}
        while self._queue:
            batch = self._queue[:self.max_batch]
            self._queue = self._queue[self.max_batch:]
            self._run_batch(batch)
            for r in batch:
                results[r.rid] = r.output
                self.finished.append(r)
                self.stats.inc("requests")
        self.stats.add_wall(time.perf_counter() - t0)
        return results


@dataclasses.dataclass
class _PrefillPlan:
    """One admitted request's remaining chunked-prefill work."""
    slot: int
    req: Request
    sp: SlotPages
    next_start: int          # absolute position of the next chunk's 1st token


class PagedServeEngine(ServeEngine):
    """Continuous batching over a PAGED KV cache with chunked prefill.

    Against the contiguous parent:

      * memory: slots own fixed-size pages of one static pool (sized by
        ``hbm_kv_budget`` bytes or ``num_pages``) through per-slot int32
        page tables, so a short request pays ceil(len / page_size) pages,
        not ``max_len`` rows; an exhausted pool STALLS admission;
      * admission: prompts prefill ``prefill_chunk`` tokens per scheduler
        tick, interleaved with decode, so a long prompt delays the decoding
        slots by one chunk per tick;
      * shared prefixes: full prompt pages are content-hashed (seeded by the
        adapter name) and refcount-shared, and a request's prefill skips
        the cached tokens (``kv_stats()["prefix_hits"]``).

    Greedy tokens equal ``ServeEngine``'s; decode attention runs the paged
    decode kernel on the card. Decoder-family runtimes only: a family
    without a paged surface (``encdec``, ``ssm``, ``hybrid``, ``vlm``) is
    refused up front, as in JAX.
    """

    _kind = "paged"

    def __init__(self, runtime: ModelRuntime, *, max_batch: int = 8,
                 max_len: int = 256, eos_id: int = 0, page_size: int = 8,
                 prefill_chunk: int = 16, num_pages: Optional[int] = None,
                 hbm_kv_budget: Optional[int] = None, tracer=None):
        if runtime._ops.init_paged_state is None:
            raise ValueError(
                f"family {runtime.cfg.family!r} has no paged KV serve path "
                "— use the contiguous ServeEngine")
        if page_size < 1 or prefill_chunk < 1:
            raise ValueError("page_size and prefill_chunk must be >= 1")
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.max_pages = -(-max_len // page_size)
        self._parked = self.max_pages * page_size   # sentinel write position
        if num_pages is None:
            if hbm_kv_budget is not None:
                num_pages = pages_for_budget(runtime.cfg, page_size,
                                             hbm_kv_budget,
                                             runtime.kv_heads)
            else:                       # stall-free default: worst case + 1
                num_pages = max_batch * self.max_pages + 1
        self.num_pages = num_pages
        super().__init__(runtime, max_batch=max_batch, max_len=max_len,
                         eos_id=eos_id, tracer=tracer)
        self._pos[:] = self._parked
        self._decoding = np.zeros(max_batch, bool)
        self._slot_pages: List[Optional[SlotPages]] = [None] * max_batch
        self._prefill_q: "collections.deque[_PrefillPlan]" = \
            collections.deque()

    def _setup_compute(self) -> None:
        self._decode = self.rt.paged_decode_fn()
        self._chunk_prefill = self.rt.chunk_prefill_fn()
        self.pool = KVPagePool(self.num_pages, self.page_size)
        self._state = self.rt.paged_state(self.max_batch, self.num_pages,
                                          self.page_size, self.max_pages)

    # -- scheduling -----------------------------------------------------------
    def _row_active(self, slot: int) -> bool:
        return bool(self._decoding[slot])

    def _set_table_row(self, slot: int, row: np.ndarray) -> None:
        self._state["table"][slot] = torch.as_tensor(row, device=self.device)

    def _admit(self) -> None:
        """Claim a slot, the adapter and KV pages per queued request; the
        prompt itself is fed later, one chunk per tick. Either resource
        exhausted -> stall (stop admitting, keep decoding)."""
        for slot in range(self.max_batch):
            if not self._queue:
                return
            if self._slot_req[slot] is not None:
                continue
            req = self._queue[0]
            aid = self.rt.acquire_adapter(req.adapter)
            if aid is None:
                self.stats.inc("admission_stalls")
                if self.tracer is not None:
                    self.tracer.stall(self._ttag, req.rid, "adapter")
                return
            sp = self.pool.admit(req.adapter, req.prompt, req.max_new_tokens)
            if sp is None:                        # KV stall, not an error
                self.rt.release_adapter(req.adapter)
                self.stats.inc("admission_stalls")
                if self.tracer is not None:
                    self.tracer.stall(self._ttag, req.rid, "kv")
                return
            self._queue.popleft()
            self._set_table_row(slot, self.pool.table_row(
                sp, self.max_pages + 1))
            self._slot_req[slot] = req
            self._slot_ids[slot] = aid
            self._slot_pages[slot] = sp
            self._outs[slot] = []
            self._decoding[slot] = False
            self._pos[slot] = self._parked        # writes park in garbage
            self._prefill_q.append(_PrefillPlan(slot, req, sp,
                                                next_start=sp.n_cached))
        if self._queue and self.tracer is not None:     # all slots occupied
            self.tracer.stall(self._ttag, self._queue[0].rid, "queue")

    def _feed_one_chunk(self) -> None:
        """Advance the HEAD prefill plan by one fixed-width chunk. The last
        chunk yields the request's first token and flips the slot to
        decoding; cached-prefix tokens are never fed."""
        if not self._prefill_q:
            return
        plan = self._prefill_q[0]
        req, slot = plan.req, plan.slot
        plen = len(req.prompt)
        start = plan.next_start
        end = min(start + self.prefill_chunk, plen)
        toks = np.zeros((1, self.prefill_chunk), np.int64)
        toks[0, :end - start] = req.prompt[start:end]
        final = end == plen
        last_local = (plen - 1) - start if final else end - start - 1
        feed = PrefillRequest(
            batch={"tokens": torch.as_tensor(toks, device=self.device)},
            last_idx=torch.as_tensor(last_local, device=self.device),
            ctx=self.rt.context([self._slot_ids[slot]]))
        if self.tracer is not None:                # span per prompt chunk
            self.tracer.prefill_start(self._ttag, req.rid)
        with self._annot("prefill_chunk"):
            first, self._state = self._chunk_prefill(
                self.rt.params, feed, self._state, slot, start)
        if self.tracer is not None:
            self.tracer.prefill_end(self._ttag, req.rid)
        plan.next_start = end
        if not final:
            return
        self._prefill_q.popleft()
        self.pool.register(plan.sp)               # publish full prompt pages
        first = int(first)
        req.t_first = time.perf_counter()
        if self.tracer is not None:
            self.tracer.first_token(self._ttag, req.rid)
        self.stats.inc("prefills")
        self.stats.log_admission(req.rid)
        self._outs[slot] = [first]
        self._pos[slot] = plen
        self._last[slot] = first
        self._decoding[slot] = True
        if first == self.eos_id or req.max_new_tokens <= 1:
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        sp = self._slot_pages[slot]
        super()._finish(slot)
        self._slot_pages[slot] = None
        self._decoding[slot] = False
        self._pos[slot] = self._parked
        self._last[slot] = 0
        self._set_table_row(slot, np.zeros(self.max_pages + 1, np.int32))
        self.pool.finish(sp)

    def step_launch(self) -> Optional[torch.Tensor]:
        """One tick's launch half: admit, feed ONE prompt chunk, launch one
        decode step over the decoding slots."""
        self._admit()
        self._feed_one_chunk()
        if self._decoding.any():
            return self._decode_launch()
        return None

    def kv_stats(self) -> Dict[str, int]:
        """Page-pool counters (allocs, prefix hits, KV stalls, cache
        evictions, pages in use)."""
        return self.pool.stats()
