"""Continuous-batching serving engine (port of ``ServeEngine`` from
``repro/serve/engine.py``).

``ServeEngine`` schedules requests over ``max_batch`` persistent decode
slots of one ``ModelRuntime``:

  * requests enter free slots as others finish (EOS or token budget);
  * each slot carries its own position; decode runs one step over the full
    slot array with per-slot write positions and KV-length masks;
  * admission prefills one request (batch 1, prompt padded to a power-of-two
    bucket) and copies the fresh state into the slot;
  * with an ``AdapterBank`` on the runtime, row i rotates its activations
    with its own adapter x Q_i before every adapted projection (the
    ``gs_fused_T`` kernel on the card); slot 0 is the identity.

Counters are held on the engine (``EngineMetrics``) until the metrics plane
is ported; there is no tracer yet.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.peft import PrefillRequest
from repro_torch.core.runtime import ModelRuntime


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    adapter: Optional[str] = None        # bank adapter name (None = base)
    output: Optional[List[int]] = None
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class EngineMetrics:
    """An engine's stats, read dict-style (``eng.stats["requests"]``) with
    the same keys as the JAX engine's."""

    COUNTER_KEYS = ("requests", "tokens_generated", "decode_steps",
                    "prefills", "admission_stalls")

    def __init__(self):
        self._c: Dict[str, int] = {k: 0 for k in self.COUNTER_KEYS}
        self._wall = 0.0
        self.admission_log: List[Any] = []

    def inc(self, key: str, n: int = 1) -> None:
        self._c[key] += n

    def add_wall(self, dt: float) -> None:
        self._wall += dt

    def log_admission(self, rid: int) -> None:
        log = self.admission_log
        log.append((rid, self._c["decode_steps"]))
        if len(log) > 4096:          # diagnostics ring, not a ledger
            del log[:-2048]

    def __getitem__(self, key: str) -> Any:
        if key == "admission_log":
            return self.admission_log
        if key == "wall_s":
            return self._wall
        return self._c[key]


def prompt_bucket(plen: int, max_len: int) -> int:
    """Power-of-two prompt pad length (at least 8), clamped to the slot
    cache: the prefill's token count for a prompt of ``plen`` tokens."""
    b = 8
    while b < plen:
        b *= 2
    return min(b, max_len)


def _check_capacity(prompt: List[int], max_new: int, max_len: int) -> None:
    if len(prompt) + max_new > max_len:
        raise ValueError(f"prompt ({len(prompt)}) + max_new ({max_new}) "
                         f"exceeds max_len={max_len}")


class ServeEngine:
    """Continuous-batching engine over ``max_batch`` slots of one runtime.

    It serves on the runtime's device, which the runtime resolved from its
    own ``device=`` (the card unless the CPU was asked for)."""

    def __init__(self, runtime: ModelRuntime, *, max_batch: int = 8,
                 max_len: int = 256, eos_id: int = 0):
        self.rt = runtime
        self.cfg = runtime.cfg
        self.device = runtime.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id

        self._slot_prefill = runtime.slot_prefill_fn(max_len)
        self._decode = runtime.decode_fn()
        self._state = runtime.decode_state(max_batch, max_len)

        self._pos = np.zeros(max_batch, np.int64)
        self._last = np.zeros(max_batch, np.int64)
        self._slot_ids = np.zeros(max_batch, np.int64)
        self._slot_req: List[Optional[Request]] = [None] * max_batch
        self._outs: List[List[int]] = [[] for _ in range(max_batch)]

        self._queue: "collections.deque[Request]" = collections.deque()
        self._next_id = 0
        self._results: Dict[int, List[int]] = {}
        self.finished: List[Request] = []
        self.stats = EngineMetrics()
        self._ctx_key: Any = None
        self._ctx_val = None

    # -- submission -----------------------------------------------------------
    def add_request(self, prompt: List[int], max_new_tokens: int = 16,
                    adapter: Optional[str] = None) -> int:
        self.rt.validate_adapter(adapter)
        _check_capacity(prompt, max_new_tokens, self.max_len)
        rid = self._next_id
        self._next_id += 1
        self._queue.append(Request(rid, list(prompt), max_new_tokens,
                                   adapter=adapter,
                                   t_submit=time.perf_counter()))
        return rid

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def idle(self) -> bool:
        return not self._queue and self.num_active == 0

    # -- internals ------------------------------------------------------------
    def _feed(self, prompt: List[int]) -> Dict[str, torch.Tensor]:
        toks = np.zeros((1, prompt_bucket(len(prompt), self.max_len)),
                        np.int64)
        toks[0, :len(prompt)] = prompt
        return {"tokens": torch.as_tensor(toks, device=self.device)}

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        req.output = self._outs[slot][:req.max_new_tokens]
        req.t_done = time.perf_counter()
        self._results[req.rid] = req.output
        self.finished.append(req)
        self.stats.inc("requests")
        self.stats.inc("tokens_generated", len(req.output))
        self._slot_req[slot] = None
        self._slot_ids[slot] = 0            # identity until re-admitted
        self.rt.release_adapter(req.adapter)

    def _admit(self) -> None:
        """Fill free slots from the queue: batch-1 prefill copied into the
        slot, first token sampled at the prompt's own last position."""
        for slot in range(self.max_batch):
            if not self._queue:
                return
            if self._slot_req[slot] is not None:
                continue
            req = self._queue[0]
            aid = self.rt.acquire_adapter(req.adapter)
            if aid is None:                  # admission stall, not an error
                self.stats.inc("admission_stalls")
                return
            self._queue.popleft()
            feed = PrefillRequest(
                batch=self._feed(req.prompt),
                last_idx=torch.as_tensor(len(req.prompt) - 1,
                                         device=self.device),
                ctx=self.rt.context([aid]))
            first, self._state = self._slot_prefill(self.rt.params, feed,
                                                    self._state, slot)
            req.t_first = time.perf_counter()
            self.stats.inc("prefills")
            self.stats.log_admission(req.rid)
            self._slot_req[slot] = req
            self._outs[slot] = [first]
            self._pos[slot] = len(req.prompt)
            self._last[slot] = first
            self._slot_ids[slot] = aid
            if first == self.eos_id or req.max_new_tokens <= 1:
                self._finish(slot)

    def _context(self):
        """AdapterContext for the current slot ids, rebuilt only when the
        ids change."""
        key = tuple(int(i) for i in self._slot_ids)
        if key != self._ctx_key:
            self._ctx_val = self.rt.context(self._slot_ids)
            self._ctx_key = key
        return self._ctx_val

    def _decode_tick(self) -> None:
        """One decode step over the full slot array."""
        tokens = torch.as_tensor(self._last[:, None], device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
        nt, _, self._state = self._decode(self.rt.params, self._context(),
                                          tokens, self._state, pos)
        self.stats.inc("decode_steps")
        vals = nt[:, 0].cpu().numpy()
        for slot in range(self.max_batch):
            req = self._slot_req[slot]
            if req is None:
                continue
            tok = int(vals[slot])
            self._outs[slot].append(tok)
            self._pos[slot] += 1
            self._last[slot] = tok
            if tok == self.eos_id or len(self._outs[slot]) >= req.max_new_tokens:
                self._finish(slot)

    def step(self) -> bool:
        """One scheduler tick: admit into free slots, then one decode step
        over all slots. Returns True while work remains."""
        self._admit()
        if self.num_active:
            self._decode_tick()
        return not self.idle

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue to completion; returns {rid: tokens}."""
        t0 = time.perf_counter()
        while self.step():
            pass
        self.stats.add_wall(time.perf_counter() - t0)
        res, self._results = self._results, {}
        return res
