"""Batched serving for STATELESS families (``FamilyOps.stateless`` — one
whole-input forward, no KV): the image-classification lane (port of
``repro/serve/image.py``).

``ImageServeEngine`` is a tick-batched driver over ``ModelRuntime.infer_fn``
— the same runtime surface the token engines drive, so everything attached
there rides along unchanged: per-request adapter banks (eager or
AdapterStore-paged, any bankable ``core.methods`` entry) and int8 base
weights. Each scheduler tick admits up to ``max_batch`` queued requests
(claiming their bank slots; a store-paged acquire may STALL exactly like
token admission), stacks their images into one fixed-shape batch (empty rows
are zero images on the identity slot 0), and runs ONE forward whose
``AdapterContext`` routes row i through adapter ids[i]: on the card the
GSOFT rows rotate through ``gs_fused_T_bank`` (int8: ``gs_q_matmul_bank``)
by slot id, OFT / BOFT rows through ``bdmm``.

The engine has the token engines' surface (``add_request`` /
``step_launch`` / ``step_commit`` / ``steal_queued`` / ``submit`` /
``stats`` / ``adapter_stats``) and their tracer hooks: a classification
"token" is the argmax class, one per request. Full logits are kept per
request (``Request.logits`` and ``result_logits``) — certification needs
the top-2 margin, not just the class.

Token engines refuse stateless families up front (``serve.engine``); this
engine refuses families WITH a decode surface symmetrically.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.runtime import ModelRuntime
from repro_torch.models import registry
from .engine import EngineMetrics, Request, _tracer_hooks


def _check_image(cfg: ModelConfig, image) -> np.ndarray:
    img = np.asarray(image, np.float32)
    want = (cfg.image_size, cfg.image_size, cfg.in_channels)
    if img.shape != want:
        raise ValueError(f"image shape {img.shape} != {want} "
                         f"(config {cfg.name!r})")
    return img


class ImageServeEngine:
    """Tick-batched stateless serving over one ``ModelRuntime``."""

    _kind = "image"

    def __init__(self, runtime: ModelRuntime, *, max_batch: int = 8,
                 tracer=None):
        if not registry.get(runtime.cfg.family).stateless:
            raise ValueError(
                f"family {runtime.cfg.family!r} has a prefill/decode "
                "surface — serve it through ServeEngine/PagedServeEngine")
        self.rt = runtime
        self.cfg = runtime.cfg
        self.device = runtime.device
        self.max_batch = max_batch
        self.tracer = tracer
        self._ttag, self._annot = _tracer_hooks(tracer, self._kind)
        self._infer = runtime.infer_fn()
        self._queue: "collections.deque[Request]" = collections.deque()
        self._active: List[Request] = []     # launched, not yet committed
        self._next_id = 0
        self._results: Dict[int, List[int]] = {}
        self.result_logits: Dict[int, np.ndarray] = {}
        self.finished: List[Request] = []
        self.stats = EngineMetrics(self._kind)

    # -- submission -----------------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 1,
                    adapter: Optional[str] = None) -> int:
        """Enqueue one image (the ``prompt`` field carries the (H, W, C)
        array — field names match the token engines so drivers need no
        image-specific casing); the response is a single class "token".
        ``max_new_tokens`` is accepted for surface uniformity and ignored."""
        del max_new_tokens
        self.rt.validate_adapter(adapter)
        img = _check_image(self.cfg, prompt)
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, img, max_new_tokens=1, adapter=adapter,
                      t_submit=time.perf_counter())
        self._queue.append(req)
        if self.tracer is not None:
            self.tracer.submit(self._ttag, rid, adapter=adapter,
                               t_submit=req.t_submit)
        return rid

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def load(self) -> int:
        return self.queue_depth + self.num_active

    @property
    def idle(self) -> bool:
        return not self._queue and not self._active

    def add_wall(self, dt: float) -> None:
        self.stats.add_wall(dt)

    # -- multi-replica hooks ---------------------------------------------------
    def steal_queued(self) -> Optional[Request]:
        """Pop the YOUNGEST queued request for rebalancing."""
        if not self._queue:
            return None
        req = self._queue.pop()
        if self.tracer is not None:        # re-submits on the new engine
            self.tracer.drop(self._ttag, req.rid)
        return req

    def submit(self, req: Request) -> int:
        """Enqueue an existing Request under a fresh local rid (a moved
        request keeps its image, adapter and submit timestamp)."""
        self.rt.validate_adapter(req.adapter)
        _check_image(self.cfg, req.prompt)
        req.rid = self._next_id
        self._next_id += 1
        self._queue.append(req)
        if self.tracer is not None:        # keeps the ORIGINAL submit time
            self.tracer.submit(self._ttag, req.rid, adapter=req.adapter,
                               t_submit=req.t_submit)
        return req.rid

    # -- scheduling -----------------------------------------------------------
    def step_launch(self) -> Optional[torch.Tensor]:
        """Admit up to ``max_batch`` queued requests (pinning their bank
        slots; a store-paged acquire stall stops admission for this tick —
        committing the partial batch is what unpins slots) and launch ONE
        batched forward. Returns the pending logits without reading them on
        the host."""
        admitted: List[Request] = []
        ids: List[int] = []
        while self._queue and len(admitted) < self.max_batch:
            req = self._queue[0]
            aid = self.rt.acquire_adapter(req.adapter)
            if aid is None:                  # admission stall, not an error
                self.stats.inc("admission_stalls")
                if self.tracer is not None:
                    self.tracer.stall(self._ttag, req.rid, "adapter")
                break
            self._queue.popleft()
            admitted.append(req)
            ids.append(aid)
        if not admitted:
            if self._queue and not self._active:
                raise RuntimeError(
                    "image admission deadlock: nothing in flight and the "
                    "bank cannot admit the queue head — the device budget "
                    "is too small for even one adapter of its method")
            return None
        # fixed batch shape; empty rows are zero images on the identity slot
        # (their logits are computed and discarded)
        batch = np.zeros((self.max_batch, self.cfg.image_size,
                          self.cfg.image_size, self.cfg.in_channels),
                         np.float32)
        slot_ids = np.zeros(self.max_batch, np.int64)
        for i, req in enumerate(admitted):
            batch[i] = req.prompt
            slot_ids[i] = ids[i]
        ctx = self.rt.context(slot_ids)
        if self.tracer is not None:          # the forward IS the prefill
            for r in admitted:
                self.tracer.prefill_start(self._ttag, r.rid)
        with self._annot("infer"):
            logits = self._infer(self.rt.params, ctx,
                                 torch.as_tensor(batch, device=self.device))
        self._active = admitted
        self.stats.inc("decode_steps")
        for r in admitted:
            self.stats.log_admission(r.rid)
        return logits

    def step_commit(self, pending: Optional[torch.Tensor]) -> bool:
        """Read the launched batch, record each request's class + logits,
        release bank pins. Returns True while work remains."""
        if pending is not None:
            vals = pending.to(torch.float32).cpu().numpy()   # (max_batch, C)
            now = time.perf_counter()
            for i, req in enumerate(self._active):
                logits = vals[i]
                req.output = [int(logits.argmax())]
                req.logits = logits
                req.t_first = req.t_done = now
                self._results[req.rid] = req.output
                self.result_logits[req.rid] = logits
                self.finished.append(req)
                self.stats.inc("requests")
                self.stats.inc("tokens_generated")
                if self.tracer is not None:
                    self.tracer.prefill_end(self._ttag, req.rid)
                    self.tracer.first_token(self._ttag, req.rid)
                    self.tracer.finish(self._ttag, req.rid)
                self.rt.release_adapter(req.adapter)
            self._active = []
        return not self.idle

    def step(self) -> bool:
        return self.step_commit(self.step_launch())

    def drain_finished(self) -> List[Request]:
        """Hand over (and forget) everything completed so far."""
        out, self.finished = self.finished, []
        for r in out:
            self._results.pop(r.rid, None)
            self.result_logits.pop(r.rid, None)
        return out

    def adapter_stats(self) -> Optional[Dict[str, Any]]:
        """Residency counters of a store-paged bank (None on eager)."""
        stats = getattr(self.rt.bank, "stats", None)
        return stats() if callable(stats) else None

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; {rid: [class]}. Full logits stay readable in
        ``result_logits`` until ``drain_finished``."""
        t0 = time.perf_counter()
        while self.step():
            pass
        self.stats.add_wall(time.perf_counter() - t0)
        res, self._results = self._results, {}
        return res
