"""Serving launcher (port of ``repro/launch/serve.py``): the continuous,
paged and static engines over a smoke or full config, streaming Poisson
arrivals, per-request adapter banks, and the image lane.

    # continuous batching, mixed-length synthetic traffic
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
        --smoke --requests 16 --prompt-len 12 --max-new 8 --mixed-lengths
    # streaming arrivals at 4 req/s
    ... --arch qwen2-72b --smoke --requests 16 --arrival-rate 4
    # paged KV engine over int8 base weights and a 3-tenant GSOFT bank
    ... --arch qwen2-72b --smoke --engine paged --quantize int8 \\
        --demo-adapters 3
    # static engine over one GSOFT adapter merged into the weights
    ... --arch qwen2-72b --smoke --engine static --peft-demo
    # named adapters from checkpoints; requests round-robin over them
    ... --adapters alice=/ckpts/alice bob=/ckpts/bob
    # a mixed-method demo bank, saved and reloaded through the loader
    ... --demo-adapters 3 --demo-methods gsoft,boft,householder \\
        --save-adapters /tmp/bank
    # a thousand-tenant adapter checkpoint as a disk-backed store, paged
    # into device memory under a fixed budget (LRU eviction)
    ... --store-dir /ckpts/tenants --hbm-adapter-budget 64
    # image lane: batched stateless serving of the 1-Lipschitz convnet with
    # per-request conv adapters (same bank / store / quantize flags)
    ... --arch lipconvnet-15 --smoke --family image --requests 16 \\
        --demo-adapters 3
    # observability: per-request trace spans (TTFT / TPOT / stall
    # attribution) exported for chrome://tracing, a periodic SLO report,
    # a JSON tick log
    ... --arch qwen2-72b --smoke --requests 16 --arrival-rate 8 --trace \\
        --trace-out /tmp/trace.json --report-interval 1 --log-json
    # the Mamba2 families on the continuous lane
    ... --arch zamba2-2.7b --smoke
    # the encoder-decoder (merged) and the vlm (a per-request bank that
    # rotates its patch projection too)
    ... --arch seamless-m4t-medium --smoke --peft-demo
    ... --arch pixtral-12b --smoke --demo-adapters 3
    # N engine replicas behind one EngineCluster (adapter-affinity routing;
    # each replica its own KV and its own paged bank, the params shared)
    ... --arch qwen2-72b --smoke --replicas 2 --demo-adapters 8 \
        --hbm-adapter-budget 2
    # tensor-parallel serving, one process per rank
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen2-72b --smoke --tp 2 --engine paged --quantize int8

The JAX launcher's flags for these lanes plus ``--device`` (default
``cuda``: without a card it raises unless ``--device cpu`` is given) and
``--max-len`` (default: the vlm's patches + prompt + new tokens + 8, as
the JAX launcher computes it). ``--adapters``, ``--demo-adapters`` and ``--store-dir`` are
exclusive, ``--peft-demo`` excludes all three; ``--hbm-adapter-budget``
pages the first two's bank too. ``--arrival-rate`` streams Poisson arrivals
(seeded) into the continuous engine (and the image lane); the static engine
drains one queue. ``--trace``, ``--trace-out`` and ``--report-interval``
attach one ``TraceRecorder`` + ``SLOMonitor`` to the engine.

Every lane but the static one serves through an ``EngineCluster``, also at
``--replicas 1``, and prints ``format_cluster_report(cluster_stats())``
as its report. ``--replicas N`` shares one runtime across the replicas
unless the bank is store-paged, which gets a fresh ``attach`` per replica;
``--replicas`` with ``--engine static`` is refused. ``--tp N`` (or
``--mesh 1,N``) serves the model split over N ranks, one process each
(started by ``torchrun``): every rank builds ``serve_mesh`` and its
runtime, draws the same seeded requests, and rank 0 decides each
streaming tick's admissions and broadcasts them; rank 0 alone prints.
``--tp 1`` runs the degenerate mesh in one process (``--backend gloo``
lets several ranks share one card, which NCCL refuses). The decoder,
``ssm`` and ``hybrid`` families split; an MoE decoder (``--arch
qwen3-moe-30b-a3b``) splits its experts over the ranks (expert
parallelism: every rank routes every token, runs its own experts and the
partial outputs are summed), with a bank on its attention projections
only (a bank on the experts is refused, as in JAX). ``--mesh D,N`` with
D > 1 adds a 'data' axis:
each group of N ranks serves every request (a replica of the split
model; the decode step's own batch split over 'data' is
``train.steps.local_rows`` / ``gather_rows`` around ``build_decode_step``). ``--tp`` with ``--mesh``
is refused; ``--tp`` over the ``image`` family raises
NotImplementedError, as do ``--quantize fp8`` and ``--tp N > 1`` or
``--mesh`` over the ``encdec`` and ``vlm`` families (their mesh port is a
later slice). ``--family`` is checked against the arch's family;
``ssm`` / ``hybrid`` archs fail as in the JAX launcher on ``--engine
paged`` (no paged KV surface) and ``--demo-adapters`` (no bank serving:
the first prefill raises); so do ``encdec`` archs (``--demo-adapters``:
no bank, served merged with ``--peft-demo``) and ``vlm`` archs on
``--engine paged``. The vlm's ``max_len`` default counts its patches, as
the JAX launcher's does.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import time

import numpy as np
import torch

from repro_torch.config import get_config, get_smoke_config, parse_overrides
from repro_torch.core import peft as peft_lib
from repro_torch.core.runtime import ModelRuntime
from repro_torch.distrib.cluster import EngineCluster, format_cluster_report
from repro_torch.distrib.tp import SPLIT_FAMILIES, close_world, serve_mesh
from repro_torch.models import registry
from repro_torch.obs import SLOMonitor, TraceRecorder
from repro_torch.quant import tree_bytes
from repro_torch.serve.engine import (PagedServeEngine, ServeEngine,
                                      StaticServeEngine, latency_percentiles)
from repro_torch.serve.image import ImageServeEngine
from repro_torch.store import (AdapterStore, PagedAdapterBank,
                               load_adapter_checkpoints)


def make_demo_adapters(names, params, peft_cfg, device, seed: int = 1,
                       scale: float = 0.1):
    """Random (non-identity) adapters, one per name: identity-initialized
    ``init_peft`` trees plus seeded normal noise. ``peft_cfg`` is a single
    PEFTConfig or a {name: PEFTConfig} mapping (mixed-method demo banks).
    Stand-ins for real fine-tunes in demos and benchmarks."""
    out = {}
    for i, name in enumerate(names):
        cfg = peft_cfg[name] if isinstance(peft_cfg, dict) else peft_cfg
        ad = peft_lib.init_peft(cfg, params, device=device, seed=seed + i)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1000 + i)
        out[name] = {path: {k: v + scale * torch.randn(
                         v.shape, generator=gen, device=device, dtype=v.dtype)
                         for k, v in entry.items()}
                     for path, entry in ad.items()}
    return out


def drive_streaming(eng, requests, arrivals, tick_hook=None, sync=None):
    """Admit requests as they 'arrive' (``arrivals``: seconds from the start,
    non-decreasing) while stepping the engine; returns {rid: output} once
    traffic drains. ``tick_hook`` (optional) runs after every scheduler
    tick — the launcher's periodic SLO report / --log-json emitter. A
    driver that holds admission (``eng.accepting`` False) HOLDS arrivals
    until it accepts again — backpressure, not drops. ``sync`` (ranks of a
    split model: ``TPShard.broadcast_ints``) hands every rank rank 0's
    count of admitted requests each tick, so clocks that differ between
    ranks never admit different requests."""
    t0 = time.perf_counter()
    i = 0
    while i < len(requests) or not eng.idle:
        now = time.perf_counter() - t0
        n = i
        while (n < len(requests) and arrivals[n] <= now
               and getattr(eng, "accepting", True)):
            n += 1
        if sync is not None:
            n = sync([n])[0]
        for req in requests[i:n]:
            eng.add_request(**req)
        i = n
        if eng.idle:                     # nothing in flight: wait for traffic
            time.sleep(min(0.005, max(arrivals[i] - now, 0.0)))
            continue
        eng.step()
        if tick_hook is not None:
            tick_hook()
    eng.add_wall(time.perf_counter() - t0)
    return {r.rid: r.output for r in eng.finished}


def make_tick_observer(eng, slo, interval, log_json):
    """Per-tick callback: every ``interval`` seconds (every tick when 0)
    emit either the human SLO report or one ``--log-json`` record — the
    machine-readable mirror of the same numbers."""
    state = {"t0": time.perf_counter(), "last": time.perf_counter()}

    def observe():
        now = time.perf_counter()
        if interval > 0 and now - state["last"] < interval:
            return
        state["last"] = now
        if log_json:
            rec = {"event": "tick", "t_s": round(now - state["t0"], 6),
                   "queue_depth": eng.queue_depth,
                   "active": eng.num_active,
                   "requests": eng.stats["requests"],
                   "tokens_generated": eng.stats["tokens_generated"],
                   "decode_steps": eng.stats["decode_steps"],
                   "prefills": eng.stats["prefills"],
                   "admission_stalls": eng.stats["admission_stalls"]}
            if slo is not None:
                rec["slo"] = slo.report()
            print(json.dumps(rec))
        elif slo is not None:
            print(SLOMonitor.format_report(slo.report()))

    return observe


def describe(eng, results, engine_name: str, dt: float) -> None:
    toks = eng.stats["tokens_generated"]
    lat = latency_percentiles(eng.finished)
    print(f"[{engine_name}] served {len(results)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks / max(dt, 1e-9):.1f} tok/s, "
          f"{eng.stats['decode_steps']} decode steps, "
          f"{eng.stats['prefills']} prefills)")
    print(f"latency p50={lat[50] * 1e3:.0f}ms p95={lat[95] * 1e3:.0f}ms")


def _refuse_unported(args) -> None:
    if args.quantize == "fp8":
        raise NotImplementedError(
            "--quantize fp8 is not ported (the JAX fp8 path is a stub)")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.replicas > 1 and args.engine == "static":
        raise SystemExit("--replicas needs a steppable engine "
                         "(continuous/paged) — the static engine drains "
                         "one batch at a time")
    if args.family is not None and args.family not in registry.families():
        raise SystemExit(f"--family {args.family} is not a registered "
                         f"family ({registry.families()})")


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--family", default=None,
                    help="assert the arch's registered family (--family "
                         "image routes through the batched stateless "
                         "ImageServeEngine)")
    ap.add_argument("--engine", choices=("continuous", "static", "paged"),
                    default="continuous",
                    help="'paged': fixed-size KV pages + per-slot page "
                         "tables, chunked prefill, shared-prefix caching; "
                         "'static': drain-queue batches on merged weights")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="slot capacity in tokens (0: prompt + new + 8)")
    ap.add_argument("--mixed-lengths", action="store_true",
                    help="prompt lens U[4, prompt_len], budgets U[2, max_new]")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals (req/s); 0 = all queued up front")
    ap.add_argument("--mesh", default=None,
                    help="'data,model' mesh shape for tensor-parallel "
                         "serving (one process per rank, via torchrun)")
    ap.add_argument("--tp", type=int, default=0,
                    help="shorthand for --mesh 1,N: split the model over N "
                         "ranks at serve time")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend of --tp / --mesh (default: "
                         "NCCL on cards, gloo on the CPU)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="run N engine replicas behind an EngineCluster "
                         "with adapter-affinity routing")
    ap.add_argument("--adapters", nargs="*", default=[],
                    help="load named adapters into a per-request bank "
                         "(name=ckpt_dir or ckpt_dir)")
    ap.add_argument("--store-dir", default=None,
                    help="serve an adapter-bank checkpoint as a disk-backed "
                         "store: adapters page into device memory on "
                         "admission")
    ap.add_argument("--hbm-adapter-budget", type=int, default=0,
                    help="most adapters resident on the device at once "
                         "(slot-compacted, LRU-paged); 0 = all")
    ap.add_argument("--demo-adapters", type=int, default=0,
                    help="fabricate N random adapters as a demo bank")
    ap.add_argument("--demo-methods", default="gsoft",
                    help="comma-list of registered methods assigned round-"
                         "robin to the demo adapters (mixed-method bank), "
                         "e.g. gsoft,boft,householder")
    ap.add_argument("--save-adapters", default=None,
                    help="save the (demo) bank to this checkpoint dir and "
                         "reload it through the round-trip path")
    ap.add_argument("--peft-demo", action="store_true",
                    help="merge one GSOFT adapter into the weights before "
                         "serving (paper §6.1: zero overhead)")
    ap.add_argument("--quantize", choices=("none", "int8", "fp8"),
                    default="none",
                    help="serve with int8 base weights (per channel); the "
                         "adapter rotations stay in float")
    ap.add_argument("--page-size", type=int, default=8,
                    help="KV page size in tokens (paged engine)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens fed per scheduler tick (paged engine)")
    ap.add_argument("--hbm-kv-budget", type=int, default=0,
                    help="KV pool budget in BYTES (paged engine); 0 = a "
                         "stall-free worst-case pool")
    ap.add_argument("--trace", action="store_true",
                    help="record per-request lifecycle spans (submit / "
                         "stall / prefill / tokens / finish) with TTFT / "
                         "TPOT; every lane including --family image")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export finished traces: .jsonl = one event per "
                         "line, anything else = Chrome trace_event JSON; "
                         "implies --trace")
    ap.add_argument("--report-interval", type=float, default=0.0,
                    help="print the sliding-window SLO report every N "
                         "seconds while serving; implies --trace")
    ap.add_argument("--log-json", action="store_true",
                    help="emit structured per-tick JSON records to stdout "
                         "(throttled by --report-interval) and a summary")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _bank(args, cfg, rt):
    """The runtime with the requested adapter bank or store attached, and
    the adapter names requests round-robin over."""
    budget = args.hbm_adapter_budget or None
    if sum(map(bool, (args.adapters, args.demo_adapters,
                      args.store_dir))) > 1:
        raise SystemExit("--adapters / --demo-adapters / --store-dir are "
                         "exclusive: load a saved bank, fabricate one, OR "
                         "serve a checkpoint dir as a paged store")
    if args.save_adapters and not (args.adapters or args.demo_adapters):
        raise SystemExit("--save-adapters needs a bank to save: pass "
                         "--demo-adapters N or --adapters name=dir")
    if args.peft_demo and (args.adapters or args.demo_adapters or
                           args.store_dir):
        raise SystemExit("--peft-demo merges an adapter INTO the weights; "
                         "combining it with a per-request bank would rotate "
                         "already-rotated activations — pick one")
    if args.store_dir:
        store = AdapterStore.open(args.store_dir)
        rt = rt.attach(store, hbm_budget=budget)
        print(f"adapter store: {len(store)} adapters on disk/host, device "
              f"capacity {rt.bank.capacity} (per-method {rt.bank.caps})")
        return rt, list(store.names)
    if not (args.adapters or args.demo_adapters):
        return rt, []
    if args.demo_adapters:
        meths = [m.strip() for m in args.demo_methods.split(",")
                 if m.strip()]
        if not meths:
            raise SystemExit("--demo-methods needs at least one registered "
                             "method (e.g. gsoft,boft,householder)")
        names = [f"a{i}" for i in range(args.demo_adapters)]
        bank_peft = {name: peft_lib.PEFTConfig(
                         method=meths[i % len(meths)], block_size=8,
                         use_pallas=cfg.use_pallas)
                     for i, name in enumerate(names)}
        adapters_by_name = make_demo_adapters(names, rt.param_shapes,
                                              bank_peft, rt.device)
    else:
        adapters_by_name, bank_peft = load_adapter_checkpoints(
            args.adapters, device=rt.device)
    if args.save_adapters:
        AdapterStore.from_adapters(adapters_by_name,
                                   bank_peft).save(args.save_adapters)
        adapters_by_name, bank_peft = load_adapter_checkpoints(
            [args.save_adapters], device=rt.device)
        print(f"round-tripped {list(adapters_by_name)} through "
              f"{args.save_adapters}")
    rt = rt.attach(adapters_by_name, bank_peft, hbm_budget=budget)
    print(f"adapter bank: {rt.bank.num_slots} slots {list(rt.bank.names)}, "
          f"methods {list(rt.bank.bank_methods)}")
    return rt, list(adapters_by_name)


def _traffic(args, cfg, stateless: bool, names, rng):
    requests = []
    for i in range(args.requests):
        if stateless:       # one image in, one class out: the prompt IS the
            req = {"prompt": rng.normal(size=(      # (H, W, C) array
                       cfg.image_size, cfg.image_size,
                       cfg.in_channels)).astype(np.float32),
                   "max_new_tokens": 1}
        else:
            plen = (int(rng.integers(4, args.prompt_len + 1))
                    if args.mixed_lengths else args.prompt_len)
            mnew = (int(rng.integers(2, args.max_new + 1))
                    if args.mixed_lengths else args.max_new)
            req = {"prompt": rng.integers(1, min(cfg.vocab_size, 255),
                                          size=plen).tolist(),
                   "max_new_tokens": mnew}
        if names:
            req["adapter"] = names[i % len(names)]
        requests.append(req)
    return requests


def _mesh(args, cfg):
    """The serve mesh of ``--tp`` / ``--mesh`` (None without either)."""
    if not (args.tp or args.mesh):
        return None
    if args.tp and args.mesh:
        raise SystemExit("--tp is shorthand for --mesh 1,N — pass one or "
                         "the other")
    if args.tp:
        dp, tp = 1, args.tp
    else:
        dp, tp = (int(x) for x in args.mesh.split(","))
    t = registry.get(cfg.family)
    if (t.has_encoder or t.has_patches) and (tp > 1 or args.mesh):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on a mesh (--tp {args.tp}, --mesh "
            f"{args.mesh}) is not ported: the encdec / vlm mesh item of "
            "ROADMAP Queue 1 (JAX shards them by GSPMD)")
    if tp > 1 and cfg.family not in SPLIT_FAMILIES:
        raise NotImplementedError(
            f"tensor-parallel serving of the {cfg.family!r} family is not "
            f"ported (the {SPLIT_FAMILIES} families split)")
    return serve_mesh(tp, dp, device=args.device, backend=args.backend)


def main(argv=None) -> int:
    args = _parse(argv)
    _refuse_unported(args)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.with_overrides(**parse_overrides(args.set))
    if args.family and not registry.is_family(cfg, args.family):
        raise SystemExit(f"--family {args.family} but arch {args.arch!r} "
                         f"registers family {cfg.family!r}")
    stateless = registry.get(cfg.family).stateless
    if stateless and args.engine != "continuous":
        raise SystemExit(f"family {cfg.family!r} is stateless (no KV) — "
                         "it serves through the batched image engine "
                         "(--engine continuous, the default)")
    started = not torch.distributed.is_initialized()
    mesh = _mesh(args, cfg)
    base_rt = ModelRuntime(cfg, device=args.device, mesh=mesh)
    # every rank of a split model serves; rank 0 alone prints
    quiet = base_rt.shard is not None and base_rt.shard.rank != 0
    with contextlib.redirect_stdout(io.StringIO()) if quiet else \
            contextlib.nullcontext():
        rc = _serve(args, cfg, stateless, mesh, base_rt)
    if mesh is not None and started:
        close_world()
    return rc


def _serve(args, cfg, stateless: bool, mesh, base_rt) -> int:
    max_len = args.max_len or (cfg.frontend_tokens + args.prompt_len
                               + args.max_new + 8)
    budget = args.hbm_adapter_budget or None

    rt, adapter_names = _bank(args, cfg, base_rt)
    if args.peft_demo:          # merged single-adapter demo (static story)
        peft_cfg = peft_lib.PEFTConfig(method="gsoft", block_size=8)
        adapters = peft_lib.init_peft(peft_cfg, rt.param_shapes,
                                      device=rt.device, seed=1)
        # a split model draws each weight again, merges it and keeps its
        # slice before the next
        rt = ModelRuntime(cfg, None if rt.shard is not None else rt.params,
                          device=rt.device, mesh=mesh, adapters=adapters,
                          peft_cfg=peft_cfg)
    if args.quantize != "none":     # after any merge / bank: rotations float
        before = tree_bytes(rt.params)
        rt = rt.quantized(args.quantize, release_source=True)
        after = tree_bytes(rt.params)
        print(f"quantized base weights ({args.quantize}): params "
              f"{before / 1e6:.2f} MB -> {after / 1e6:.2f} MB "
              f"({before / max(after, 1):.2f}x smaller)")

    def replica_runtimes(n: int):
        """Runtimes for N engine replicas. A bankless, eager-bank, merged
        or quantized runtime is SHARED (each engine keeps its own KV state;
        the params exist once). Only a store-paged bank gets a fresh
        ``attach`` per replica: paging state (residency, pins, LRU order)
        must be per replica for affinity routing to mean anything."""
        if n == 1 or not isinstance(rt.bank, PagedAdapterBank):
            return [rt] * n
        out = [rt]
        for _ in range(n - 1):
            out.append(rt.attach(rt.bank.store, hbm_budget=budget))
        return out

    want_trace = (args.trace or args.trace_out is not None
                  or args.report_interval > 0)
    slo = SLOMonitor(window=256) if want_trace else None
    tracer = TraceRecorder(slo=slo) if want_trace else None
    if args.engine == "static":
        if rt.banked:
            raise SystemExit("--adapters needs --engine continuous "
                             "(static serving merges ONE adapter offline)")
        eng = StaticServeEngine(rt, max_batch=args.max_batch,
                                max_len=max_len, tracer=tracer)
    else:
        rts = replica_runtimes(args.replicas)
        if stateless:
            engines = [ImageServeEngine(r, max_batch=args.max_batch,
                                        tracer=tracer) for r in rts]
        elif args.engine == "paged":
            engines = [PagedServeEngine(r, max_batch=args.max_batch,
                                        max_len=max_len,
                                        page_size=args.page_size,
                                        prefill_chunk=args.prefill_chunk,
                                        hbm_kv_budget=args.hbm_kv_budget
                                        or None, tracer=tracer)
                       for r in rts]
        else:
            engines = [ServeEngine(r, max_batch=args.max_batch,
                                   max_len=max_len, tracer=tracer)
                       for r in rts]
        # N=1 rides the same cluster path: the report below IS
        # cluster_stats(), a single replica being its degenerate case
        eng = EngineCluster(engines, slo=slo)

    rng = np.random.default_rng(0)
    names = adapter_names if rt.banked else []
    requests = _traffic(args, cfg, stateless, names, rng)
    tick_hook = None
    if args.log_json or (args.report_interval > 0 and slo is not None):
        tick_hook = make_tick_observer(eng, slo, args.report_interval,
                                       args.log_json)

    t0 = time.perf_counter()
    if args.arrival_rate > 0 and args.engine == "continuous":
        arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                             size=args.requests))
        sync = rt.shard.broadcast_ints if rt.shard is not None else None
        results = drive_streaming(eng, requests, arrivals, tick_hook, sync)
    else:
        if args.arrival_rate > 0:
            print(f"note: the {args.engine} engine ignores arrival times "
                  "(all requests are queued up front)")
        for req in requests:
            eng.add_request(**req)
        if tick_hook is not None and hasattr(eng, "step"):
            t0r = time.perf_counter()
            while eng.step():
                tick_hook()
            eng.add_wall(time.perf_counter() - t0r)
            results = {r.rid: r.output for r in eng.finished}
        else:
            results = eng.run()
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    dt = time.perf_counter() - t0

    describe(eng, results, args.engine, dt)
    if isinstance(eng, EngineCluster):
        # the one residency / routing report: replica rows carry the bank
        # and KV-pool residency (and the SLO block when tracing is on)
        print(format_cluster_report(eng.cluster_stats()))
    elif slo is not None:
        print(SLOMonitor.format_report(slo.report()))
    if args.log_json:
        print(json.dumps({
            "event": "summary", "engine": args.engine,
            "replicas": args.replicas, "requests": len(results),
            "tokens_generated": eng.stats["tokens_generated"],
            "decode_steps": eng.stats["decode_steps"],
            "prefills": eng.stats["prefills"],
            "admission_stalls": eng.stats["admission_stalls"],
            "wall_s": round(dt, 6),
            "slo": slo.report() if slo is not None else None}))
    if tracer is not None and args.trace_out:
        if args.trace_out.endswith(".jsonl"):
            n = tracer.export_jsonl(args.trace_out)
        else:
            n = tracer.export_chrome(args.trace_out)
        print(f"trace: {len(tracer.finished)} requests, {n} events "
              f"-> {args.trace_out}")
    sample = results[min(results)]
    print("sample output tokens:", sample[:16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
