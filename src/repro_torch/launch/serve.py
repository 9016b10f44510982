"""Serving launcher (port of the continuous and paged lanes of
``repro/launch/serve.py``).

    # paged KV engine over int8 base weights and a 3-tenant GSOFT bank
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
        --smoke --engine paged --quantize int8 --demo-adapters 3 --device cpu
    # the Mamba2 families on the continuous lane
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --smoke --device cpu
    # named adapters from checkpoints; requests round-robin over them
    ... --adapters alice=/ckpts/alice bob=/ckpts/bob
    # a thousand-tenant adapter checkpoint as a disk-backed store, paged
    # into device memory under a fixed budget (LRU eviction)
    ... --store-dir /ckpts/tenants --hbm-adapter-budget 64

Same flags as the JAX launcher for this path plus ``--device`` (default
``cuda``: without a card it raises unless ``--device cpu`` is given) and
``--max-len`` (default: prompt + new tokens + 8, as the JAX launcher
computes it). ``--adapters``, ``--demo-adapters`` and ``--store-dir`` are
exclusive; ``--hbm-adapter-budget`` pages the first two's bank too. Flags
of lanes not ported yet raise NotImplementedError naming the slice they
wait for: ``--engine static``, ``--quantize fp8``, ``--replicas`` (the
scale-out slice), ``--trace`` (the observability slice), ``--family image``
(the image slice). ``--family`` is checked against the arch's family, as
in the JAX launcher; ``ssm`` / ``hybrid`` archs fail as there on
``--engine paged`` (no paged KV surface) and ``--demo-adapters`` (no bank
serving: the first prefill raises). Requests are all queued up front.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_config, get_smoke_config, parse_overrides
from repro_torch.core import peft as peft_lib
from repro_torch.core.runtime import ModelRuntime
from repro_torch.models import registry
from repro_torch.quant import tree_bytes
from repro_torch.serve.engine import PagedServeEngine, ServeEngine
from repro_torch.store import AdapterStore, load_adapter_checkpoints


def make_demo_adapters(names, params, peft_cfg, device, seed: int = 1,
                       scale: float = 0.1):
    """Random (non-identity) adapters, one per name: identity-initialized
    ``init_peft`` trees plus seeded normal noise. Stand-ins for real
    fine-tunes in demos and benchmarks."""
    out = {}
    for i, name in enumerate(names):
        ad = peft_lib.init_peft(peft_cfg, params, device=device, seed=seed + i)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1000 + i)
        out[name] = {path: {k: v + scale * torch.randn(
                         v.shape, generator=gen, device=device, dtype=v.dtype)
                         for k, v in entry.items()}
                     for path, entry in ad.items()}
    return out


def latency_percentiles(finished) -> dict:
    lat = np.asarray([r.t_done - r.t_submit for r in finished] or [0.0])
    return {p: float(np.percentile(lat, p)) for p in (50, 95)}


def describe(eng, results, engine_name: str, dt: float) -> None:
    toks = eng.stats["tokens_generated"]
    lat = latency_percentiles(eng.finished)
    print(f"[{engine_name}] served {len(results)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks / max(dt, 1e-9):.1f} tok/s, "
          f"{eng.stats['decode_steps']} decode steps, "
          f"{eng.stats['prefills']} prefills)")
    print(f"latency p50={lat[50] * 1e3:.0f}ms p95={lat[95] * 1e3:.0f}ms")


def _refuse_unported(args) -> None:
    if args.engine == "static":
        raise NotImplementedError(
            "--engine static (StaticServeEngine) is not ported yet")
    if args.quantize == "fp8":
        raise NotImplementedError(
            "--quantize fp8 is not ported (the JAX fp8 path is a stub)")
    if args.replicas != 1:
        raise NotImplementedError(
            "--replicas (EngineCluster) is not ported yet (scale-out slice)")
    if args.trace:
        raise NotImplementedError(
            "--trace is not ported yet (observability slice)")
    if args.family is not None:
        try:
            registry.get(args.family)
        except KeyError:
            raise NotImplementedError(
                f"--family {args.family} is not ported yet (the port serves "
                "the decoder, ssm and hybrid families; image waits for the "
                "image slice)") from None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--family", default=None)
    ap.add_argument("--engine", choices=("continuous", "static", "paged"),
                    default="continuous",
                    help="'paged': fixed-size KV pages + per-slot page "
                         "tables, chunked prefill, shared-prefix caching")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="slot capacity in tokens (0: prompt + new + 8)")
    ap.add_argument("--mixed-lengths", action="store_true",
                    help="prompt lens U[4, prompt_len], budgets U[2, max_new]")
    ap.add_argument("--replicas", type=int, default=1)
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
                    help="fabricate N random GSOFT adapters as a demo bank")
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
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    _refuse_unported(args)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.with_overrides(**parse_overrides(args.set))
    if args.family and not registry.is_family(cfg, args.family):
        raise SystemExit(f"--family {args.family} but arch {args.arch!r} "
                         f"registers family {cfg.family!r}")
    rt = ModelRuntime(cfg, device=args.device)
    max_len = args.max_len or args.prompt_len + args.max_new + 8

    budget = args.hbm_adapter_budget or None
    adapter_names = []
    if sum(map(bool, (args.adapters, args.demo_adapters,
                      args.store_dir))) > 1:
        raise SystemExit("--adapters / --demo-adapters / --store-dir are "
                         "exclusive: load a saved bank, fabricate one, OR "
                         "serve a checkpoint dir as a paged store")
    if args.store_dir:
        store = AdapterStore.open(args.store_dir)
        rt = rt.attach(store, hbm_budget=budget)
        adapter_names = list(store.names)
        print(f"adapter store: {len(store)} adapters on disk/host, device "
              f"capacity {rt.bank.capacity} (per-method {rt.bank.caps})")
    elif args.adapters or args.demo_adapters:
        if args.demo_adapters:
            names = [f"a{i}" for i in range(args.demo_adapters)]
            bank_peft = peft_lib.PEFTConfig(method="gsoft", block_size=8,
                                            use_pallas=cfg.use_pallas)
            adapters_by_name = make_demo_adapters(names, rt.params,
                                                  bank_peft, rt.device)
        else:
            adapters_by_name, bank_peft = load_adapter_checkpoints(
                args.adapters, device=rt.device)
        rt = rt.attach(adapters_by_name, bank_peft, hbm_budget=budget)
        adapter_names = list(adapters_by_name)
        print(f"adapter bank: {rt.bank.num_slots} slots "
              f"{list(rt.bank.names)}, methods {list(rt.bank.bank_methods)}")

    if args.quantize != "none":
        before = tree_bytes(rt.params)
        rt = rt.quantized(args.quantize, release_source=True)
        after = tree_bytes(rt.params)
        print(f"quantized base weights ({args.quantize}): params "
              f"{before / 1e6:.2f} MB -> {after / 1e6:.2f} MB "
              f"({before / max(after, 1):.2f}x smaller)")

    if args.engine == "paged":
        eng = PagedServeEngine(rt, max_batch=args.max_batch, max_len=max_len,
                               page_size=args.page_size,
                               prefill_chunk=args.prefill_chunk,
                               hbm_kv_budget=args.hbm_kv_budget or None)
    else:
        eng = ServeEngine(rt, max_batch=args.max_batch, max_len=max_len)

    rng = np.random.default_rng(0)
    names = adapter_names or [None]
    requests = []
    for i in range(args.requests):
        plen = (int(rng.integers(4, args.prompt_len + 1))
                if args.mixed_lengths else args.prompt_len)
        mnew = (int(rng.integers(2, args.max_new + 1))
                if args.mixed_lengths else args.max_new)
        req = {"prompt": rng.integers(1, min(cfg.vocab_size, 255),
                                      size=plen).tolist(),
               "max_new_tokens": mnew}
        if adapter_names:
            req["adapter"] = names[i % len(names)]
        requests.append(req)

    t0 = time.perf_counter()
    for req in requests:
        eng.add_request(**req)
    results = eng.run()
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    describe(eng, results, args.engine, time.perf_counter() - t0)
    if args.engine == "paged":
        print(f"kv pages: {eng.kv_stats()}")
    if hasattr(rt.bank, "stats"):
        print(f"adapter store: {rt.bank.stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
