"""A/B of the bdmm kernels between two trees of this repository, on one GPU.

    python3 tools/bdmm_ab.py --tree DIR [--label NAME] [--seed N] [--out FILE]

Imports ``chip_smoke.py`` from the tree at DIR (which puts that tree's
``src`` first on the path, so its own ``repro_torch`` and CUDA sources are
built and run) and runs:

* phase 3c — the tree's bdmm cases against their plain versions, with times,
  bounds and einsum yardsticks (``bdmm_phase`` where the tree has it, else
  ``check_bdmm_case`` / ``check_dblocks_case`` over ``bdmm_cases`` and
  ``_slabs`` at b = 32);
* at the decode rows and prefill buckets, ``bdmm`` and the banked rotation
  x Q as the tree's adapters compute it (one launch reading the blocks
  transposed, or a transposed copy of the blocks and one launch), each
  timed per call with the host (``time_ms``) and on the card alone
  (``torch.profiler``);
* phase 9 — ``train_phase`` for OFT and BOFT (step times, launches, and a
  profiled step: the bdmm kernels' share of the card's busy time).

Prints the card's name and power limit, then one JSON line of the results
(also written to ``--out``). Hosts differ between calls, so compare trees
inside one call, in turns: ``for t in parent change change parent``.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import time
from pathlib import Path

_KEYS = ("kernel", "B", "T", "d", "b", "trans", "dtype", "route", "geometry",
         "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
         "max_abs_err")


def _load(tree: Path):
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  tree / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phase_3c(cs, full, gen, device) -> list:
    if hasattr(cs, "bdmm_phase"):
        return cs.bdmm_phase(full, gen, device)
    run = []
    for dtype in (cs.torch.bfloat16, cs.torch.float32):
        for B, T, d in cs.bdmm_cases(full):
            run.append(cs.check_bdmm_case(B, T, d, cs.BDMM_BLOCK, dtype, gen,
                                          device))
        for T, d in cs._slabs(full):
            run.append(cs.check_dblocks_case(T, d, cs.BDMM_BLOCK, dtype, gen,
                                             device))
    return run


def _device_us(torch, fn, sets, n: int = 40) -> tuple:
    """(device µs per call summed over every kernel the call runs, kernel
    names) from torch.profiler over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn(*sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    total, names = 0.0, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            total += us
            names.append(e.key[:60])
    return total / n, names


def _serving_shapes(cs, full, gen, device) -> list:
    """At the decode rows and prefill buckets (bf16): ``bdmm`` with the
    blocks as given, and x Q (Q's blocks read transposed) as the tree's
    ``oft_rotate_banked`` computes it: one launch reading the transpose in
    place, or a transposed copy and one launch. Host-inclusive ms per call
    (``time_ms``) and device µs per call (profiler)."""
    torch, bk = cs.torch, cs.bk
    in_place = "transpose_blocks" in inspect.signature(bk.bdmm).parameters
    if in_place:
        def rotate(x, q):
            return bk.bdmm(x, q, transpose_blocks=True)
    else:
        def rotate(x, q):
            return bk.bdmm(x, q.transpose(-1, -2).contiguous())
    out = []
    for B, T, d in cs.bdmm_cases(full):
        if B == 1 and T not in cs.prefill_buckets():
            continue                                 # a weight slab
        r, b = d // cs.BDMM_BLOCK, cs.BDMM_BLOCK
        x = torch.randn((B, T, d), generator=gen, device=device).to(
            torch.bfloat16)
        sets = [(x, cs._orth_factors(gen, B, r, b, torch.bfloat16, device)[0])
                for _ in range(8)]
        row = dict(B=B, T=T, d=d, b=b, in_place=in_place)
        for name, fn in (("bdmm", bk.bdmm), ("rotation", rotate)):
            us, names = _device_us(torch, fn, sets)
            row[name] = dict(ms=cs.time_ms(fn, sets), device_us=us,
                             kernels=names)
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    cs = _load(tree)
    torch = cs.torch
    if not torch.cuda.is_available():
        raise SystemExit("bdmm_ab: torch.cuda.is_available() is false")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = cs.build.build_all(["bdmm"])
    warm = torch.randn((8192, 8192), device=device, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    full = cs.get_config("qwen2-72b")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    cases = [{k: c.get(k) for k in _KEYS}
             for c in _phase_3c(cs, full, gen, device)]
    torch.cuda.empty_cache()
    serving = _serving_shapes(cs, full, gen, device)
    torch.cuda.empty_cache()
    cfg4 = full.with_overrides(num_layers=cs.TRAIN_LAYERS, remat="full")
    train = {}
    for method in ("oft", "boft"):
        t = cs.train_phase(cfg4, args.seed, device, method=method)
        prof = t["profile"]
        by = prof["port_device_ms_by_kernel"]
        bdmm_ms = sum(v for k, v in by.items() if k.startswith("bdmm"))
        train[method] = dict(
            losses=t["losses"], step_s=t["step_s"],
            step_median_s=t["step_median_s"],
            launches_per_step={k: v for k, v in t["launches_per_step"].items()
                               if v},
            profiled_wall_s=prof["wall_s"],
            device_busy_s=prof["device_busy_s"],
            idle_share=prof["idle_share"], bdmm_device_ms_by_kernel=by,
            bdmm_share_of_busy=bdmm_ms / (prof["device_busy_s"] * 1e3))
        torch.cuda.empty_cache()
    result = dict(label=args.label, tree=str(tree), card=card,
                  build_s=build_s, cases=cases, serving_shapes=serving,
                  train=train)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(card)
    for row in serving:
        print(f"{args.label} serving B={row['B']} T={row['T']} d={row['d']}: "
              + "; ".join(f"{k} {row[k]['ms']:.4f} ms ({row[k]['device_us']:.2f}"
                          f" µs on the card)" for k in ("bdmm", "rotation")))
    for m, t in train.items():
        print(f"{args.label} train {m}: step median {t['step_median_s']:.4f} s"
              f"; bdmm share of busy {t['bdmm_share_of_busy']:.3f}; "
              f"{t['bdmm_device_ms_by_kernel']}")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
