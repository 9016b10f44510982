"""A/B of the GS backward kernels between two trees of this repository, on
one GPU.

    python3 tools/gs_bwd_ab.py --tree DIR [--label NAME] [--seed N] [--out FILE]

Imports ``chip_smoke.py`` from the tree at DIR (which puts that tree's
``src`` first on the path, so its own ``repro_torch`` and CUDA sources are
built and run) and runs, each with the tree's own code:

* phase 3b's GS backward cases — ``gs_fused_grads`` at the weight slabs of
  qwen2-72b at b = 32 (wi / wg, MLP wo, wq / attn wo, wk / wv and Double
  GSOFT's output sides), ``gs_fused_bwd`` (with dx) at the wi slab, bf16;
  both at the wi slab with b = 128 (and 256 where the tree takes it); f32 at
  the wi slab — against their plain versions, with times and bounds
  (``check_bwd_case``);
* phase 7 — ``train_phase`` for GSOFT (4 layers, bf16, batch 2 x 256):
  step times, launches, and a profiled step's GS-backward share of the
  card's busy time;
* phase 8's gradient step — ``build_grad_fn`` for Double GSOFT at 2 layers
  in f32 (as phase 8 runs it) and in bf16: median of 3 timed steps and a
  profiled one with its GS-backward share.

Prints the card's name and power limit, then one JSON line of the results
(also written to ``--out``). Hosts differ between calls, so compare trees
inside one call, in turns: ``for t in parent change change parent``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import time
from pathlib import Path

_KEYS = ("kernel", "T", "d", "b", "dtype", "route", "tt", "splits", "tokens",
         "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
         "grad_rel_err", "dx_abs_err")


def _load(tree: Path):
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  tree / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases(cs, full) -> list:
    """(kernel, T, d, b, dtype) the A/B times in every tree."""
    torch = cs.torch
    D, F = full.d_model, full.d_ff
    kv = full.num_kv_heads * full.d_head
    bf, f32 = torch.bfloat16, torch.float32
    out = [("gs_fused_grads", T, d, 32, bf)
           for T, d in ((F, D), (D, F), (D, D), (kv, D), (D, kv))]
    out += [("gs_fused_bwd", F, D, 32, bf)]
    for b in (128, 256):
        if b <= cs.gk.BWD_MAX_BLOCK:
            out += [("gs_fused_grads", F, D, b, bf), ("gs_fused_bwd", F, D, b, bf)]
    out += [("gs_fused_grads", F, D, 32, f32), ("gs_fused_bwd", F, D, 32, f32)]
    return out


def _gs_bwd_share(prof) -> tuple:
    """(GS-backward device ms by kernel, their share of the busy time)."""
    by = {k: v for k, v in prof["port_device_ms_by_kernel"].items()
          if "gs_bwd" in k or "gs_grads" in k}
    return by, sum(by.values()) / (prof["device_busy_s"] * 1e3)


def _grad_step(cs, cfg, seed: int, device, method: str) -> dict:
    """Phase 8's gradient step (``build_grad_fn`` at a perturbed adapter
    point), timed: median of 3 steps, then one under the profiler."""
    torch = cs.torch
    pcfg = cs.peft_lib.PEFTConfig(method=method, block_size=32)
    params = cs.ModelRuntime(cfg, seed=seed, device=device).params
    adapters = cs.perturbed_adapters(pcfg, params, seed + 11, 0.02, device)
    batch = {k: torch.as_tensor(v, device=device) for k, v in cs.LMDataSource(
        cs.DataConfig(seq_len=cs.GRAD_SEQ, global_batch=cs.GRAD_BATCH,
                      seed=seed, vocab_size=min(cfg.vocab_size, 256))
    ).batch_at(0).items()}
    fn = cs.steps.build_grad_fn(cfg, pcfg)
    fn(adapters, params, batch)
    torch.cuda.synchronize()
    cs._reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(adapters, params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: v / 3 for k, v in cs._launches().items() if v}
    prof = cs._profile(lambda: fn(adapters, params, batch))
    by, share = _gs_bwd_share(prof)
    del params, adapters
    torch.cuda.empty_cache()
    return dict(method=method, dtype=cfg.dtype, layers=cfg.num_layers,
                step_s=times, step_median_s=sorted(times)[1],
                launches_per_step=launches, profiled_wall_s=prof["wall_s"],
                device_busy_s=prof["device_busy_s"],
                idle_share=prof["idle_share"],
                port_device_ms_by_kernel=prof["port_device_ms_by_kernel"],
                gs_bwd_device_ms_by_kernel=by, gs_bwd_share_of_busy=share)


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
        raise SystemExit("gs_bwd_ab: torch.cuda.is_available() is false")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = cs.build.build_all(["gs_fused_bwd", "gs_fused", "gs_fused_T"])
    warm = torch.randn((8192, 8192), device=device, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    full = cs.get_config("qwen2-72b")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    cases = []
    for kernel, T, d, b, dtype in _cases(cs, full):
        c = cs.check_bwd_case(kernel, T, d, b, dtype, gen, device)
        cases.append({k: c.get(k) for k in _KEYS})
        torch.cuda.empty_cache()
    cfg4 = full.with_overrides(num_layers=cs.TRAIN_LAYERS, remat="full")
    t = cs.train_phase(cfg4, args.seed, device, method="gsoft")
    by, share = _gs_bwd_share(t["profile"])
    train = dict(losses=t["losses"], step_s=t["step_s"],
                 step_median_s=t["step_median_s"],
                 launches_per_step={k: v for k, v in
                                    t["launches_per_step"].items() if v},
                 profiled_wall_s=t["profile"]["wall_s"],
                 device_busy_s=t["profile"]["device_busy_s"],
                 idle_share=t["profile"]["idle_share"],
                 gs_bwd_device_ms_by_kernel=by, gs_bwd_share_of_busy=share)
    del t
    torch.cuda.empty_cache()
    grad_steps = [_grad_step(cs, full.with_overrides(
        num_layers=cs.GRAD_LAYERS, dtype=dt, param_dtype=dt, remat="full"),
        args.seed, device, "double_gsoft") for dt in ("f32", "bf16")]
    result = dict(label=args.label, tree=str(tree), card=card,
                  build_s=build_s, cases=cases, train_gsoft=train,
                  grad_steps_double_gsoft=grad_steps)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(card)
    for c in cases:
        print(f"{args.label} {c['kernel']} T={c['T']} d={c['d']} b={c['b']} "
              f"{c['dtype']}: {c['ms']:.4f} ms (bound {c['bound_ms']:.4f}, "
              f"plain {c['plain_ms']:.4f})")
    print(f"{args.label} train gsoft: step median {train['step_median_s']:.4f}"
          f" s; GS-backward share of busy {train['gs_bwd_share_of_busy']:.3f}")
    for g in grad_steps:
        print(f"{args.label} grad step double_gsoft {g['dtype']}: median "
              f"{g['step_median_s']:.4f} s; GS-backward share of busy "
              f"{g['gs_bwd_share_of_busy']:.3f}")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
