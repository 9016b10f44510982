"""A/B of the forward GS rotation (``gs_fused``) between two trees of this
repository, on one GPU.

    python3 tools/gs_fwd_ab.py --tree DIR [--label NAME] [--seed N] [--out FILE]

Imports ``chip_smoke.py`` from the tree at DIR (with the loader of
``tools/gs_bwd_ab.py``, which puts that tree's ``src`` first on the path,
so its own ``repro_torch`` and CUDA sources are built and run) and runs,
each with the tree's own code:

* phase 3's ``gs_fused`` cases — the weight slabs of qwen2-72b at b = 32
  (wi / wg, MLP wo, wq / attn wo, wk / wv and Double GSOFT's output side at
  d = 1024) in bf16, the wi slab at b = 128 in bf16, the wi and MLP wo
  slabs in f32 — against the plain version, with times, bounds, the dense
  ``bmm`` and, where the tree's ``check_case`` gives it, the product over
  the b^2 x b^2 diagonal blocks (``check_case``);
* phase 7 — ``train_phase`` for GSOFT (4 layers, bf16, batch 2 x 256):
  step times, launches, and a profiled step's ``gs_fused`` device time by
  kernel (route 1 ``gs_fused_tc_kernel``, route 2 ``gs_fused_kernel``) and
  share of the card's busy time;
* phase 8's gradient step — ``build_grad_fn`` for Double GSOFT at 2 layers
  in f32 (as phase 8 runs it) and in bf16 (``gs_bwd_ab``'s driver): median
  of 3 timed steps and a profiled one with the ``gs_fused`` share.

Prints the card's name and power limit, then one JSON line of the results
(also written to ``--out``). Hosts differ between calls, so compare trees
inside one call, in turns: ``for t in parent change change parent``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from gs_bwd_ab import _grad_step, _load  # noqa: E402

_KEYS = ("kernel", "T", "d", "b", "dtype", "route", "tt", "ms", "plain_ms",
         "library_ms", "library_blocks_ms", "bound_ms", "bound_by",
         "max_abs_err", "tol")


def _cases(cs, full) -> list:
    """(T, d, b, dtype) of ``gs_fused`` the A/B times in every tree."""
    torch = cs.torch
    D, F = full.d_model, full.d_ff
    kv = full.num_kv_heads * full.d_head
    bf, f32 = torch.bfloat16, torch.float32
    return ([(T, d, 32, bf) for T, d in ((F, D), (D, F), (D, D), (kv, D),
                                          (D, kv))]
            + [(F, D, 128, bf), (F, D, 32, f32), (D, F, 32, f32)])


def _gs_fwd_share(by_kernel: dict, busy_s: float) -> tuple:
    """(``gs_fused``'s device ms by kernel, their share of the busy time):
    route 1's ``gs_fused_tc_kernel`` and route 2's ``gs_fused_kernel``."""
    by = {k: v for k, v in by_kernel.items()
          if k.endswith("gs_fused_tc_kernel") or k == "gs_fused_kernel"}
    return by, sum(by.values()) / (busy_s * 1e3)


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
        raise SystemExit("gs_fwd_ab: torch.cuda.is_available() is false")
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
    for T, d, b, dtype in _cases(cs, full):
        c = cs.check_case("gs_fused", 1, T, d, b, dtype, gen, device)
        cases.append({k: c.get(k) for k in _KEYS})
        torch.cuda.empty_cache()
    cfg4 = full.with_overrides(num_layers=cs.TRAIN_LAYERS, remat="full")
    t = cs.train_phase(cfg4, args.seed, device, method="gsoft")
    prof = t["profile"]
    by, share = _gs_fwd_share(prof["port_device_ms_by_kernel"],
                              prof["device_busy_s"])
    train = dict(losses=t["losses"], step_s=t["step_s"],
                 step_median_s=t["step_median_s"],
                 launches_per_step={k: v for k, v in
                                    t["launches_per_step"].items() if v},
                 profiled_wall_s=prof["wall_s"],
                 device_busy_s=prof["device_busy_s"],
                 idle_share=prof["idle_share"],
                 port_device_ms_by_kernel=prof["port_device_ms_by_kernel"],
                 gs_fwd_device_ms_by_kernel=by, gs_fwd_share_of_busy=share,
                 copies_device_ms=prof.get("copies_device_ms"),
                 copies=prof.get("copies"))
    del t
    torch.cuda.empty_cache()
    grad_steps = []
    for dt in ("f32", "bf16"):
        g = _grad_step(cs, full.with_overrides(
            num_layers=cs.GRAD_LAYERS, dtype=dt, param_dtype=dt,
            remat="full"), args.seed, device, "double_gsoft")
        g["gs_fwd_device_ms_by_kernel"], g["gs_fwd_share_of_busy"] = \
            _gs_fwd_share(g["port_device_ms_by_kernel"], g["device_busy_s"])
        grad_steps.append(g)
    result = dict(label=args.label, tree=str(tree), card=card,
                  build_s=build_s, cases=cases, train_gsoft=train,
                  grad_steps_double_gsoft=grad_steps)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(card)
    for c in cases:
        blocks = c["library_blocks_ms"]
        print(f"{args.label} gs_fused T={c['T']} d={c['d']} b={c['b']} "
              f"{c['dtype']} {c['route'] or ''}: {c['ms']:.4f} ms (bound "
              f"{c['bound_ms']:.4f}, plain {c['plain_ms']:.4f}, bmm "
              f"{c['library_ms']:.4f}"
              + ("" if blocks is None else f", blocks {blocks:.4f}") + ")")
    print(f"{args.label} train gsoft: step median {train['step_median_s']:.4f}"
          f" s; gs_fused {sum(by.values()):.2f} ms, share of busy "
          f"{train['gs_fwd_share_of_busy']:.3f}")
    for g in grad_steps:
        print(f"{args.label} grad step double_gsoft {g['dtype']}: median "
              f"{g['step_median_s']:.4f} s; gs_fused share of busy "
              f"{g['gs_fwd_share_of_busy']:.3f}")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
