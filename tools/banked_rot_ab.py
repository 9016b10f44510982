"""A/B of the banked serving rotations (``gs_fused_T``, ``gs_q_matmul``)
between two trees of this repository, on one GPU.

    python3 tools/banked_rot_ab.py --tree DIR [--label NAME] [--seed N] [--out FILE]
                                  [--lanes-only serve,paged_int8,mixed]

Imports ``chip_smoke.py`` from the tree at DIR (with the loader of
``tools/gs_bwd_ab.py``, which puts that tree's ``src`` first on the path,
so its own ``repro_torch`` and CUDA sources are built and run) and runs,
each with the tree's own code:

* phase 3's ``gs_fused_T`` cases as the serving path calls them —
  ``core.adapters.gs_rotate_banked`` on a 4-slot fp32 bank (whatever the
  tree does there: gather and cast then the kernel, or the kernel reading
  the bank by slot id) at decode (B = 4) and every prefill bucket, d =
  8192 and 29568, bf16 — and the long slabs through ``gs_fused_T`` with
  per-row factors (Double GSOFT's output sides, the GS backward's dx slab);
  each with its time per call (CUDA events, host dispatch included) and,
  from the profiler, its device time and kernel launches per call;
* phase 3d's ``gs_q_matmul`` cases as ``models.layers.qlinear`` calls them
  (a ``BankRotator`` over the same bank handing GSOFT to the fused int8
  matmul): every adapted projection at decode (B = 4) and one prefill
  chunk, bf16, with the same three numbers;
* phases 4, 4b and 11 — ``serve_phase``, ``paged_quant_serve_phase`` and
  ``mixed_serve_phase``: tokens per second (median of 3), the profiled
  run's idle share, and its gather (``indexSelect*``) and copy / cast
  kernels;
* Double GSOFT's bf16 gradient step (phase 8's ``build_grad_fn`` at 2
  layers, ``gs_bwd_ab``'s ``_grad_step``) with ``gs_fused_T``'s device
  time.

With ``--lanes-only`` it runs the named serve lanes of the last-but-one
item alone, nothing else. Prints the card's name and power limit, then
one JSON line of the results
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

SLOTS = 4
IDS = [1, 2, 3, 0]          # four decode rows on four slots (0: identity)


def _card(cs, fn, args, n: int = 40) -> tuple:
    """(device ms per call, kernels per call) of ``fn(*args)`` from the
    profiler over n calls (every kernel the call launches, gathers and
    casts included)."""
    torch = cs.torch
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        if t > 0:
            us += t
            count += e.count
    return us / 1e3 / n, count / n


def _bank(cs, gen, r, device):
    torch = cs.torch
    L, R = cs._orth_factors(gen, SLOTS, r, 32, torch.float32, device)
    L[0] = R[0] = torch.eye(32, device=device)
    return L, R


def _rot_cases(cs, full, gen, device) -> list:
    """gs_fused_T: the serving call at decode rows and prefill buckets, the
    kernel with per-row factors on the long slabs."""
    torch = cs.torch
    bf = torch.bfloat16
    D, F = full.d_model, full.d_ff
    kv = full.num_kv_heads * full.d_head
    out = []
    for d in (D, F):
        L, R = _bank(cs, gen, d // 32, device)
        entry = {"L": L, "R": R}
        for bsz, t in [(4, 1)] + [(1, t) for t in cs.prefill_buckets()]:
            ids = torch.tensor(IDS[:bsz], dtype=torch.int64, device=device)
            x = torch.randn((bsz, t, d), generator=gen, device=device).to(bf)
            fn = cs.ad_lib.gs_rotate_banked
            args = (entry, ids, x)
            dev_ms, kernels = _card(cs, fn, args)
            out.append(dict(what="gs_rotate_banked", B=bsz, T=t, d=d,
                            ms=cs.time_ms(fn, [args]), device_ms=dev_ms,
                            kernels_per_call=kernels))
        del entry, L, R
    for t, d in ((D, D), (D, kv), (D, F), (F, D)):
        x = torch.randn((1, t, d), generator=gen, device=device).to(bf)
        L, R = cs._orth_factors(gen, 1, d // 32, 32, bf, device)
        fn = cs.gk.gs_fused_T
        dev_ms, kernels = _card(cs, fn, (x, L, R), n=5)
        out.append(dict(what="gs_fused_T", B=1, T=t, d=d,
                        ms=cs.time_ms(fn, [(x, L, R)]), device_ms=dev_ms,
                        kernels_per_call=kernels))
        del x, L, R
        torch.cuda.empty_cache()
    return out


def _gsq_cases(cs, full, gen, device) -> list:
    """gs_q_matmul as ``qlinear`` calls it over a GSOFT bank entry."""
    torch = cs.torch
    from repro_torch.models.layers import qlinear
    from repro_torch.quant.core import QuantTensor
    bf = torch.bfloat16
    out = []
    for bsz, t, d, n in cs.gsq_cases(full):
        if d > full.d_ff:
            continue                     # not a qwen2-72b width
        L, R = _bank(cs, gen, d // 32, device)
        rot = cs.peft_lib.BankRotator({"w": {"gsoft": {"L": L, "R": R}}},
                                      torch.tensor(IDS[:bsz],
                                                   dtype=torch.int64,
                                                   device=device))
        q, s = cs._codes(gen, d, n, device)
        w = QuantTensor(q, s)
        x = (torch.randn((bsz, t, d), generator=gen, device=device)
             / d ** 0.5).to(bf)
        args = (x, w, rot, "w")
        dev_ms, kernels = _card(cs, qlinear, args, n=20)
        out.append(dict(what="qlinear gs_q_matmul", B=bsz, T=t, d=d, N=n,
                        ms=cs.time_ms(qlinear, [args]), device_ms=dev_ms,
                        kernels_per_call=kernels))
        del L, R, q, s, w, rot
        torch.cuda.empty_cache()
    return out


def _lane(r: dict) -> dict:
    prof = r["profile"]
    return dict(tok_s=r["tok_s"], wall_s=r["wall_s"],
                idle_share=prof["idle_share"],
                device_busy_s=prof["device_busy_s"],
                index_select_kernels=prof.get("index_select_kernels"),
                copy_kernels=prof.get("copy_kernels"),
                launches={k: v for k, v in r["launches"].items() if v},
                slot_launches=r.get("slot_launches"),
                port_device_ms_by_kernel=prof["port_device_ms_by_kernel"])


def _moved(cs, run) -> dict:
    """Gather and copy / cast kernels of one more ``run()`` under the
    profiler (a tree whose ``_profile`` does not count them)."""
    torch = cs.torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {"index_select_kernels": 0, "copy_kernels": 0}
    for e in prof.key_averages():
        if "indexSelect" in e.key:
            out["index_select_kernels"] += e.count
        if "direct_copy_kernel" in e.key:
            out["copy_kernels"] += e.count
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--lanes-only", default="",
                    help="comma-separated serve lanes to run alone")
    args = ap.parse_args()
    only = [x for x in args.lanes_only.split(",") if x]
    tree = Path(args.tree).resolve()
    cs = _load(tree)
    torch = cs.torch
    profile_run = cs._profile

    def counted_profile(run, copy_shapes=None):
        out = profile_run(run, copy_shapes)
        if "index_select_kernels" not in out:    # a tree that does not count
            out.update(_moved(cs, run))
        return out
    cs._profile = counted_profile
    if not torch.cuda.is_available():
        raise SystemExit("banked_rot_ab: torch.cuda.is_available() is false")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = cs.build.build_all()
    warm = torch.randn((8192, 8192), device=device, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    full = cs.get_config("qwen2-72b")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    rot = [] if only else _rot_cases(cs, full, gen, device)
    gsq = [] if only else _gsq_cases(cs, full, gen, device)
    cfg8 = full.with_overrides(num_layers=cs.SERVE_LAYERS)
    lanes = {}
    for name, phase, cfg in (
            ("serve", cs.serve_phase, cfg8),
            ("paged_int8", cs.paged_quant_serve_phase, cfg8),
            ("mixed", cs.mixed_serve_phase,
             full.with_overrides(num_layers=cs.MIXED_SERVE_LAYERS))):
        if only and name not in only:
            continue
        r = phase(cfg, args.seed, device)
        lanes[name] = _lane(r)
        torch.cuda.empty_cache()
    g = None
    if not only:
        g = _grad_step(cs, full.with_overrides(
            num_layers=cs.GRAD_LAYERS, dtype="bf16", param_dtype="bf16",
            remat="full"), args.seed, device, "double_gsoft")
        g["gs_fused_T_device_ms"] = sum(
            v for k, v in g["port_device_ms_by_kernel"].items()
            if "gs_fused_T" in k or "gs_T_tc" in k)
    result = dict(label=args.label, tree=str(tree), card=card,
                  build_s=build_s, rotation_cases=rot, gsq_cases=gsq,
                  lanes=lanes, grad_step_double_gsoft_bf16=g)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(card)
    for c in rot + gsq:
        print(f"{args.label} {c['what']} B={c['B']} T={c['T']} d={c['d']}"
              + (f" N={c['N']}" if "N" in c else "")
              + f": {c['ms']:.4f} ms a call, {c['device_ms']:.4f} ms on the "
              f"card, {c['kernels_per_call']:.1f} kernels a call")
    for name, lane in lanes.items():
        print(f"{args.label} {name}: {lane['tok_s']:.1f} tok/s, idle "
              f"{lane['idle_share']:.3f}, index_select kernels "
              f"{lane['index_select_kernels']}, copy kernels "
              f"{lane['copy_kernels']}")
    if g is not None:
        print(f"{args.label} grad step double_gsoft bf16: median "
              f"{g['step_median_s']:.4f} s; gs_fused_T "
              f"{g['gs_fused_T_device_ms']:.2f} ms on the card")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
