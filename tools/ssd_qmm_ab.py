"""A/B of the SSD chunked scan (``ssd``) and the int8 weight stream
(``q_matmul``) between two trees of this repository, on one GPU.

    python3 tools/ssd_qmm_ab.py --tree DIR [--label NAME] [--seed N] [--out FILE]

Imports ``chip_smoke.py`` from the tree at DIR (with the loader of
``tools/gs_bwd_ab.py``, which puts that tree's ``src`` first on the path,
so its own ``repro_torch`` and CUDA sources are built and run) and runs,
each with the tree's own code:

* ``ssd`` at zamba2-2.7b's heads (80, P = N = 64) at T = 16, 32, 64 and 128
  (the prefill buckets), T = 2048 at batch 1 and 4, and mamba2-130m's (24,
  P = 64, N = 128) at T = 512; f32 (as the models feed it) and T = 128 in
  bf16;
* ``q_matmul`` at the LM head (K = 8192, N = 152064) and every projection
  shape of qwen2-72b (phase 3d's ``qmm_cases``) at M = 1, 4 and 16, bf16,
  the weights cycled over enough sets to exceed the 50 MB L2; and the LM
  head at M = 4 in f32;

  each with its time a call (CUDA events, host dispatch included), its
  device time a call from the profiler (every kernel the call launches)
  and its bound;
* the hybrid serve (phase 13, zamba2-2.7b at full width and depth) and the
  paged int8 lane (phase 4b): tokens per second (median of 3), and of one
  profiled run the idle share, the busy seconds, and ``ssd``'s /
  ``q_matmul``'s device ms and launches. Both trees' runs are profiled by
  this tool's own function (the device's activity alone), so the two are
  measured alike whatever each tree's ``chip_smoke._profile`` does.

Prints the card's name and power limit, then one JSON line of the results
(also written to ``--out``). Hosts differ between calls, so compare trees
inside one call, in turns: ``for t in parent change change parent``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from gs_bwd_ab import _load  # noqa: E402

ZAMBA = (80, 64, 64)          # (H, P, N)
MAMBA = (24, 64, 128)
SSD_AB = ([(1, t) + ZAMBA for t in (16, 32, 64, 128)]
          + [(1, 2048) + ZAMBA, (4, 2048) + ZAMBA, (1, 512) + MAMBA])


def _device_ms(cs, fn, arg_sets, n: int = 40) -> tuple:
    """(device ms per call, kernels per call) of ``fn`` from the profiler
    over n calls cycling ``arg_sets`` (every kernel a call launches)."""
    torch = cs.torch
    from torch.profiler import ProfilerActivity, profile
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
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


def _profile(cs, run, copy_shapes=None) -> dict:
    """The serve phases' profile, the same in every tree: device activity
    alone; busy seconds, idle share and device ms of the port's kernels."""
    torch = cs.torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by, busy_ms = {}, 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        busy_ms += t / 1e3
        for ns in ("ssd::", "qmm::"):
            if ns in e.key and t > 0:
                name = e.key.split("(", 1)[0].split("<", 1)[0]
                n, ms = by.get(name, (0, 0.0))
                by[name] = (n + e.count, ms + t / 1e3)
    return dict(wall_s=wall, device_busy_s=busy_ms / 1e3,
                idle_share=1.0 - busy_ms / 1e3 / wall,
                port_device_ms_by_kernel={k: v[1] for k, v in by.items()},
                port_launches_by_kernel={k: v[0] for k, v in by.items()})


def _ssd_cases(cs, gen, device) -> list:
    torch = cs.torch
    out = []
    for dtype, cases in ((torch.float32, SSD_AB),
                         (torch.bfloat16, [(1, 128) + ZAMBA])):
        for nb, t, h, p, n in cases:
            def mk(*shape, scale=1.0):
                return (torch.randn(shape, generator=gen, device=device)
                        * scale).to(dtype)
            x = mk(nb, t, h, p)
            loga = (-(torch.randn((nb, t, h), generator=gen,
                                  device=device).abs()) * 0.3).to(dtype)
            args = (x, loga, mk(nb, t, h, n, scale=0.5),
                    mk(nb, t, h, n, scale=0.5))
            fn = cs.ssdk.ssd
            dev_ms, kernels = _device_ms(cs, fn, [args])
            bound_ms, bound_by = cs.ssd_bound(nb, t, h, p, n, dtype)
            out.append(dict(what="ssd", Nb=nb, T=t, H=h, P=p, N=n,
                            dtype=str(dtype).replace("torch.", ""),
                            ms=cs.time_ms(fn, [args]), device_ms=dev_ms,
                            kernels_per_call=kernels, bound_ms=bound_ms,
                            bound_by=bound_by))
            del args, x, loga
            torch.cuda.empty_cache()
    return out


def _qmm_cases(cs, full, gen, device) -> list:
    torch = cs.torch
    cases = [(m, k, n, torch.bfloat16) for m, k, n in cs.qmm_cases(full)]
    cases.append((4, full.d_model, full.padded_vocab(), torch.float32))
    out = []
    for m, k, n, dtype in cases:
        def mk():
            q, s = cs._codes(gen, k, n, device)
            return q, s
        x = (torch.randn((m, k), generator=gen, device=device)
             / math.sqrt(k)).to(dtype)
        sets = cs._weight_sets((x,) + mk(), lambda: (x,) + mk(), k * n)
        fn = cs.qmk.q_matmul
        dev_ms, kernels = _device_ms(cs, fn, sets,
                                     n=max(len(sets), 10 if k * n > 1e9 else 40))
        es = x.element_size()
        bound_ms, bound_by = cs._bytes_bound(
            m * k * es + k * n + 4 * n + m * n * es, 2 * m * k * n, dtype)
        out.append(dict(what="q_matmul", M=m, K=k, N=n,
                        dtype=str(dtype).replace("torch.", ""),
                        ms=cs.time_ms(fn, sets), device_ms=dev_ms,
                        kernels_per_call=kernels, bound_ms=bound_ms,
                        bound_by=bound_by, weight_sets=len(sets)))
        del sets, x
        torch.cuda.empty_cache()
    return out


def _lane(r, key: str) -> dict:
    prof = r["profile"]
    mine = {k: v for k, v in prof["port_device_ms_by_kernel"].items()
            if key in k and "gsq" not in k}
    return dict(tok_s=r["tok_s"], wall_s=r["wall_s"],
                idle_share=prof["idle_share"],
                device_busy_s=prof["device_busy_s"],
                launches_main_run=r["launches"][key],
                device_ms=sum(mine.values()),
                launches_profiled_run=sum(
                    v for k, v in prof["port_launches_by_kernel"].items()
                    if key in k and "gsq" not in k),
                port_device_ms_by_kernel=prof["port_device_ms_by_kernel"])


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
        raise SystemExit("ssd_qmm_ab: torch.cuda.is_available() is false")
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
    ssd = _ssd_cases(cs, gen, device)
    qmm = _qmm_cases(cs, full, gen, device)
    cs._profile = lambda run, copy_shapes=None: _profile(cs, run, copy_shapes)
    hybrid = _lane(cs.hybrid_serve_phase(cs.get_config("zamba2-2.7b"),
                                         args.seed, device), "ssd")
    torch.cuda.empty_cache()
    paged = _lane(cs.paged_quant_serve_phase(
        full.with_overrides(num_layers=cs.SERVE_LAYERS), args.seed, device),
        "q_matmul")
    result = dict(label=args.label, tree=str(tree), card=card,
                  build_s=build_s, ssd_cases=ssd, qmm_cases=qmm,
                  hybrid=hybrid, paged_int8=paged)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(card)
    for c in ssd:
        print(f"{args.label} ssd Nb={c['Nb']} T={c['T']} H={c['H']} P={c['P']}"
              f" N={c['N']} {c['dtype']}: {c['ms']:.4f} ms a call, "
              f"{c['device_ms']:.5f} ms on the card "
              f"({c['kernels_per_call']:.1f} kernels), bound "
              f"{c['bound_ms']:.5f} ({c['bound_by']})")
    for c in qmm:
        print(f"{args.label} q_matmul M={c['M']} K={c['K']} N={c['N']} "
              f"{c['dtype']}: {c['ms']:.4f} ms a call, {c['device_ms']:.5f} "
              f"ms on the card ({c['kernels_per_call']:.1f} kernels), bound "
              f"{c['bound_ms']:.5f} ({c['bound_by']})")
    for name, lane in (("hybrid serve", hybrid), ("paged int8", paged)):
        print(f"{args.label} {name}: {lane['tok_s']:.1f} tok/s (runs "
              f"{['%.3f' % w for w in lane['wall_s']]} s), idle "
              f"{lane['idle_share']:.3f}, busy {lane['device_busy_s']:.3f} s, "
              f"kernel {lane['device_ms']:.2f} ms on the card in "
              f"{lane['launches_profiled_run']} launches")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
