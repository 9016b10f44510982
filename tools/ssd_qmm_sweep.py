"""Sweep the launch geometry of ``ssd`` (the P tile, warps a unit) and
``q_matmul`` (boxes across a tile, ring stages, K splits) on one GPU, from
this tree.

    python3 tools/ssd_qmm_sweep.py [--only ssd|qmm|occupancy] [--out FILE]

For ``ssd`` at zamba2's and mamba2-130m's heads it launches the kernel at P
tiles 64, 32 and 16 (units of 8 and 16 warps at the widest tile, else the
wrapper's warp rule). For ``q_matmul`` (bf16, weights cycled past L2) at
qwen2-72b's wq, wk / wv, wi and MLP wo shapes and the LM head it launches
tiles of 1, 2 or 4 boxes of 128 columns with rings of 4-8 stages
(``QMM_TILES``), each at the wrapper's split rule and, where the items
leave CTAs idle, at every K split up to the largest cluster the card
places (``qmm_geometry`` with the fields forced), at M = 1 and 4; at M =
16 the rule's split only. Each reading is the device ms a call from the
profiler (``tools/ssd_qmm_ab.py``'s measure) with the kernels it counted
a call (1 unless the profiler dropped records) and the clusters of its
split the card holds at once; a table of that occupancy for every tile
comes first. The wrappers' rules (``ssd_geometry``, ``ssd_warps``,
``qmm_geometry`` and ``QMM_TILE``) were chosen from its output; it prints
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import ssd_qmm_ab as ab  # noqa: E402
from gs_bwd_ab import _load  # noqa: E402

SSD_SHAPES = [(1, 16, 80, 64, 64), (1, 64, 80, 64, 64), (1, 128, 80, 64, 64),
              (1, 512, 24, 64, 128), (1, 2048, 80, 64, 64),
              (4, 2048, 80, 64, 64)]
# (K, N): wq, wk / wv, MLP wo, wi / wg, the LM head
QMM_SHAPES = [(8192, 8192), (8192, 1024), (29568, 8192), (8192, 29568),
              (8192, 152064)]
QMM_TILES = [(1, 4), (1, 6), (1, 8), (2, 4), (2, 6), (4, 4)]


def _ssd(cs, gen, dev) -> list:
    torch, ssdk = cs.torch, cs.ssdk
    out = []
    for nb, t, h, p, n in SSD_SHAPES:
        mk = lambda *s, sc=1.0: torch.randn(s, generator=gen, device=dev) * sc
        args_ = (mk(nb, t, h, p), -mk(nb, t, h).abs() * 0.3,
                 mk(nb, t, h, n, sc=0.5), mk(nb, t, h, n, sc=0.5))
        for pt, nw in ((64, 16), (64, 8), (32, None), (16, None)):
            units = nb * h * -(-p // pt) * -(-t // ssdk.CHUNK)
            w = nw or ssdk.ssd_warps(units, cs.gk._num_sms(dev))
            ms, _ = ab._device_ms(
                cs, lambda *a, pt=pt, w=w: ssdk._launch(*a, pt, w), [args_])
            out.append(dict(Nb=nb, T=t, H=h, N=n, p_tile=pt, warps=w,
                            device_ms=ms))
            print(f"ssd Nb={nb} T={t} H={h} N={n} p_tile={pt} warps={w}: "
                  f"{ms:.5f} ms", flush=True)
    return out


def _occupancy_table(qmk) -> list:
    """Per tile (bf16, 8 and 16 tokens): CTAs an SM, the largest cluster,
    and the clusters resident at once at each K split of 1-16."""
    out = []
    for ntok in (8, 16):
        for ntw, stages in QMM_TILES:
            per_sm, cluster, _ = qmk._occupancy(2, ntok, ntw, stages)
            active = [qmk._occupancy(2, ntok, ntw, stages, s)[2]
                      for s in range(1, qmk.QMM_MAX_SPLITS + 1)]
            out.append(dict(ntok=ntok, ntw=ntw, stages=stages, per_sm=per_sm,
                            cluster=cluster, resident_clusters=active))
            print(f"occupancy tokens={ntok} boxes={ntw} stages={stages}: "
                  f"{per_sm} CTAs an SM, clusters up to {cluster}, resident "
                  f"clusters at splits 1-16 {active}", flush=True)
    return out


def _qmm(cs, gen, dev) -> list:
    torch, qmk = cs.torch, cs.qmk
    lib = qmk._lib()
    out = []
    for k, n in QMM_SHAPES:
        codes = [cs._codes(gen, k, n, dev)]
        while len(codes) < 8 and len(codes) * k * n < 120e6:
            codes.append(cs._codes(gen, k, n, dev))
        for m in (1, 4, 16):
            x = (torch.randn((m, k), generator=gen, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16)
            sets = [(x, q, qmk.scale_vector(s, n, dev)) for q, s in codes]
            y = torch.empty((m, n), dtype=x.dtype, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def run(xx, qq, ss, plan):
                qmk._err(lib, "q_matmul", qmk._launch_qmm(
                    lib, xx, qq, ss, y, m, k, n, stream, plan))

            for ntw, stages in QMM_TILES:
                try:
                    rule = qmk.qmm_geometry(m, k, n, 2, ntw=ntw, stages=stages)
                except ValueError:          # does not fit an SM
                    continue
                per_sm, cluster, _ = qmk._occupancy(2, rule.ntok, ntw, stages)
                splits = [None]
                if m < 16 and rule.grid < per_sm * qmk._num_sms():
                    splits += [s for s in range(1, min(
                        qmk.QMM_MAX_SPLITS, cluster) + 1) if s != rule.splits]
                for sp in splits:
                    plan = qmk.qmm_geometry(m, k, n, 2, ntw=ntw,
                                            stages=stages, splits=sp)
                    if sp is not None and plan.splits != sp:
                        continue
                    ms, kern = ab._device_ms(
                        cs, lambda a, b, c, p=plan: run(a, b, c, p), sets,
                        n=max(len(sets), 10 if k * n > 1e9 else 40))
                    resident = qmk._occupancy(2, plan.ntok, ntw, stages,
                                              plan.splits)[2]
                    out.append(dict(M=m, K=k, N=n, ntw=ntw, stages=stages,
                                    splits=plan.splits, ctas=plan.grid,
                                    per_sm=per_sm, cluster=cluster,
                                    resident_clusters=resident,
                                    rule=sp is None, device_ms=ms,
                                    kernels_per_call=kern))
                    print(f"q_matmul M={m} K={k} N={n} boxes={ntw} "
                          f"stages={stages} splits={plan.splits} "
                          f"ctas={plan.grid}{' (rule)' if sp is None else ''}"
                          f": {ms:.5f} ms ({kern:.2f} kernels a call)",
                          flush=True)
            del sets, x, y
        del codes
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--only", choices=("ssd", "qmm", "occupancy"),
                    default=None)
    args = ap.parse_args()
    cs = _load(ROOT)
    torch = cs.torch
    if not torch.cuda.is_available():
        raise SystemExit("ssd_qmm_sweep: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    cs.build.build_all()
    warm = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    if args.only in (None, "ssd"):
        out["ssd"] = _ssd(cs, gen, dev)
    if args.only in (None, "qmm", "occupancy"):
        out["occupancy"] = _occupancy_table(cs.qmk)
    if args.only in (None, "qmm"):
        out["qmm"] = _qmm(cs, gen, dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
