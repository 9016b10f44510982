"""A/B of the attention kernels (``flash_attention``, ``paged_decode``)
between two trees of this repository, on one GPU.

    python3 tools/attn_ab.py --tree DIR [--label NAME] [--seed N] [--out FILE]

Imports ``chip_smoke.py`` from the tree at DIR (with the loader of
``tools/gs_bwd_ab.py``, which puts that tree's ``src`` first on the path,
so its own ``repro_torch`` and CUDA sources are built and run) and runs,
each with the tree's own code:

* phase 3d's ``paged_decode`` cases at qwen2-72b's heads (B = 4, 64 / 8
  heads, d_head 128): 144 keys a row and ragged rows with a parked one
  through the serve phase's page-8 and page-16 tables, and 4096 keys a row
  through a page-16 table of 256 columns; bf16 and f32;
* phase 3f's ``flash_attention`` cases through ``ops.flash_mha``:
  qwen2-72b's and zamba2's heads at S of 128, 512 and 2048, causal and
  not, ragged causal S = 1000, gemma-7b's heads (16 / 16, D 256) at S of
  512 and 2048 and D = 320 at S = 1024, causal; bf16 and f32 ("refused"
  where the tree's kernel raises);

  each with its time a call (CUDA events, host dispatch included), its
  device time a call from the profiler (every kernel the call launches),
  and the library yardstick's device time (table gather + SDPA; SDPA);
* phase 4b's paged int8 lane (``paged_quant_serve_phase``): tokens per
  second (median of 3), the profiled run's idle share, and
  ``paged_decode``'s device ms and launches in that run.

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

from banked_rot_ab import _card  # noqa: E402
from gs_bwd_ab import _load  # noqa: E402

PAGED_AB = [(8, "ctx144"), (8, "ragged_parked"), (16, "ctx144"),
            (16, "ragged_parked"), (16, "ctx4096")]
PAGED_AB_LENS = {"ctx144": [144] * 4, "ragged_parked": [17, 80, 200, None],
                 "ctx4096": [4096] * 4}
# (name, H, KH, D): qwen2-72b, zamba2-2.7b, gemma-7b
# (src/repro/configs/gemma_7b.py), and a width past 256
FLASH_HEADS = [("qwen2-72b", 64, 8, 128), ("zamba2-2.7b", 32, 32, 80)]
FLASH_WIDE = [("gemma-7b", 16, 16, 256, 512), ("gemma-7b", 16, 16, 256, 2048),
              ("D=320", 8, 8, 320, 1024)]


def _paged_inputs(cs, full, page, lens_name, dtype, gen, device):
    torch = cs.torch
    H, KH, D = full.num_heads, full.num_kv_heads, full.d_head
    W = (4096 if lens_name == "ctx4096" else cs.SERVE_MAX_LEN) // page
    lens = PAGED_AB_LENS[lens_name]
    B = len(lens)
    npages = B * W + 1
    kp = torch.randn((npages, page, KH, D), generator=gen,
                     device=device).to(dtype)
    vp = torch.randn((npages, page, KH, D), generator=gen,
                     device=device).to(dtype)
    q = torch.randn((B, H, D), generator=gen, device=device).to(dtype)
    table = torch.zeros((B, W), dtype=torch.int32, device=device)
    kv_len = torch.zeros(B, dtype=torch.int32, device=device)
    for i, n in enumerate(lens):
        if n is None:
            kv_len[i] = W * page + 1
            continue
        table[i, :W] = torch.arange(1 + i * W, 1 + (i + 1) * W)
        kv_len[i] = n
    return (q, kp, vp, table, kv_len), W


def _paged_cases(cs, full, gen, device) -> list:
    torch = cs.torch
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for page, lens_name in PAGED_AB:
            args, W = _paged_inputs(cs, full, page, lens_name, dtype, gen,
                                    device)
            fn = cs.pak.paged_decode
            B, H, D = args[0].shape
            KH = args[1].shape[2]

            def lib(qq, kk, vv, tbl, lens_):
                k = kk[tbl.long()].reshape(B, -1, KH, D).transpose(1, 2)
                v = vv[tbl.long()].reshape(B, -1, KH, D).transpose(1, 2)
                mask = (torch.arange(k.shape[2], device=device)[None, :]
                        < lens_[:, None])[:, None, None, :]
                return torch.nn.functional.scaled_dot_product_attention(
                    qq.reshape(B, KH, H // KH, D), k, v, attn_mask=mask)

            dev_ms, kernels = _card(cs, fn, args)
            lib_ms, _ = _card(cs, lib, args, n=10)
            out.append(dict(what="paged_decode", page=page, W=W,
                            lens=lens_name,
                            dtype=str(dtype).replace("torch.", ""),
                            ms=cs.time_ms(fn, [args]), device_ms=dev_ms,
                            kernels_per_call=kernels,
                            library_device_ms=lib_ms))
            del args
            torch.cuda.empty_cache()
    return out


def _flash_cases(cs, gen, device) -> list:
    torch = cs.torch
    cases = []
    for name, h, kh, d in FLASH_HEADS:
        for s_len in (128, 512, 2048):
            for causal in (True, False):
                cases.append((name, h, kh, d, s_len, causal))
        cases.append((name, h, kh, d, 1000, True))
    cases += [(name, h, kh, d, s_len, True)
              for name, h, kh, d, s_len in FLASH_WIDE]
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, h, kh, d, s_len, causal in cases:
            mk = lambda heads: torch.randn(
                (1, s_len, heads, d), generator=gen, device=device).to(dtype)
            args = (mk(h), mk(kh), mk(kh))
            fn = lambda qq, kk, vv: cs.ops.flash_mha(qq, kk, vv, causal=causal)

            def lib(qq, kk, vv):
                return torch.nn.functional.scaled_dot_product_attention(
                    qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                    is_causal=causal, enable_gqa=h != kh)

            row = dict(what="flash_attention", heads=name, H=h, KH=kh, D=d,
                       S=s_len, causal=causal,
                       dtype=str(dtype).replace("torch.", ""))
            try:
                fn(*args)
            except ValueError as e:          # a tree that refuses the width
                row.update(refused=str(e))
                out.append(row)
                continue
            n = 10 if s_len >= 2048 or dtype == torch.float32 else 40
            dev_ms, kernels = _card(cs, fn, args, n=n)
            lib_ms, _ = _card(cs, lib, args, n=n)
            row.update(ms=cs.time_ms(fn, [args]), device_ms=dev_ms,
                       kernels_per_call=kernels, library_device_ms=lib_ms)
            out.append(row)
            del args
            torch.cuda.empty_cache()
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
        raise SystemExit("attn_ab: torch.cuda.is_available() is false")
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
    paged = _paged_cases(cs, full, gen, device)
    flash = _flash_cases(cs, gen, device)
    r = cs.paged_quant_serve_phase(
        full.with_overrides(num_layers=cs.SERVE_LAYERS), args.seed, device)
    prof = r["profile"]
    lane = dict(tok_s=r["tok_s"], wall_s=r["wall_s"],
                idle_share=prof["idle_share"],
                device_busy_s=prof["device_busy_s"],
                paged_decode_launches=r["launches"]["paged_decode"],  # a run
                paged_decode_device_ms=sum(
                    v for k, v in prof["port_device_ms_by_kernel"].items()
                    if "paged_decode" in k),
                port_device_ms_by_kernel=prof["port_device_ms_by_kernel"])
    result = dict(label=args.label, tree=str(tree), card=card,
                  build_s=build_s, paged_cases=paged, flash_cases=flash,
                  paged_int8=lane)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(card)
    for c in paged:
        print(f"{args.label} paged_decode page={c['page']} W={c['W']} "
              f"{c['lens']} {c['dtype']}: {c['ms']:.4f} ms a call, "
              f"{c['device_ms']:.5f} ms on the card "
              f"({c['kernels_per_call']:.1f} kernels), gather + SDPA "
              f"{c['library_device_ms']:.5f}")
    for c in flash:
        head = (f"{args.label} flash {c['heads']} H={c['H']}/{c['KH']} "
                f"D={c['D']} S={c['S']} causal={int(c['causal'])} "
                f"{c['dtype']}: ")
        if "refused" in c:
            print(head + "refused")
        else:
            print(head + f"{c['ms']:.4f} ms a call, {c['device_ms']:.4f} ms "
                  f"on the card, SDPA {c['library_device_ms']:.4f}")
    print(f"{args.label} paged int8: {lane['tok_s']:.1f} tok/s (runs "
          f"{['%.3f' % w for w in lane['wall_s']]} s), idle "
          f"{lane['idle_share']:.3f}, paged_decode "
          f"{lane['paged_decode_device_ms']:.2f} ms on the card in "
          f"{lane['paged_decode_launches']} launches")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
