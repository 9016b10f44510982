"""The encoder classifier's learning rate and gradient gate at RoBERTa-base's
widths (phase 19c of ``chip_smoke.py``: ``CLS_ARGS``, f32, 8 x 128, the
four methods of ``benchmarks/table1_glue.py``), held on two witnesses.

For each method and each rate of ``--rates``: 19c's 3 AdamW steps
(``cs.cls_steps``) from the same params, adapters and batch, once on the
card (the kernels) and once on the CPU (their plain versions), and the
losses of both. Then, for each method, the first step's gradients on the
card against the CPU's (``cs._grads_gap``, the quantity 19c gates at
``CARD_CPU_GRAD_REL``) with TF32 off, as 19c runs, and on, the precision
the gate is there to catch in cuBLAS's matmuls.

    python3 tools/glue_lr_check.py [--rates 5e-3,1e-4] [--seed N] [--out FILE]

Needs one NVIDIA GPU; the card's name and power limit are printed first,
one line a (method, rate) and a method's gradient gaps after, and the
records go to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rates", default="5e-3,1e-4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/glue_lr_check.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("glue_lr_check: needs an NVIDIA GPU")
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = cs.build.build_all(["gs_fused", "gs_fused_bwd", "bdmm"])
    cs.log(f"build {built:.1f} s")
    seed = args.seed
    cfg = cs.encoder_model.encoder_config(**cs.CLS_ARGS)
    params = cs.encoder_model.init_encoder_classifier(cfg, cs.CLS_CLASSES,
                                                      seed, dev)
    params_c = cs._to(params, cpu)
    batch = cs._cls_batch(cfg, cs.CLS_BATCH, cs.CLS_SEQ, seed, dev)
    small = cs._cls_batch(cfg, cs.CLS_CHECK_BATCH, cs.CLS_CHECK_SEQ,
                          seed + 1, dev)
    out = {"card": torch.cuda.get_device_name(0), "config": cs.CLS_ARGS,
           "batch": [cs.CLS_BATCH, cs.CLS_SEQ], "runs": [], "grad_gap": {}}
    for name, kw in cs.CLS_METHODS.items():
        pcfg = cs.peft_lib.PEFTConfig(**kw)
        trainable = {"adapters": cs.perturbed_adapters(pcfg, params, seed + 3,
                                                       0.02, dev),
                     "head": dict(params["head"])}
        trainable_c = cs._to(trainable, cpu)
        for lr in map(float, args.rates.split(",")):
            rec = {"method": name, "lr": lr}
            for where, p, t, b in (("card", params, trainable, batch),
                                   ("cpu", params_c, trainable_c,
                                    cs._to(batch, cpu))):
                t0 = time.perf_counter()
                losses = cs.cls_steps(cfg, pcfg, p, t, b, lr)[0]
                rec[where] = losses
                rec[f"{where}_s"] = time.perf_counter() - t0
            out["runs"].append(rec)
            cs.log(f"{name} lr {lr:g}: card {rec['card']}, cpu {rec['cpu']}")
        g_c = cs._leaf_grads(cs._cls_loss(cfg, pcfg, params_c,
                                          cs._to(small, cpu)), trainable_c)[2]
        gaps = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            g = cs._leaf_grads(cs._cls_loss(cfg, pcfg, params, small),
                               trainable)[2]
            gaps["tf32_on" if tf32 else "tf32_off"] = cs._grads_gap(g, g_c)
        torch.backends.cuda.matmul.allow_tf32 = False
        out["grad_gap"][name] = gaps
        cs.log(f"{name} first-step gradients card vs CPU: {gaps} (gate "
               f"{cs.CARD_CPU_GRAD_REL:g})")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    cs.log(f"details: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
