"""Run phases 3h, 14, 15, 16, 17, 18, 19 and 20 of ``chip_smoke.py`` alone on one GPU,
from this tree: the image lane's kernel shapes, static / streaming /
traced serving of qwen2-72b (8 layers, bf16, and the f32 check at 2
layers), lipconvnet-15 image serving per tenant (bf16, int8, the f32
checks), scale-out (the cluster, the launcher's ``--replicas`` /
``--tp 1`` lanes, tp = 1 and tp = 2 serving, the TP kernel shapes), and
training (``ssd_bwd``, the Mamba2 families trained on the card, training
on a (data x model) mesh of gloo ranks sharing the card, elastic restore,
the compressed mean, GPipe, decode at data = 2), and the MoE family and
the other dense decoders (``moe_layer`` card vs CPU, the expert-stacked
rotations, qwen3-moe training and serving, gemma-7b, granite-34b and
mistral-large-123b), and the encoder-decoder, the vlm and the encoder
classifier (seamless-m4t-medium trained and served merged, pixtral-12b
served banked and int8 banked and trained, the classifier at
RoBERTa-base's widths under four methods, the new kernel shapes), and
full fine-tuning on a mesh and expert parallelism (gemma-7b's every param
trained and qwen3-moe's experts split over 'model', gloo ranks sharing the
card against one process; qwen3-moe served at tp = 2; a rank's expert
stacks through the GS kernels; the launchers under torchrun).

    python3 tools/lane_phases.py [--only 3h,14,15,16,17,18,19,20] [--seed N] [--out FILE]

Each phase runs through the function ``chip_smoke.main()`` calls for it,
gates, launcher runs and log included (a miss raises), after the kernels
are built; the card's name and power limit are printed first, and the
phases' records go to ``--out`` as JSON. Use it to iterate on these lanes
without the rest of the script (about 10 minutes).
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

PHASES = {
    "3h": lambda gen, seed, dev: {"image_cases": cs.image_kernel_phase(
        cs.get_config("lipconvnet-15"), gen, dev)},
    "14": lambda gen, seed, dev: cs.phase_14(cs.get_config("qwen2-72b"),
                                             seed, dev),
    "15": lambda gen, seed, dev: cs.phase_15(cs.get_config("lipconvnet-15"),
                                             seed, dev),
    "16": lambda gen, seed, dev: {"scale_out": cs.phase_16(
        cs.get_config("qwen2-72b"), seed, dev, gen)},
    "17": lambda gen, seed, dev: {"training": cs.phase_17(
        cs.get_config("qwen2-72b"), cs.get_config("mamba2-130m"),
        cs.get_config("zamba2-2.7b"), seed, dev, gen)},
    "18": lambda gen, seed, dev: {"moe_and_decoders": cs.phase_18(
        seed, dev, gen)},
    "19": lambda gen, seed, dev: {"encdec_vlm_classifier": cs.phase_19(
        seed, dev, gen)},
    "20": lambda gen, seed, dev: {"mesh_ft_and_experts": cs.phase_20(
        seed, dev, gen)},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="3h,14,15")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/lane_phases.json")
    args = ap.parse_args()
    which = args.only.split(",")
    unknown = [w for w in which if w not in PHASES]
    if unknown:
        raise SystemExit(f"lane_phases: unknown phases {unknown}; choose "
                         f"from {list(PHASES)}")
    if not torch.cuda.is_available():
        raise SystemExit("lane_phases: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"build {cs.build.build_all():.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    out = {"card": torch.cuda.get_device_name(0)}
    for name in which:
        t = time.perf_counter()
        out.update(PHASES[name](gen, args.seed, dev))
        cs.log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    cs.log(f"details: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
