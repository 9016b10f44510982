"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2-72b --smoke --peft gsoft --steps 3 --device cpu

Same flags as the JAX launcher plus ``--device`` (default ``cuda``: without
a card it raises unless ``--device cpu`` is given). Every ported token
family trains: ``--arch seamless-m4t-medium`` (the batches carry random
frames, max(seq // 4, 8) a row) and ``--arch pixtral-12b`` (random
patches, which take ``frontend_tokens`` of the ``--seq`` positions). ``--ckpt-dir`` saves the
adapters and the optimizer state every ``--ckpt-every`` steps and at the
end, in the JAX package's checkpoint layout, and a later run with the same
directory resumes from the latest one (``--no-resume`` starts over).

``--mesh D,M`` (or ``P,D,M``: pods x data x model) trains on a mesh, one
process per rank started by ``torchrun``:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-72b --smoke --mesh 2,2 --microbatches 2 --device cpu

(gloo on the CPU, NCCL on cards; ``--backend gloo`` lets several ranks
share one card, which NCCL refuses; ``--set seq_parallel=true`` splits
the residual stream on the sequence). ``--peft full`` trains the rank's
shards of the params; an MoE config (``--arch qwen3-moe-30b-a3b``) splits
its experts over 'model'. A world whose size is not the mesh's raises
ValueError naming both; ``--mesh 1,1`` runs in one process.
"""
from __future__ import annotations

import argparse
import os

from repro_torch import optim
from repro_torch.config import get_config, get_smoke_config, parse_overrides
from repro_torch.core import methods as methods_lib
from repro_torch.core import peft as peft_lib
from repro_torch.data import DataConfig
from repro_torch.data.synthetic import text_len
from repro_torch.optim import schedules
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.steps import TrainStepConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--peft", default="gsoft",
                    choices=methods_lib.registered() + ["full"])
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 4,2 for (data, model), or 2,2,2 for (pod, "
                         "data, model); one process per rank (torchrun)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend of --mesh (default: NCCL on "
                         "cards, gloo on the CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.with_overrides(**parse_overrides(args.set))
    import torch.distributed as dist
    started = not dist.is_initialized()
    mesh = (_mesh(args.mesh, args.device, args.backend) if args.mesh
            else None)

    tcfg = TrainStepConfig(
        peft=peft_lib.PEFTConfig(method=args.peft, block_size=args.block_size,
                                 use_pallas=cfg.use_pallas),
        opt=optim.OptimizerConfig(learning_rate=args.lr),
        num_microbatches=args.microbatches,
        schedule=schedules.warmup_cosine(args.warmup, args.steps),
    )
    # the vlm's patches take frontend_tokens of --seq's positions
    dcfg = DataConfig(seq_len=text_len(cfg, args.seq),
                      global_batch=args.batch,
                      seed=args.seed, corpus_path=args.corpus,
                      vocab_size=min(cfg.vocab_size, 256))
    loop = LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir,
                      heartbeat_path=(os.path.join(args.ckpt_dir, "heartbeat")
                                      if args.ckpt_dir else None))
    out = train(cfg, tcfg, dcfg, loop, mesh=mesh, resume=not args.no_resume,
                device=args.device)
    hist = out["history"]
    if hist and (mesh is None or _rank0()):
        print(f"final loss {hist[-1]['loss']:.4f} "
              f"(from {hist[0]['loss']:.4f} @ step {hist[0]['step']})")
    if mesh is not None and started:
        from repro_torch.distrib.tp import close_world
        close_world()
    return 0


def _rank0() -> bool:
    import torch.distributed as dist
    return dist.get_rank() == 0


def _mesh(spec: str, device: str, backend=None):
    """The mesh of ``--mesh D,M`` or ``P,D,M`` over this process group
    (``torchrun``'s, or a world of one), on ``backend`` (default: the
    device's)."""
    from repro_torch.device import resolve_device
    from repro_torch.distrib.tp import default_backend, init_world
    from repro_torch.launch.mesh import make_mesh
    dims = tuple(int(x) for x in spec.split(","))
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh takes D,M or P,D,M (sizes >= 1), not "
                         f"{spec!r}")
    dev = resolve_device(device)
    init_world(backend or default_backend(dev), dev)
    pods, (data, model) = (dims[0], dims[1:]) if len(dims) == 3 else (1, dims)
    return make_mesh(data, model, pods=pods, device_type=dev.type)


if __name__ == "__main__":
    raise SystemExit(main())
