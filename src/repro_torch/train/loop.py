"""The training loop (port of ``repro/train/loop.py``): deterministic data
by (seed, step), so a resume replays exactly (the vlm's patches and the
encoder-decoder's frames too: ``LMDataSource``'s ``frontend``); checkpoints
of the trainable tree and the optimizer state (``{"trainable", "opt"}``
with the data cursor as ``extra={"data_step": ...}``, JAX's layout) every
``ckpt_every`` steps and at the end; heartbeat and step-time straggler
detection; and a serving runtime over the merged trained weights at the
end.

On a mesh (``train(mesh=)``, one process per rank): the params are the
rank's shards (``ModelRuntime(..., mesh=)`` draws each weight whole from
the seed and keeps its slice). PEFT trains adapters whole on every rank,
but for the expert stacks', which split with their experts
(``adapters_tree``); full fine-tuning trains the rank's shards of the
params (their specs ``serve_params_tree``'s, as JAX's loop gives the
trainable tree ``params_tree``'s); the optimizer's moments follow the
trainable tree and its step is replicated (``opt_state_tree``). Each step
takes the global batch and keeps the rank's rows
(``build_train_step(cfg, tcfg, mesh)``). A checkpoint gathers every leaf
whole and global rank 0 writes it in JAX's layout; a resume restores it
onto this mesh, whichever mesh saved it. Global rank 0 logs. The returned
runtime serves the merged, trained weights split over the same mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ModelConfig
from repro_torch.core import peft as peft_lib
from repro_torch.core.runtime import ModelRuntime
from repro_torch.data import DataConfig, LMDataSource
from repro_torch.data.synthetic import frontend_shape
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime import Heartbeat, StepTimer
from repro_torch.train.steps import TrainStepConfig, build_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    heartbeat_path: Optional[str] = None
    async_ckpt: bool = True


def train(cfg: ModelConfig, tcfg: TrainStepConfig, dcfg: DataConfig,
          loop: LoopConfig, mesh=None, resume: bool = True,
          log_fn: Callable[[str], None] = print,
          device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Train up to step ``loop.steps`` on ``device`` (default the card; the
    CPU only when asked). With ``loop.ckpt_dir`` set and ``resume``, the
    latest checkpoint there restores the trainable tree and the optimizer
    state and the data replays from its ``data_step``. Returns
    {"trainable", "opt_state", "frozen", "history", "runtime"}, the runtime
    serving the trained weights."""
    dev = resolve_device(device)
    rt0 = ModelRuntime(cfg, seed=dcfg.seed, device=dev, mesh=mesh)
    params = rt0.params
    # adapters are drawn for the WHOLE weights (a split rank holds shards)
    adapters = peft_lib.init_peft(tcfg.peft, rt0.param_shapes, device=dev,
                                  seed=dcfg.seed)
    trainable, frozen = peft_lib.trainable_and_frozen(tcfg.peft, params,
                                                      adapters)
    if not tcfg.peft.is_peft:
        trainable, frozen = params, {}
    ckpt_kw = {}
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.sharding.specs import ShardingRules, place
        rules = ShardingRules(cfg, mesh)
        if tcfg.peft.is_peft:
            # the expert stacks' adapters split with their experts
            t_sh = rules.adapters_tree(trainable)
            trainable = place(mesh, trainable, t_sh)
        else:       # the params' shards, as the runtime placed them
            t_sh = rules.serve_params_tree(rt0.param_shapes)
        if dist.get_rank() != 0:
            log_fn = _quiet
    opt_state = optim.init(tcfg.opt, trainable)
    if mesh is not None:
        ckpt_kw = dict(mesh=mesh, spec_tree={
            "trainable": t_sh, "opt": rules.opt_state_tree(opt_state, t_sh)})
    step_fn = build_train_step(cfg, tcfg, mesh)
    data = LMDataSource(dcfg, frontend=frontend_shape(cfg, dcfg.seq_len))
    start_step = 0
    mgr = None
    if loop.ckpt_dir:
        mgr = CheckpointManager(loop.ckpt_dir)
        if resume and mgr.latest_step() is not None:
            state = mgr.restore({"trainable": trainable, "opt": opt_state},
                                device=dev, **ckpt_kw)
            trainable, opt_state = state["trainable"], state["opt"]
            start_step = mgr.extra().get("data_step", mgr.latest_step())
            log_fn(f"resumed from step {start_step}")

    hb = (Heartbeat(loop.heartbeat_path)
          if loop.heartbeat_path and log_fn is not _quiet else None)
    timer = StepTimer()
    history = []
    for step in range(start_step, loop.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(step).items()}
        timer.start()
        trainable, opt_state, metrics = step_fn(frozen, trainable, opt_state,
                                                batch)
        loss = float(metrics["loss"])            # waits for the step
        t = timer.stop()
        if hb:
            hb.beat(step)
        if step % loop.log_every == 0 or step == loop.steps - 1:
            acc = float(metrics["accuracy"])
            history.append({"step": step, "loss": loss, "accuracy": acc,
                            "step_time_s": t["step_time_s"],
                            "straggler": t["straggler"]})
            line = f"step {step:5d} loss {loss:.4f} acc {acc:.3f} "
            if cfg.is_moe:      # the loss holds MOE_AUX_COEF x this
                history[-1]["moe_aux"] = float(metrics["moe_aux"])
                line += f"moe_aux {history[-1]['moe_aux']:.4f} "
            log_fn(line + f"({t['step_time_s']:.2f}s)")
        if mgr and ((step + 1) % loop.ckpt_every == 0 or
                    step == loop.steps - 1):
            # the leaves reach host memory before save() returns, also when
            # the write itself runs on the async thread
            mgr.save(step + 1, {"trainable": trainable, "opt": opt_state},
                     blocking=not loop.async_ckpt,
                     extra={"data_step": step + 1}, **ckpt_kw)
    if mgr:
        mgr.wait()
    # serving runtime over the TRAINED weights: adapters merged into the
    # frozen base (PEFT) or the trained tree itself (full FT)
    with torch.no_grad():
        if not tcfg.peft.is_peft:
            final_params = trainable
        elif mesh is not None:
            final_params = step_fn.split.materialize(tcfg.peft, frozen,
                                                     trainable)
        else:
            final_params = peft_lib.materialize_tree(tcfg.peft, frozen,
                                                     trainable, merged=True)
    rt_kw = ({} if mesh is None or rt0.shard is None else
             {"_shapes": rt0.param_shapes})
    return {"trainable": trainable, "opt_state": opt_state, "frozen": frozen,
            "history": history,
            "runtime": ModelRuntime(cfg, final_params, device=dev, mesh=mesh,
                                    **rt_kw)}


def _quiet(_msg: str) -> None:
    """The log of every rank but global rank 0."""
