"""The training loop (port of ``repro/train/loop.py``): deterministic data
by (seed, step), so a resume replays exactly; checkpoints of the trainable
tree and the optimizer state (``{"trainable", "opt"}`` with the data cursor
as ``extra={"data_step": ...}``, JAX's layout) every ``ckpt_every`` steps
and at the end; heartbeat and step-time straggler detection; and a serving
runtime over the merged trained weights at the end.
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
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded training is not ported yet (the mesh-training "
            "slice)")
    dev = resolve_device(device)
    params = ModelRuntime(cfg, seed=dcfg.seed, device=dev).params
    adapters = peft_lib.init_peft(tcfg.peft, params, device=dev,
                                  seed=dcfg.seed)
    trainable, frozen = peft_lib.trainable_and_frozen(tcfg.peft, params,
                                                      adapters)
    if not tcfg.peft.is_peft:
        trainable, frozen = params, {}
    opt_state = optim.init(tcfg.opt, trainable)
    step_fn = build_train_step(cfg, tcfg)
    data = LMDataSource(dcfg)
    start_step = 0
    mgr = None
    if loop.ckpt_dir:
        mgr = CheckpointManager(loop.ckpt_dir)
        if resume and mgr.latest_step() is not None:
            state = mgr.restore({"trainable": trainable, "opt": opt_state},
                                device=dev)
            trainable, opt_state = state["trainable"], state["opt"]
            start_step = mgr.extra().get("data_step", mgr.latest_step())
            log_fn(f"resumed from step {start_step}")

    hb = Heartbeat(loop.heartbeat_path) if loop.heartbeat_path else None
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
            log_fn(f"step {step:5d} loss {loss:.4f} acc {acc:.3f} "
                   f"({t['step_time_s']:.2f}s)")
        if mgr and ((step + 1) % loop.ckpt_every == 0 or
                    step == loop.steps - 1):
            # the leaves reach host memory before save() returns, also when
            # the write itself runs on the async thread
            mgr.save(step + 1, {"trainable": trainable, "opt": opt_state},
                     blocking=not loop.async_ckpt,
                     extra={"data_step": step + 1})
    if mgr:
        mgr.wait()
    # serving runtime over the TRAINED weights: adapters merged into the
    # frozen base (PEFT) or the trained tree itself (full FT)
    with torch.no_grad():
        final_params = (peft_lib.materialize_tree(tcfg.peft, frozen, trainable,
                                                  merged=True)
                        if tcfg.peft.is_peft else trainable)
    return {"trainable": trainable, "opt_state": opt_state, "frozen": frozen,
            "history": history,
            "runtime": ModelRuntime(cfg, final_params, device=dev)}
