"""AdamW + SGD-momentum, functional (port of ``repro/optim/adamw.py``).

``init`` returns a state tree, ``update`` maps (grads, state, params) ->
(new_params, new_state, metrics), term for term as the JAX package: the
global-norm clip, fp32 moments, the bias correction, and weight decay masked
off 1-D params (norm scales, biases). Trees are nested dicts of tensors.
Under PEFT these states exist only for the adapter params.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"              # adamw | sgd
    learning_rate: float = 1e-3      # peak LR (schedules scale it)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    momentum: float = 0.9            # sgd


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of nested dicts of one structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree):
    """Leaves in sorted-key order (the order of JAX's dict flattening)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.to(torch.float32)))
              for leaf in tree_leaves(tree)]
    return torch.sqrt(sum(leaves) + 1e-30)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def init(cfg: OptimizerConfig, params: Tree) -> Tree:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.kind == "adamw":
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": step}
    if cfg.kind == "sgd":
        return {"mu": tree_map(zeros, params), "step": step}
    raise ValueError(cfg.kind)


def update(cfg: OptimizerConfig, grads: Tree, state: Tree, params: Tree,
           lr_scale=1.0) -> Tuple[Tree, Tree, dict]:
    f32 = torch.float32
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cfg.learning_rate * lr_scale
    decay = lambda p: 1.0 if p.dim() >= 2 else 0.0  # noqa: E731

    if cfg.kind == "adamw":
        mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g,
                      state["mu"], grads)
        nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g,
                      state["nu"], grads)
        s32 = step.to(f32)
        bc1 = 1 - torch.tensor(cfg.b1, dtype=f32, device=s32.device) ** s32
        bc2 = 1 - torch.tensor(cfg.b2, dtype=f32, device=s32.device) ** s32

        def upd(p, m, v):
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            delta = delta + cfg.weight_decay * decay(p) * p.to(f32)
            return (p.to(f32) - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "step": step}, {"grad_norm": gn}

    if cfg.kind == "sgd":
        mu = tree_map(lambda m, g: cfg.momentum * m + g, state["mu"], grads)

        def upd(p, m):
            delta = m + cfg.weight_decay * decay(p) * p.to(f32)
            return (p.to(f32) - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, mu)
        return new_params, {"mu": mu, "step": step}, {"grad_norm": gn}
    raise ValueError(cfg.kind)
